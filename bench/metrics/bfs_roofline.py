"""bfs_roofline: the searches' bound time (each adjacency entry of a reached
vertex read once as an int32 and the parents written once, at the card's
peak bandwidth) as a share of the device time of all their kernels."""
from bench.harness import roofline_percent


def read(run):
    return roofline_percent(run, "bfs")
