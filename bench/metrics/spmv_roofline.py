"""spmv_roofline: the SpMV requests' bound time (paper §5.1 bytes at the
card's peak bandwidth) as a share of the device time of all their kernels."""
from bench.harness import roofline_percent


def read(run):
    return roofline_percent(run, "spmv")
