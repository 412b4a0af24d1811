"""useful_gbps: the paper's useful bytes (SpMV §5.1, BFS §5.2) of every
request the window completed, over the window's seconds."""
from bench import stats


def read(run):
    return stats.useful_gbps(run.samples, run.t_start, run.bytes_of)
