"""p95_ms: the 95th percentile of the client-side latency of every request
of the window (a failed one counts as infinite)."""
from bench import stats


def read(run):
    return stats.p95_ms(run.samples)
