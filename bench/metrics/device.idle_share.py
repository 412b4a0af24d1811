"""device.idle_share: the share of the traced window in which no operation
ran on the card (the union of the profiler's device intervals)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
