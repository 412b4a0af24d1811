"""service.wait_ms: median over requests of the latency from when a request
was due to its future's result, less its ``RunReport.seconds``: the serving
plane's queueing, scheduling and hand-off."""
from bench import stats


def read(run):
    if run.mix["path"] != "service":
        return None
    return stats.host_overhead_ms(run.samples)
