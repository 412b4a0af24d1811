"""engine.host_ms: median over requests of the ``engine.run`` call's wall
time less its ``RunReport.seconds``: plan build, plan-cache lookup, the op's
traffic and byte models and the report, around the timed call."""
from bench import stats


def read(run):
    if run.mix["path"] != "engine":
        return None
    return stats.host_overhead_ms(run.samples)
