"""engine.account_ms: median over the traced part's requests on the engine
path of their ``engine.account`` span: the op's traffic and byte models, its
metrics and the report, after the timed call (SpMV's non-zero count and its
host sync, BFS's reached count). Read from the program's span store
(``repro_torch.trace``); None for a program without one."""
import math

from bench import stats


def read(run):
    if run.mix["path"] != "engine":
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    spans = trace.snapshot()["spans"]
    lo, hi = run.t_start * 1e9, math.inf if run.trace_end is None else run.trace_end * 1e9
    ns = {s["request"]: 0 for s in spans
          if s["name"] == "engine.run" and s["t0_ns"] >= lo and s["t1_ns"] <= hi}
    for s in spans:
        if s["name"] == "engine.account" and s["request"] in ns:
            ns[s["request"]] += s["t1_ns"] - s["t0_ns"]
    return stats.percentile([v / 1e6 for v in ns.values()], 50.0) if ns else None
