"""engine.plan_ms: median over the traced part's requests on the engine
path of their ``engine.plan`` + ``engine.lookup`` spans: plan build (op and
strategy resolution, input checks, the plan key) and the plan-cache lookup.
Read from the program's span store (``repro_torch.trace``); None for a
program without one."""
import math

from bench import stats

PARTS = ("engine.plan", "engine.lookup")


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
        if s["name"] in PARTS and s["request"] in ns:
            ns[s["request"]] += s["t1_ns"] - s["t0_ns"]
    return stats.percentile([v / 1e6 for v in ns.values()], 50.0) if ns else None
