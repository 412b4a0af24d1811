"""engine.memo_hit_share: hits of the ops' derived-stats memo over its
lookups, in %, over the traced part's requests on the engine path (a fresh
``SpMVInputs`` misses every request; a BFS key already searched hits). Read
from the counts the program charged to each request (``repro_torch.trace``);
None for a program without them or where no request looked the memo up."""
import math


def read(run):
    if run.mix["path"] != "engine":
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    lo, hi = run.t_start * 1e9, math.inf if run.trace_end is None else run.trace_end * 1e9
    hits = lookups = 0
    for s in snap["spans"]:
        if s["name"] == "engine.run" and s["t0_ns"] >= lo and s["t1_ns"] <= hi:
            for k, n in snap["requests"].get(s["request"], {}).items():
                if k.startswith("memo."):
                    lookups += n
                    hits += n if k.startswith("memo.hit.") else 0
    return 100.0 * hits / lookups if lookups else None
