"""engine.syncs_per_request: mean over the traced part's requests on the
engine path of the ``sync.*`` counts the program charged to each: the places
where the host waits for the card (the runner's stream synchronize, SpMV's
non-zero count; BFS's two stores of the root, its frontier test a round, its
reached count and, on a memo miss, the traffic replay's copy of the graph).
Read from the program's span store (``repro_torch.trace``); None for a
program without one."""
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
    rids = [s["request"] for s in snap["spans"]
            if s["name"] == "engine.run" and s["t0_ns"] >= lo and s["t1_ns"] <= hi]
    if not rids:
        return None
    counts = snap["requests"]
    syncs = [sum(n for k, n in counts.get(r, {}).items() if k.startswith("sync.")) for r in rids]
    return sum(syncs) / len(syncs)
