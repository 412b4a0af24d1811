#!/usr/bin/env python3
"""Serve the main path's mixed stream through ``EngineService`` on one CUDA
card at pool widths 1, 2 and 4, in three configurations, to choose how many
executor slots a card takes and whether a slot owns a CUDA stream.

    python3 tools/serving_sweep.py [--requests 96] [--reps 2]

Builds the kernels and ``chip_smoke.py``'s main-path inputs, warms one plan
cache with every signature (so no first call falls inside a measured
window), then serves ``--requests`` requests rotating over the six
main-path signatures as one burst (every request admitted at once: the
pool's capacity, not the arrival rate, bounds the window) for each
configuration:

- ``streams``: the service as shipped, each worker on a stream of its own;
- ``default-stream``: every worker launching on the default stream (the
  service's stream switch removed), so the card runs one request's kernels
  at a time and a call's synchronize waits for the other workers' kernels;
- ``streams-switch-0.5ms``: as ``streams``, with the interpreter's thread
  switch interval cut from 5 ms to 0.5 ms for the run.

Widths run in the order 1 2 4 4 2 1 (``--reps`` rounds). Every served
result is held ``torch.equal`` to ``engine.run``. Prints the card's name and
power limit, then one ``sweep {...}`` JSON line per run: requests/s, total
latency p50/p99, median ``RunReport.seconds`` per op, per-worker occupancy
and steals. Last, one burst at each width under ``torch.profiler`` (own
streams): a ``profile {...}`` line with the card's busy time (the union of
every kernel's interval, over all streams) against the profiled window;
the profiler slows the host, so the idle share is an upper bound.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ("streams", "default-stream", "streams-switch-0.5ms")


def serve_once(svc_cls, sub, sigs, want, order, workers, cache) -> dict:
    from repro_torch.engine import Request

    svc = svc_cls(cache=cache, substrate=sub, device=sub.device, workers=workers,
                  qos={"bfs": 2.0}, batch_window=0.02).start()
    try:
        futures = [(i, svc.submit(Request(*sigs[i]))) for i in order]
        responses = [(i, f.result(timeout=600)) for i, f in futures]
    finally:
        svc.stop(timeout=600)
    by_op: dict[str, list[float]] = {}
    for i, resp in responses:
        got, ref = resp.result, want[i]
        same = (all(torch.equal(g, w) for g, w in zip(got, ref)) if isinstance(ref, tuple)
                else torch.equal(got, ref))
        if not same:
            raise SystemExit(f"W={workers}: request {resp.ticket} differs from engine.run")
        by_op.setdefault(resp.report.op, []).append(resp.report.seconds * 1e3)
    stats = svc.stats()
    return {
        "workers": workers, "requests": stats.requests,
        "requests_per_second": stats.requests_per_second, "wall_ms": stats.wall_seconds * 1e3,
        "total_p50_ms": stats.total_p50 * 1e3, "total_p99_ms": stats.total_p99 * 1e3,
        "seconds_p50_ms": {op: float(np.median(v)) for op, v in by_op.items()},
        "worker_occupancy": stats.worker_occupancy, "steals": stats.steals,
        "cache_hits": stats.cache_hits, "compiles": stats.compiles,
    }


def device_busy_ms(prof) -> tuple[float, int]:
    """(ms the card ran at least one kernel, kernel count) in a profile:
    the union of the kernels' intervals over every stream."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type.name == "CUDA" and e.time_range.end > e.time_range.start)
    busy, cur = 0.0, None
    for t0, t1 in spans:
        if cur is None or t0 > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [t0, t1]
        else:
            cur[1] = max(cur[1], t1)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    return busy / 1e3, len(spans)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serving_sweep: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.engine import CudaSubstrate, EngineService, PlanCache, Request, run
    from repro_torch.kernels import build

    print(chip_smoke.card_line(), flush=True)
    build.build()
    dev = torch.device("cuda", 0)
    inputs = chip_smoke.make_inputs(dev)
    sub = CudaSubstrate(dev)
    sigs = chip_smoke.serve_signatures(inputs)
    cache = PlanCache()
    want = [run(Request(op, inp, st, sub), iters=1, warmup=0, cache=cache)[0]
            for op, inp, st in sigs]
    order = [i % len(sigs) for i in range(args.requests)]

    class DefaultStreamService(EngineService):
        """Every channel on the caller's stream: the default stream."""

        @contextlib.contextmanager
        def _on_channel(self, sub, channel):
            with torch.cuda.device(sub.device):
                yield None

    widths = [1, 2, 4, 4, 2, 1] * args.reps
    for config in CONFIGS:
        svc_cls = DefaultStreamService if config == "default-stream" else EngineService
        interval = sys.getswitchinterval()
        if config == "streams-switch-0.5ms":
            sys.setswitchinterval(5e-4)
        try:
            serve_once(svc_cls, sub, sigs, want, order[: len(sigs)], 2, cache)  # warm threads
            for workers in widths:
                row = serve_once(svc_cls, sub, sigs, want, order, workers, cache)
                print("sweep " + json.dumps({"config": config, **row}), flush=True)
                time.sleep(0.05)
        finally:
            sys.setswitchinterval(interval)
    from torch.profiler import ProfilerActivity, profile

    for workers in (1, 2, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            row = serve_once(EngineService, sub, sigs, want, order, workers, cache)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, n_kernels = device_busy_ms(prof)
        print("profile " + json.dumps({
            "workers": workers, "window_ms": window_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / window_ms, "kernels": n_kernels,
            "requests_per_second": row["requests_per_second"],
            "seconds_p50_ms": row["seconds_p50_ms"]}), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
