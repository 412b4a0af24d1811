#!/usr/bin/env python3
"""Find the highest rate the serving plane sustains for one configuration:
the load sweep that fixed the rate of each open-loop mix. Not part of a run.

    python3 bench/sweep.py --config spmv-lap2d-4096 --workers 4 --seconds 4 \
        --shares 0.6 0.7 0.8 0.9 1.0 1.1

One process: the inputs, a warm ``EngineService``, then a closed loop of
``--clients`` callers for the saturated rate C, then open-loop arrivals at
each share of C; a line a step with the completed rate, the latency
percentiles and how late the generator ran.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--shares", type=float, nargs="+", default=[0.6, 0.7, 0.8, 0.9, 1.0, 1.1])
    args = ap.parse_args()

    import torch

    from bench import harness, stats
    from repro_torch.engine import CudaSubstrate, EngineService

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = harness.load_spec()
    entry = {c["name"]: c for c in spec["configs"]}[args.config]
    config = json.loads((ROOT / entry["file"]).read_text())
    harness.build_kernels(config, device)
    cell = harness.op_cell_class(config["op"])(config, args.seed, device)
    cell.substrate = CudaSubstrate(device)
    svc = EngineService(substrate=cell.substrate, workers=args.workers, device=device).start()
    window = harness.Tracer(False, device)
    try:
        def call(req):
            resp = svc.submit(req).result(timeout=harness.REQUEST_TIMEOUT_S)
            return resp.result, resp.report

        harness._warm(cell, call, args.clients)
        samples, t0, _, _ = harness._closed_loop(cell, call, args.clients, args.seconds, args.seed, window)
        cap = len(samples) / stats.window_seconds(samples, t0)
        print(f"sweep {args.config} closed {args.clients} clients: {cap:.1f} req/s, "
              f"p50 {stats.median_ms(samples):.3f} ms, p95 {stats.p95_ms(samples):.3f} ms", flush=True)
        for share in args.shares:
            rate = share * cap
            samples, t0, _, late = harness._open_loop(cell, svc, rate, args.lanes, args.seconds,
                                                      args.seed, window)
            lat = sorted(s.latency_s * 1e3 for s in samples)
            ordered = sorted(samples, key=lambda s: s.t0)
            half = len(ordered) // 2
            first = stats.percentile([s.latency_s for s in ordered[:half]], 50.0) * 1e3
            second = stats.percentile([s.latency_s for s in ordered[half:]], 50.0) * 1e3
            done = len(samples) / stats.window_seconds(samples, t0)
            print(f"sweep {args.config} open {share:.2f} x C = {rate:.1f} req/s: completed "
                  f"{done:.1f} req/s, p50 {stats.percentile(lat, 50):.3f} p95 {stats.percentile(lat, 95):.3f} "
                  f"p99 {stats.percentile(lat, 99):.3f} max {lat[-1]:.3f} ms, p50 first half {first:.3f}, second half {second:.3f} ms, "
                  f"generator p99 late {late:.3f} ms", flush=True)
            time.sleep(0.5)
    finally:
        svc.stop()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    sys.exit(main())
