#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card of the machine it starts on.

    python3 bench/run.py --workload spmv-lap2d-4096.seq --seed 7 --seconds 10 --trace 0

Prints the card, the set-up's parts, the requests and the check on earlier
lines, then one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer ones with ``--trace 1``), ``device`` (with the
trace's ``busy_s`` and ``window_s``), with ``--trace 1`` a ``breakdown``, and
last ``checks``: each compared number beside its limit, also printed as the
last lines of standard error.

Exits non-zero with no result line when there is no card, when the cell asks
for more cards than there are, or when JAX or the JAX package was loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def use_checkout_paths() -> None:
    """The checkout's root, not bench/, leads the path (the harness is the
    package ``bench``), then the program's ``src``."""
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it ("unknown" without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench import harness

    spec = harness.load_spec()
    cell_entry, _, config, mix = harness.find_cell(spec, args.workload)
    chips = int(cell_entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {args.workload} needs {chips} CUDA card(s), found {n}; nothing runs on the CPU",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, {torch.cuda.device_count()} visible, {chips} used, power limit "
          f"{power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    run, numbers, lines, peak = harness.run_cell(config, mix, args.seed, args.seconds,
                                                 bool(args.trace), device, T_PROCESS)
    for line in lines:
        print(line)
    print(f"memory: peak {peak} bytes allocated on the card")
    if args.trace:  # the traced run is the slow one anyway
        print(f"baseline: plain reference, one request, one host thread: {run.cell.baseline_ms():.3f} ms")

    metrics = {}
    for m in harness.metrics_of(spec, args.workload, bool(args.trace)):
        value = harness.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = config["limits"]
    correct = harness.limits_met(numbers, limits)
    device_info = {"platform": "gpu", "kind": name, "count": chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(run.samples),
              "failed": int(numbers["failed_requests"]), "metrics": metrics, "device": device_info}
    if args.trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops, "idle_gaps": run.trace.idle_gaps}
        print(f"trace: busy {run.trace.busy_s} s of {run.trace.window_s} s, "
              f"{run.trace.n_device_ops} device ops, {run.trace.device_op_s} s of device op time")
    elif args.trace:
        print("trace: the profiler recorded no device operation", file=sys.stderr)

    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"error: the run loaded {loaded}; the benchmark must not import JAX or the JAX package",
              file=sys.stderr)
        return 3
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}
    checks["checked_results"] = {"value": numbers["checked_results"], "limit": 1, "at_least": True}
    result["checks"] = checks
    for k, c in checks.items():
        rel = ">=" if c.get("at_least") else "<="
        print(f"check {k}: {c['value']} (limit {rel} {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    use_checkout_paths()
    sys.exit(main())
