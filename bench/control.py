#!/usr/bin/env python3
"""Read the control of a configuration's check on the card, at the cell's
own size: the reference put in the program's place, one precision below the
configuration's (SpMV: bfloat16 for float32) or with one stated guarantee
broken (BFS: a round budget one short of the depth). Not part of a run.

    python3 bench/control.py --config bfs-er-s21 --seeds 11 12 13

Prints, a seed a line, every compared number beside its limit; the control
has to fail at least one of them on every seed.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()

    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    entry = {c["name"]: c for c in harness.load_spec()["configs"]}[args.config]
    config = json.loads((ROOT / entry["file"]).read_text())
    limits = config["limits"]
    failed_all = True
    for seed in args.seeds:
        cell = harness.op_cell_class(config["op"])(config, seed, device)
        numbers = cell.check([(tag, cell.control(tag)) for tag in range(cell.tags)])
        fails = any(numbers[k] > limits[k] for k in numbers)
        failed_all &= fails
        print(f"control {args.config} seed {seed}: " + ", ".join(
            f"{k} {v!r} (limit {limits[k]})" for k, v in numbers.items())
            + f"; {'fails' if fails else 'PASSES'} the check", flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    sys.exit(main())
