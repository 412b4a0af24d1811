"""Aggregate the port's dry-run JSONs into roofline tables.

    PYTHONPATH=src python -m repro_torch.launch.report [--mesh single]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def load(mesh: str) -> list[dict]:
    rows = []
    for p in sorted(OUT_DIR.glob(f"*__{mesh}.json")):
        rows.append(json.loads(p.read_text()))
    return rows


def fmt_bytes(b: float) -> str:
    if b >= 1e9:
        return f"{b / 1e9:.2f}GB"
    if b >= 1e6:
        return f"{b / 1e6:.1f}MB"
    return f"{b / 1e3:.0f}KB"


def roofline_table(mesh: str = "single") -> str:
    rows = load(mesh)
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "traced flops/dev | MODEL/traced | peak HBM/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | *skipped* "
                f"({r['reason'][:40]}…) | — | — | — |"
            )
            continue
        rf = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rf['t_compute']:.2e} | "
            f"{rf['t_memory']:.2e} | {rf['t_collective']:.2e} | "
            f"**{rf['dominant']}** | {rf['flops']:.2e} | "
            f"{r['useful_flops_ratio']:.2f} | "
            f"{fmt_bytes(r['memory']['peak_bytes_per_dev'])} |"
        )
    return "\n".join(lines)


def dryrun_table(mesh: str) -> str:
    rows = load(mesh)
    lines = [
        "| arch | shape | status | trace s | calls data/model | args/dev | temp/dev | "
        "top collective |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | skipped | — | — | — | — | — |")
            continue
        colls = r["roofline"]["collectives"]
        top = (
            f"{colls[0]['kind']}×{colls[0]['count']} ({fmt_bytes(colls[0]['wire_bytes'])})"
            if colls else "none"
        )
        calls = r["collective_calls"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['seconds_trace']} | "
            f"{calls.get('data', 0)}/{calls.get('model', 0)} | "
            f"{fmt_bytes(r['memory']['argument_bytes_per_dev'])} | "
            f"{fmt_bytes(r['memory']['temp_bytes_per_dev'])} | {top} |"
        )
    return "\n".join(lines)


def cell_table() -> str:
    """One row an arch, one column a shape: the dominant term, the
    useful-FLOPs ratio and the peak a device, single pod / two pods."""
    cells = {(r["arch"], r["shape"], m): r for m in ("single", "multi") for r in load(m)}
    archs = sorted({a for a, _, _ in cells})
    shapes = sorted({s for _, s, _ in cells})
    lines = ["| arch | " + " | ".join(shapes) + " |", "|---|" + "---|" * len(shapes)]

    def one(r):
        if r is None:
            return "—"
        if r["status"] == "skipped":
            return "skipped"
        return (f"{r['roofline']['dominant'][:3]} {r['useful_flops_ratio']:.2f} "
                f"{r['memory']['peak_bytes_per_dev'] / 1e9:.2f}")

    for a in archs:
        row = [f"{one(cells.get((a, s, 'single')))} / {one(cells.get((a, s, 'multi')))}"
               for s in shapes]
        lines.append(f"| {a} | " + " | ".join(row) + " |")
    return "\n".join(lines)


def pick_hillclimb_cells() -> list[dict]:
    """The three most interesting cells: worst useful-flops ratio, most
    collective-bound, most representative of the paper's technique (MoE EP
    dispatch = S2)."""
    rows = [r for r in load("single") if r["status"] == "ok"]
    worst_ratio = min(rows, key=lambda r: r["useful_flops_ratio"])
    most_coll = max(
        rows,
        key=lambda r: r["roofline"]["t_collective"]
        / max(max(r["roofline"]["t_compute"], r["roofline"]["t_memory"]), 1e-12),
    )
    moe = [r for r in rows if "moonshot" in r["arch"] and r["shape"] == "train_4k"]
    return [worst_ratio, most_coll] + moe[:1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    print("## Roofline —", args.mesh)
    print(roofline_table(args.mesh))
    print()
    print("## Dry-run —", args.mesh)
    print(dryrun_table(args.mesh))
    print()
    print("## Every cell: dominant term, MODEL/traced FLOPs, peak GB a device (single / multi)")
    print(cell_table())
    print()
    print("## Hillclimb candidates")
    for r in pick_hillclimb_cells():
        print(
            f"- {r['arch']} x {r['shape']}: dominant={r['roofline']['dominant']} "
            f"ratio={r['useful_flops_ratio']:.2f}"
        )


if __name__ == "__main__":
    main()
