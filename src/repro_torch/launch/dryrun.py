"""Multi-pod dry-run: trace one rank of every (architecture x input shape x
mesh) cell on the production meshes and derive its memory and roofline
terms, with no process and no card (the JAX package's lowers and compiles
each cell; here rank 0 runs its step on the meta device, see
``launch/roofline.py``).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all            # every cell, subprocess each
    python -m repro_torch.launch.dryrun --all --mesh both

Results are written to experiments/dryrun_torch/<arch>__<shape>__<mesh>.json
and aggregated by ``launch/report.py``. ``--all`` traces as many cells at
once as the host has cores (a few hundred MB of host memory each).

A cell's programs are ``launch/steps.py``'s, built on the production mesh's
:class:`~repro_torch.launch.mesh.MeshShape`; rank 0 holds its weight blocks
(drawn on the meta device), moments, batch rows and decode state as the
rules give them, and runs the step the rank bodies run
(``steps.train_local``, ``prefill_local``, ``decode_local``) on a
:class:`~repro_torch.launch.roofline.RecordingMesh`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def _apply_overrides(cfg, overrides: dict):
    typed = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            typed[k] = v in ("1", "true", "True")
        elif isinstance(cur, int):
            typed[k] = int(v)
        elif isinstance(cur, float):
            typed[k] = float(v)
        else:
            typed[k] = v
    return dataclasses.replace(cfg, **typed)


def _storage_bytes(*objs) -> int:
    """Bytes of the distinct storages of every tensor in ``objs`` (modules,
    dicts, named tuples, dataclasses, tensors)."""
    seen: dict[int, int] = {}

    def walk(o):
        if isinstance(o, torch.Tensor):
            st = o.untyped_storage()
            seen[st._cdata] = st.nbytes()
        elif isinstance(o, torch.nn.Module):
            for p in o.parameters():
                walk(p)
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (tuple, list)):
            for v in o:
                walk(v)
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name))

    for o in objs:
        walk(o)
    return sum(seen.values())


def trace_programs(progs, shape) -> dict:
    """Rank 0 of the cell ``progs`` (built by ``steps.build_programs``
    on a :class:`MeshShape` for ``shape``) traced through its step: the
    memory keys, the roofline report, the collective calls per axis, the
    FLOPs by type and the seconds the trace took."""
    from ..models.layers import Ctx
    from ..models import api
    from ..optim import AdamWConfig
    from . import roofline, steps

    cfg, rules = progs.ctx.cfg, progs.rules
    mesh = roofline.RecordingMesh(progs.mesh)
    ctx = Ctx(cfg, mesh, rules)
    meta = torch.device("meta")
    t0 = time.perf_counter()
    res = {"params": steps._local_model(cfg, mesh, steps._resolved(cfg, rules), 0, meta)}
    if shape.kind == "train":
        opt_cfg = progs.opt_cfg or AdamWConfig()
        local = {n: steps._rows(mesh, rules, t, meta).clone()
                 for n, t in progs.abstract_inputs[2].items()}
        res["opt"] = api.init_opt(cfg, res["params"], opt_cfg)

        def step():
            return steps.train_local(ctx, res, local, opt_cfg, progs.microbatches)
    elif shape.kind == "prefill":
        local = {n: steps._rows(mesh, rules, t, meta).clone()
                 for n, t in progs.abstract_inputs[1].items()}

        def step():
            return steps.prefill_local(ctx, res, local, shape.seq_len)
    else:
        state, spec = progs.abstract_inputs[2], steps._state_specs(cfg, rules)
        res["state"] = type(state)(**{
            n: state.length if n == "length"
            else steps.sh.shard_tensor(mesh, getattr(state, n), getattr(spec, n)).clone()
            for n in state._fields})
        res["state_spec"] = spec
        local = steps._rows(mesh, rules, progs.abstract_inputs[1], meta).clone()

        def step():
            return steps.decode_local(ctx, res, local)
    args = _storage_bytes(res, local)
    mesh.reset_counts()
    out, tr = roofline.trace(step)
    del out
    seconds = time.perf_counter() - t0
    report = roofline.analyze(tr, mesh)
    out_bytes = tr.end_bytes + tr.alias_bytes
    temp = tr.temp_peak_bytes - tr.end_bytes
    return {
        "memory": {
            "argument_bytes_per_dev": args,
            "output_bytes_per_dev": out_bytes,
            "temp_bytes_per_dev": temp,
            "alias_bytes_per_dev": tr.alias_bytes,
            "peak_bytes_per_dev": args + out_bytes + temp - tr.alias_bytes,
        },
        "roofline": report.to_dict(),
        "flops_by_dtype": tr.flops,
        "collective_calls": {a: c["calls"] for a, c in mesh.counts().items()},
        "seconds_trace": seconds,
    }


def trace_cell(cfg, sizes: tuple, axes: tuple, shape, microbatches: "int | None" = None) -> dict:
    """:func:`trace_programs` of ``cfg``'s cell ``shape`` on a mesh of
    ``sizes`` over ``axes`` (a description: no processes), rank 0; a train
    cell's ``microbatches`` as given, else ``steps.MICROBATCHES``'. A
    module-level function, so that a process pool can run cells at once."""
    from .mesh import MeshShape
    from .steps import build_programs

    kw = {"microbatches": microbatches} if microbatches and shape.kind == "train" else {}
    progs = build_programs(cfg, MeshShape(tuple(sizes), tuple(axes)), shape, **kw)
    return trace_programs(progs, shape)


def run_cell(arch: str, shape_name: str, mesh_kind: str, overrides: dict | None = None) -> dict:
    from ..configs import SHAPES, applicable, get_config
    from . import roofline
    from .mesh import make_production_mesh

    cfg = get_config(arch)
    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    cell = trace_cell(cfg, mesh.sizes, mesh.axis_names, shape)
    n_chips = mesh.size
    mf = roofline.model_flops(cfg, shape.kind, shape.seq_len, shape.global_batch)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "ok",
        "n_chips": n_chips,
        "seconds_trace": round(cell["seconds_trace"], 2),
        "memory": cell["memory"],
        "roofline": cell["roofline"],
        "flops_by_dtype": cell["flops_by_dtype"],
        "collective_calls": cell["collective_calls"],
        "model_flops_global": mf,
        "model_flops_per_dev": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips) / max(cell["roofline"]["flops"], 1.0),
    }


def _run_subprocess(arch: str, shape: str, mk: str) -> tuple:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--mesh", mk]
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True)
    return r, time.time() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field override key=value (perf hillclimbing)")
    ap.add_argument("--tag", default=None, help="suffix for the output json")
    args = ap.parse_args()
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    if args.all:
        from ..configs import ARCHS, SHAPES

        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        todo = []
        for arch in ARCHS:
            for shape in SHAPES:
                for mk in meshes:
                    out = OUT_DIR / f"{arch}__{shape}__{mk}.json"
                    if out.exists() and not args.force:
                        print(f"cached   {out.name}")
                        continue
                    out.unlink(missing_ok=True)
                    todo.append((arch, shape, mk))
        failures = []
        with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
            for (arch, shape, mk), (r, dt) in zip(
                    todo, pool.map(lambda c: _run_subprocess(*c), todo)):
                out = OUT_DIR / f"{arch}__{shape}__{mk}.json"
                if r.returncode == 0 and out.exists():
                    status = json.loads(out.read_text()).get("status")
                    print(f"{status:8s} {out.name} ({dt:.0f}s)", flush=True)
                else:
                    failures.append((arch, shape, mk))
                    print(f"FAILED   {out.name} ({dt:.0f}s)")
                    print(r.stdout[-2000:])
                    print(r.stderr[-4000:], flush=True)
        if failures:
            print(f"\n{len(failures)} cell(s) failed: {failures}")
            sys.exit(1)
        print("\nAll dry-run cells passed.")
        return

    assert args.arch and args.shape, "--arch and --shape required (or --all)"
    overrides = dict(kv.split("=", 1) for kv in args.override)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for mk in meshes:
        tag = f"__{args.tag}" if args.tag else ""
        out = OUT_DIR / f"{args.arch}__{args.shape}__{mk}{tag}.json"
        try:
            result = run_cell(args.arch, args.shape, mk, overrides)
        except Exception:
            traceback.print_exc()
            sys.exit(1)
        out.write_text(json.dumps(result, indent=2, default=float))
        print(f"wrote {out}")
        if result["status"] == "ok":
            r = result["roofline"]
            print(
                f"  terms: compute={r['t_compute']:.3e}s memory={r['t_memory']:.3e}s "
                f"collective={r['t_collective']:.3e}s dominant={r['dominant']}"
            )


if __name__ == "__main__":
    main()
