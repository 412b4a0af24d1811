"""Where a reduced cell's traced FLOPs differ from the reference's HLO count:
the reference's dots (by op name, shapes and count) beside the port's
traced products (by phase, forward / recompute / backward, and call site
or shapes). ``tests/test_torch_roofline.py`` names the differences this
prints.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_flop_listing.py 4x2:rwkv6-3b:train

Each argument is ``<data>x<model>:<arch>:<kind>`` at the test's batch 8 and
sequence 16. The reference compiles in a subprocess on the forced 8-device
host mesh."""
import json
import os
import subprocess
import sys
import traceback
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, S = 8, 16

REF_SCRIPT = r'''
import json, os, re, sys
from collections import Counter
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from repro.compat import make_mesh
from repro.configs import reduced_config
from repro.configs.shapes import ShapeSpec
from repro.launch import roofline, steps

out = {}
for cell in sys.argv[3:]:
    dims, arch, kind = cell.split(":")
    mesh = make_mesh(tuple(int(v) for v in dims.split("x")), ("data", "model"))
    progs = steps.build_programs(reduced_config(arch), mesh,
                                 ShapeSpec("c", kind, int(sys.argv[2]), int(sys.argv[1])))
    with mesh:
        m = roofline.HloModule(progs.step.lower(*progs.abstract_inputs).compile().as_text())
    rows = Counter()
    for comp, ops in m.comps.items():
        for op in ops:
            if op.kind == "dot" and m.counts.get(comp, 0.0):
                name = re.search(r'op_name="([^"]*)"', op.attrs)
                name = re.sub(r"jit\(\w+\)/|while/body/|closed_call/", "", name.group(1) if name else "?")
                shapes = [m.shape_of.get(o, ("?", ()))[1] for o in op.operands[:2]]
                key = f"{name} {shapes[0]} x {shapes[1]} -> {op.out_types[0][1]} x{m.counts[comp]:g}"
                rows[key] += m.counts[comp] * m._dot_flops(op)
    out[cell] = {"total": m.flops(), "rows": rows}
print("JSON", json.dumps(out))
'''


def reference(cells: list) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(B), str(S), *cells], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(next(line[5:] for line in r.stdout.splitlines() if line.startswith("JSON")))


def port(cell: str) -> dict:
    """The port's traced FLOPs of ``cell``, grouped by where each product
    ran: a forward or recomputed call site in ``models/``, or a backward op
    with its operands' shapes."""
    import torch
    from torch.utils.flop_counter import flop_registry

    from repro_torch.configs import ShapeSpec, reduced_config
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import trace_programs
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import build_programs

    rows = Counter()

    def site(what: str) -> str:
        frames = [f for f in traceback.extract_stack() if "/models/" in f.filename]
        bwd = torch._C._current_graph_task_id() != -1
        if not frames or (bwd and frames[-1].name == "loss_and_grads"):
            return f"backward {what}"
        f = frames[-1]
        return f"{'recompute' if bwd else 'forward'} {f.filename.rsplit('/', 1)[-1]}:{f.name}:{f.lineno}"

    dispatch = roofline.Tracer.__torch_dispatch__
    add_flops = roofline.Tracer.add_flops

    def counting_dispatch(self, func, types, args=(), kwargs=None):
        before = sum(self.flops.values())
        out = dispatch(self, func, types, args, kwargs)
        if func._overloadpacket in flop_registry and sum(self.flops.values()) != before:
            shapes = " x ".join(str(tuple(a.shape)) for a in args if isinstance(a, torch.Tensor))
            rows[site(f"{func._overloadpacket} {shapes}")] += sum(self.flops.values()) - before
        return out

    def counting_add(self, dtype, n):  # the vecdot and flash stand-ins
        add_flops(self, dtype, n)
        rows[site("stand-in") + " (vecdot or flash)"] += n

    dims, arch, kind = cell.split(":")
    shape = ShapeSpec("c", kind, S, B)
    progs = build_programs(reduced_config(arch),
                           MeshShape(tuple(int(v) for v in dims.split("x")), ("data", "model")), shape)
    roofline.Tracer.__torch_dispatch__, roofline.Tracer.add_flops = counting_dispatch, counting_add
    try:
        total = trace_programs(progs, shape)["roofline"]["flops"]
    finally:
        roofline.Tracer.__torch_dispatch__, roofline.Tracer.add_flops = dispatch, add_flops
    return {"total": total, "rows": rows}


def main(cells: list) -> None:
    ref = reference(cells)
    for cell in cells:
        mine = port(cell)
        want, got = ref[cell]["total"], mine["total"]
        print(f"== {cell}: reference {want:.0f}, port {got:.0f}, port - reference {got - want:+.0f} "
              f"({(got - want) / want:+.4%})")
        for label, rows in (("reference", ref[cell]["rows"]), ("port", mine["rows"])):
            print(f"  {label}:")
            for key, n in sorted(rows.items(), key=lambda kv: -kv[1]):
                print(f"    {n:12.0f}  {key}")


if __name__ == "__main__":
    main(sys.argv[1:])
