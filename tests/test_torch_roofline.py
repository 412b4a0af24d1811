"""The dry-run's byte source (``launch/roofline.py``) against the JAX
package's HLO roofline: ``model_flops`` formula for formula, the ring costs
of each collective kind, FLOPs split by type, the peak-live tracker, the
flash stand-in, and the traced FLOPs of reduced float32 cells against the
HLO count of the reference's own sharded programs on the forced 8-device
host mesh (one subprocess for every cell).

Named differences: the FLOPs the port's trace counts over the HLO's count,
held exactly for each cell of ``FLOP_CELLS``; ``tests/torch_flop_listing.py``
lists both sides op by op.

- prefill: zamba2 on (2, 4) +98,304 (+0.38 %): Mamba-2's C.B scores
  contract the whole state dim (16) on every ``model`` rank, where GSPMD
  contracts a rank's 4 and all-reduces the scores. The port keeps the local
  product: on the production cells that all-reduce costs more than the
  FLOPs it saves (the dry-run's three terms, PERF.md). Every other prefill
  cell is equal. rwkv6's time mix runs over ``ceil(H / model)`` whole
  heads, padded where ``model`` does not divide them (on (2, 4) one of its
  2 heads a rank), and its decay LoRA's down-projection over a rank's block
  of the rows, as GSPMD splits them; its bonus (r * u) . k is a ``torch.linalg.vecdot``, which the
  trace counts as the HLO counts the dot.
- train, rwkv6 on (4, 2) +114,688 (+0.26 %): +131,072, the checkpoint of a
  scan chunk recomputes A v (one (c x c) by (c x M) product a layer), which
  XLA's rematerialization drops as unused; -16,384, two backward reductions
  that XLA writes as dots and the port as elementwise ops: the bonus's
  ``bht,bthm->bthm`` (8,192) and the grad of u over the rank's rows,
  (64, 32) by (64, 32) (8,192).
- train, rwkv6 on (2, 4) +368,640 (+0.78 %): +262,144, the same recompute;
  +131,072, the split: GSPMD runs the backward's dA of A v
  (``bhti,bihm->bthm``) over a quarter of the positions of both heads,
  (4, 2, 4, 64) by (4, 2, 64, 16), where the port runs it over all the
  positions of its block of one padded head, (4, 16, 64) by (4, 64, 16);
  -24,576, the bonus's ``bht,bthm->bthm`` (8,192) and the grad of u,
  (64, 64) by (64, 64) (16,384).
- train, zamba2 on (2, 4) +876,544 (+1.04 %): +393,216, the scores over
  the whole state dim (forward, recompute and two grads: 524,288 against
  the HLO's 131,072); +483,328 over 8 Mamba-2 layers, the scan's other
  products: the port runs 8 products of 65,536 FLOPs a layer (y = w x:
  forward, recompute, two grads; C h0 at the zero start state: forward,
  recompute, grad; the state update: forward), the HLO 7 (the state
  update's ``bin,bih,bihp->bhnp`` among them, twice) and two dots of
  backward reductions (4,096 and 1,024 a layer).
- decode (no cell here): rwkv6 on (4, 2) +16,384 (+1.9 %), one token's
  LoRA down-projection on every row, where GSPMD splits the rows (the
  gather would cost more than the product); on (2, 4) +81,920 (+9.6 %),
  that LoRA (+49,152) and the recurrence over a whole padded head a rank,
  where GSPMD splits it at half a head on the key dim (+32,768); zamba2 on
  (2, 4) +2.1 %, where XLA turns the one-token contractions of size 1 into
  products."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get_config, reduced_config
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import trace_programs
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.steps import build_programs
from repro_torch.machine.machine import BF16_TENSOR_FLOPS, default_machine

ROOT = Path(__file__).resolve().parents[1]
B, S = 8, 16
# (mesh, arch, kind) cells held against the HLO count, and the FLOPs the
# port counts over it, exactly (module docstring)
FLOP_CELLS = [
    ((2, 4), "llama3.2-3b", "prefill", 0), ((2, 4), "llama3.2-3b", "train", 0),
    ((2, 4), "moonshot-v1-16b-a3b", "prefill", 0), ((2, 4), "moonshot-v1-16b-a3b", "train", 0),
    ((2, 4), "whisper-small", "prefill", 0), ((2, 4), "whisper-small", "train", 0),
    ((2, 4), "phi-3-vision-4.2b", "prefill", 0), ((2, 4), "phi-3-vision-4.2b", "train", 0),
    ((2, 4), "zamba2-2.7b", "prefill", 98_304), ((2, 4), "zamba2-2.7b", "train", 876_544),
    ((4, 2), "rwkv6-3b", "prefill", 0), ((4, 2), "rwkv6-3b", "train", 114_688),
    ((2, 4), "rwkv6-3b", "prefill", 0), ((2, 4), "rwkv6-3b", "train", 368_640),
]

REF_SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
from repro.compat import make_mesh
from repro.configs import reduced_config
from repro.configs.shapes import ShapeSpec
from repro.launch import roofline, steps

B, S = 8, 16
for cell in sys.argv[1:]:
    dims, arch, kind = cell.split(":")
    mesh = make_mesh(tuple(int(v) for v in dims.split("x")), ("data", "model"))
    progs = steps.build_programs(reduced_config(arch), mesh, ShapeSpec("c", kind, S, B))
    with mesh:
        compiled = progs.step.lower(*progs.abstract_inputs).compile()
    print("FLOPS", cell, roofline.analyze(compiled.as_text()).flops, flush=True)
'''


def test_model_flops_equals_the_reference_for_every_cell():
    from repro.configs import get_config as ref_config
    from repro.launch.roofline import model_flops as ref_model_flops

    for arch in ARCHS:
        for shape in SHAPES.values():
            args = (shape.kind, shape.seq_len, shape.global_batch)
            assert roofline.model_flops(get_config(arch), *args) == \
                ref_model_flops(ref_config(arch), *args), (arch, shape.name)


def test_collective_ring_costs_equal_the_reference():
    """Each kind on a group of 4 over a 1024-float operand costs what the
    reference's HLO parser gives the same collective (its synthetic
    module)."""
    from repro.launch.roofline import HloModule

    txt = """
HloModule test

ENTRY %main (p0: f32[1024]) -> f32[1024] {
  %p0 = f32[1024]{0} parameter(0)
  %ag = f32[4096]{0} all-gather(%p0), replica_groups=[2,4]<=[8], dimensions={0}
  %ar = f32[1024]{0} all-reduce(%p0), replica_groups=[2,4]<=[8], to_apply=%add
  %rs = f32[256]{0} reduce-scatter(%p0), replica_groups=[2,4]<=[8], to_apply=%add
  %a2a = f32[1024]{0} all-to-all(%p0), replica_groups=[2,4]<=[8]
  ROOT %out = f32[1024]{0} add(%ar, %p0)
}
"""
    want = {r.kind: r for r in HloModule(txt).collectives()}
    mesh = roofline.RecordingMesh(MeshShape((2, 4), ("data", "model")))
    group = mesh.group("model")
    x = torch.empty(1024, device="meta")
    assert group.all_gather(x).shape == (4096,)
    assert group.reduce_scatter(x).shape == (256,)
    assert group.all_reduce(x).shape == group.all_to_all(x).shape == (1024,)
    got = {r.kind: r for r in mesh.collective_records()}
    assert set(got) == set(want)
    for kind, r in want.items():
        assert (got[kind].bytes_in, got[kind].group_size, got[kind].count) == \
            (r.bytes_in, r.group_size, r.count), kind
        assert got[kind].wire_bytes == pytest.approx(r.wire_bytes, rel=1e-12), kind
    assert mesh.counts()["model"]["calls"] == 4 and mesh.counts()["data"]["calls"] == 0


def test_matmul_flops_are_exact_and_split_by_type():
    a16, b16 = (torch.empty(s, dtype=torch.bfloat16, device="meta") for s in ((32, 64), (64, 48)))
    a32, b32 = (torch.empty(s, device="meta") for s in ((8, 16), (16, 4)))

    def step():
        return (a16 @ b16).float().sum() + (a32 @ b32).sum()

    _, tr = roofline.trace(step)
    assert tr.flops == {"bfloat16": 2 * 32 * 48 * 64, "float32": 2 * 8 * 4 * 16}
    rep = roofline.analyze(tr)
    peaks = default_machine().peaks
    assert rep.flops == 2 * 32 * 48 * 64 + 2 * 8 * 4 * 16
    assert rep.t_compute == pytest.approx(2 * 32 * 48 * 64 / BF16_TENSOR_FLOPS
                                          + 2 * 8 * 4 * 16 / peaks.flops, rel=1e-12)
    assert rep.t_memory == pytest.approx(rep.bytes_hbm / peaks.hbm_bw)
    assert rep.bytes_collective == 0 and rep.dominant in ("compute", "memory")


def test_peak_live_tracker_is_exact():
    """Allocate 1 MiB and 2 MiB, free the first, allocate 512 KiB, write a
    block that existed before in place, take views: peak 3 MiB, 2.5 MiB
    alive at the end, the written block an alias, views and in-place
    writes nothing new."""
    MiB = 1 << 20
    before = torch.zeros(1024, device="meta")  # 4 KiB, made before the trace
    box = {}

    def step():
        a = torch.empty(MiB // 4, device="meta")
        box["b"] = torch.zeros(2 * MiB // 4, device="meta")
        box["b"].view(2, -1)[0].add_(1.0)
        del a
        box["c"] = torch.ones(MiB // 8, device="meta")
        before[:10].copy_(box["c"][:10])
        return box["b"][:5]

    _, tr = roofline.trace(step)
    assert tr.temp_peak_bytes == 3 * MiB
    assert tr.end_bytes == 2 * MiB + MiB // 2
    assert tr.alias_bytes == 4096


def test_flash_calls_count_their_pairs():
    """Under a trace the flash kernel's calls return q's shape and count 4 D
    FLOPs a visible pair a head (causal aligned to the kv tail, window)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    q = torch.empty(2, 4, 6, 32, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 2, 10, 32, dtype=torch.bfloat16, device="meta")
    out, tr = roofline.trace(lambda: flash_attention(q, k, k, causal=True, window=3))
    assert out.shape == q.shape
    pairs = sum(1 for i in range(6) for j in range(10) if j <= i + 4 and i + 4 - j < 3)
    assert roofline.flash_pairs(6, 10, True, 3) == pairs
    assert roofline.flash_pairs(6, 10, False, None) == 60
    assert tr.flops == {"bfloat16": 4 * 32 * 8 * pairs}


def test_vecdot_calls_count_their_products():
    """``torch.linalg.vecdot`` counts 2 FLOPs a multiply-add by its
    operand's type, in a checkpoint's recompute too, and returns what it
    returns outside a trace; the elementwise ops it dispatches count
    nothing."""
    from torch.utils.checkpoint import checkpoint

    x = torch.empty(2, 3, 4, 64, device="meta", requires_grad=True)
    y = torch.empty(2, 3, 4, 64, device="meta")

    def f(x):
        return torch.linalg.vecdot(x * 2, y)[..., None] * x

    def step():
        checkpoint(f, x, use_reentrant=False).sum().backward()

    _, tr = roofline.trace(step)
    assert tr.flops == {"float32": 2 * (2 * 2 * 3 * 4 * 64)}  # the forward and its recompute
    a, b = torch.randn(5, 7, 64, dtype=torch.bfloat16), torch.randn(5, 7, 64, dtype=torch.bfloat16)
    with roofline._vecdots(roofline.Tracer()):
        inside = torch.linalg.vecdot(a, b)
    assert torch.equal(inside, torch.linalg.vecdot(a, b))
    assert torch.equal(inside, (a * b).sum(-1))


def test_traced_flops_match_the_reference_hlo():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    cells = [f"{m[0]}x{m[1]}:{a}:{k}" for m, a, k, _ in FLOP_CELLS]
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, *cells], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    want = {line.split()[1]: float(line.split()[2]) for line in r.stdout.splitlines()
            if line.startswith("FLOPS")}
    assert len(want) == len(cells)
    for (dims, arch, kind, extra), cell in zip(FLOP_CELLS, cells):
        shape = ShapeSpec("c", kind, S, B)
        progs = build_programs(reduced_config(arch), MeshShape(dims, ("data", "model")), shape)
        got = trace_programs(progs, shape)["roofline"]["flops"]
        assert got - want[cell] == extra, (cell, got, want[cell])


PRODUCTION_SPLIT_SCRIPT = r'''
import dataclasses, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
from repro.compat import make_mesh
from repro.configs import reduced_config
from repro.configs.shapes import ShapeSpec
from repro.launch import roofline, steps

cfg = dataclasses.replace(reduced_config("rwkv6-3b"), d_model=2560, num_heads=40,
                          num_kv_heads=40, num_layers=1)
mesh = make_mesh((1, 16), ("data", "model"))
progs = steps.build_programs(cfg, mesh, ShapeSpec("c", "prefill", 16, 2))
with mesh:
    compiled = progs.step.lower(*progs.abstract_inputs).compile()
print("FLOPS", roofline.analyze(compiled.as_text()).flops, flush=True)
'''


def test_rwkv6_production_head_split_matches_the_reference_hlo():
    """rwkv6-3b's time mix at its own width (d 2560, 40 heads) over a
    ``model`` axis of 16, which does not divide the heads: one layer's
    prefill on (1, 16) traces the FLOPs of the reference's HLO (each rank
    runs 3 whole heads, the 40 padded to 48, and its 160 columns of each
    projection)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", PRODUCTION_SPLIT_SCRIPT], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    want = float(next(line.split()[1] for line in r.stdout.splitlines() if line.startswith("FLOPS")))
    cfg = dataclasses.replace(reduced_config("rwkv6-3b"), d_model=2560, num_heads=40,
                              num_kv_heads=40, num_layers=1)
    shape = ShapeSpec("c", "prefill", 16, 2)
    progs = build_programs(cfg, MeshShape((1, 16), ("data", "model")), shape)
    assert trace_programs(progs, shape)["roofline"]["flops"] == want
