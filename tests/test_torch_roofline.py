"""The dry-run's byte source (``launch/roofline.py``) against the JAX
package's HLO roofline: ``model_flops`` formula for formula, the ring costs
of each collective kind, FLOPs split by type, the peak-live tracker, the
flash stand-in, and the traced FLOPs of reduced float32 cells against the
HLO count of the reference's own sharded programs on the forced 8-device
host mesh (one subprocess for every cell).

Named differences (the port counts more, both from work it replicates over
``model`` where GSPMD splits it):

- rwkv6: the decay LoRA's down-projection (``x @ w_lora_a``, d -> 32) runs
  on every row of the rank, where GSPMD splits the rows over ``model``;
  its bonus term (r * u * k summed over the head dim) is a dot in the HLO
  and an elementwise product and sum here. On (4, 2): +2.04 % (prefill),
  +1.99 % (train). On (2, 4) its 2 heads do not divide ``model``: the port
  replicates the time mix, GSPMD splits each head's channels (+30 %).
- zamba2: Mamba-2's C.B scores contract the whole state dim on every
  ``model`` rank, where GSPMD splits it: +0.13 % to +1.0 %.

The dense, MoE, encdec and VLM cells are equal."""
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
# (mesh, arch, kind) cells held against the HLO count, and the relative
# tolerance of each (module docstring)
FLOP_CELLS = [
    ((2, 4), "llama3.2-3b", "prefill", 0.0), ((2, 4), "llama3.2-3b", "train", 0.0),
    ((2, 4), "moonshot-v1-16b-a3b", "prefill", 0.0), ((2, 4), "moonshot-v1-16b-a3b", "train", 0.0),
    ((2, 4), "whisper-small", "prefill", 0.0), ((2, 4), "whisper-small", "train", 0.0),
    ((2, 4), "phi-3-vision-4.2b", "train", 0.0),
    ((2, 4), "zamba2-2.7b", "prefill", 0.02), ((2, 4), "zamba2-2.7b", "train", 0.02),
    ((4, 2), "rwkv6-3b", "prefill", 0.025), ((4, 2), "rwkv6-3b", "train", 0.025),
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


def test_traced_flops_match_the_reference_hlo():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    cells = [f"{m[0]}x{m[1]}:{a}:{k}" for m, a, k, _ in FLOP_CELLS]
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, *cells], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    want = {line.split()[1]: float(line.split()[2]) for line in r.stdout.splitlines()
            if line.startswith("FLOPS")}
    assert len(want) == len(cells)
    for (dims, arch, kind, rel), cell in zip(FLOP_CELLS, cells):
        shape = ShapeSpec("c", kind, S, B)
        progs = build_programs(reduced_config(arch), MeshShape(dims, ("data", "model")), shape)
        got = trace_programs(progs, shape)["roofline"]["flops"]
        assert got == pytest.approx(want[cell], rel=rel, abs=0), (cell, got, want[cell])
