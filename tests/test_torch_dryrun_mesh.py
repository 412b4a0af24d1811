"""The dry-run's traced rank against a real mesh: for reduced cells of the
dense, MoE (each expert-parallel mode), SSM, hybrid, encdec and VLM families,
the collective calls per axis that rank 0's trace on ``MeshShape((2, 2))``
records equal those every rank of a 4-rank gloo CPU mesh of that shape
counts for the same prefill, decode step and train step. And the MoE slot
tally, now read by the mesh, gives the prefill's ``drops()`` the tally read
in the layer gave.

Every test has a time limit of its own (an alarm), every mesh call one."""
import dataclasses
import signal

import numpy as np
import pytest
import torch

import torch_lm_mesh_bodies as bodies
from repro_torch.configs import ShapeSpec, reduced_config
from repro_torch.launch.dryrun import trace_programs
from repro_torch.launch.mesh import MeshShape, close_meshes, make_mesh
from repro_torch.launch.serve import stub_inputs
from repro_torch.launch.steps import build_programs

DIMS = (2, 2)
B, S = 8, 16
CELLS = [("llama3.2-3b", None), ("moonshot-v1-16b-a3b", "ep_push"),
         ("moonshot-v1-16b-a3b", "ep_pull"), ("rwkv6-3b", None), ("zamba2-2.7b", None),
         ("whisper-small", None), ("phi-3-vision-4.2b", None)]
MESH_TIMEOUT_S = 60.0
TEST_LIMIT_S = 120


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {TEST_LIMIT_S} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


@pytest.fixture(scope="module")
def mesh():
    m = make_mesh(DIMS, ("data", "model"), device="cpu", timeout=MESH_TIMEOUT_S)
    try:
        yield m
    finally:
        m.close()
        close_meshes()
        assert m.exit_codes == [0] * m.size


def _cfg(arch, mode):
    cfg = reduced_config(arch)
    return dataclasses.replace(cfg, moe_dispatch=mode) if mode else cfg


def _calls(progs) -> dict:
    return {axis: c["calls"] for axis, c in progs.collectives().items()}


def _traced(cfg, shape) -> dict:
    progs = build_programs(cfg, MeshShape(DIMS, ("data", "model")), shape)
    return {a: n for a, n in trace_programs(progs, shape)["collective_calls"].items()}


@pytest.mark.parametrize("arch,mode", CELLS, ids=[f"{a}-{m}" if m else a for a, m in CELLS])
def test_traced_collective_calls_equal_the_gloo_mesh(mesh, arch, mode):
    cfg = _cfg(arch, mode)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S + 2)))
    extra = {k: torch.as_tensor(v) for k, v in stub_inputs(cfg, B, 1).items()}
    patches = cfg.num_patches if cfg.family == "vlm" else 0  # positions before the tokens
    pre_shape = ShapeSpec("p", "prefill", patches + S + 2, B)
    dec_shape = dataclasses.replace(pre_shape, kind="decode")
    train_shape = ShapeSpec("t", "train", S, B)
    key = f"{arch}-{mode}"
    pre = build_programs(cfg, mesh, pre_shape, key=key)
    dec = build_programs(cfg, mesh, dec_shape, key=key)
    pre.init(0)
    pre.step({"tokens": toks[:, :S], **extra})
    assert _calls(pre) == _traced(cfg, pre_shape)
    for i in range(2):
        dec.step(toks[:, S + i:S + i + 1])
    assert _calls(dec) == _traced(cfg, dec_shape)
    pre.release()
    train = build_programs(cfg, mesh, train_shape, key=f"{key}-train")
    train.init(0)
    train.step({"tokens": toks[:, :S - patches + 1], **extra})
    assert _calls(train) == _traced(cfg, train_shape)
    train.release()


@pytest.mark.parametrize("mode", ["ep_push", "ep_pull", "tp"])
def test_moe_drops_equal_the_tally_read_in_the_layer(mesh, mode):
    cfg = dataclasses.replace(reduced_config("moonshot-v1-16b-a3b"), moe_dispatch=mode)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)))
    pre = build_programs(cfg, mesh, ShapeSpec("p", "prefill", S, B), key=f"drops-{mode}")
    pre.init(0)
    pre.step({"tokens": toks})
    drops = pre.drops()
    pre._call(bodies.prefill_host_tally, {"tokens": toks}, max_len=S)
    assert drops == pre.drops()
    assert drops["routed"] == B * S * cfg.experts_per_token * cfg.num_layers
    assert all(isinstance(v, int) for v in drops.values())
    pre.release()
