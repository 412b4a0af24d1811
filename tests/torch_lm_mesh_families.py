"""Shared set-up of the LM-mesh family tests
(``tests/test_torch_lm_mesh_{rwkv6,zamba2,whisper,phi3v}.py``): the ssm,
hybrid, encdec and vlm families on the port's ``(data, model)`` mesh
against the JAX package's sharded programs.

The reference runs in a subprocess on a forced 8-device host mesh, once for
each of the (4, 2) and (2, 4) meshes: its own ``launch/steps.py`` programs
for the reduced config of one arch in float32 (prefill, 4 decode steps and
the decode state after each, ``jax.value_and_grad`` of the loss under the
train program's shardings, one train step; the VLM's prompt is its stub
patches, from the numpy seed, then the tokens). It saves its weights (every
leaf that init leaves constant moved by noise, so that the comparison sees
it) and results; the port loads the same weights onto 8 gloo rank processes
of the same mesh shape and is held to them.

A test file names its arch in ``ARCH`` and imports the fixtures below.
Every test has a time limit of its own (an alarm), every mesh call one."""
import dataclasses
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch.configs import ShapeSpec
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch.mesh import close_meshes, make_mesh
from repro_torch.launch.steps import (
    build_decode_programs, build_prefill_programs, build_train_programs,
)
from repro_torch.models import api

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(4, 2), (2, 4)]
B, S, G = 8, 16, 4  # batch, prompt, decode steps (the reference script's)
TOL = dict(rtol=1e-4, atol=1e-4)  # float32 sums in another order (tests/test_torch_lm.py)
GRAD_RTOL = 1e-4  # each grad leaf against its largest magnitude (tests/torch_lm_families.py)
MESH_TIMEOUT_S = 60.0
TEST_LIMIT_S = 120
REF_TIMEOUT_S = 600

REF_SCRIPT = r'''
import os, sys
# the in-order schedule: with the concurrency-optimised one, the uneven-frames
# program's collective-permute and all-gathers deadlock the 8 host devices on
# a loaded machine (2 free cores are enough to show it)
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8"
                           " --xla_cpu_enable_concurrency_optimized_scheduler=false")
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.configs import reduced_config
from repro.configs.shapes import ShapeSpec
from repro.launch import steps
from repro.models import api
from repro.optim import AdamWConfig

out_path, dims, arch = sys.argv[1], tuple(int(v) for v in sys.argv[2].split("x")), sys.argv[3]
upd = {k: int(v) for k, v in (kv.split("=") for kv in sys.argv[4:])}  # integer config fields
mesh = make_mesh(dims, ("data", "model"))
B, S, G = 8, 16, 4
out = {}


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def save(prefix, tree):
    for name, a in flat(jax.tree.map(np.array, tree)):
        out[f"{prefix}/{name}"] = a


def save_state(prefix, state):
    for name, a in state._asdict().items():
        out[f"{prefix}/{name}"] = np.array(a)


import dataclasses
cfg = dataclasses.replace(reduced_config(arch), **upd)
init = api.init_params(cfg, jax.random.PRNGKey(0))
rng = np.random.default_rng(100)


def move(a):
    """A leaf that init leaves constant (norms, biases, rwkv6's mixes, decay
    and bonus, Mamba-2's a_log, d_skip, dt_bias) moved by 0.1 N(0, 1)."""
    x = np.asarray(a, np.float32)
    if x.size > 1 and np.all(x == x.flat[0]):
        x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
    return x


tree = jax.tree.map(move, init)
save("params", tree)
dtypes = jax.tree.map(lambda a: a.dtype, init)


def params():
    return jax.tree.map(lambda a, dt: jnp.asarray(a).astype(dt), tree, dtypes)


data = np.random.default_rng(1)
toks = data.integers(0, cfg.vocab_size, (B, S + G + 1)).astype(np.int32)
out["tokens"] = toks
extra = {}
if cfg.family == "encdec":
    extra["frames"] = data.standard_normal((B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    out["frames"] = extra["frames"]
if cfg.family == "vlm":
    extra["patches"] = data.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    out["patches"] = extra["patches"]
L = S + G + (cfg.num_patches if cfg.family == "vlm" else 0)  # the caches' length
with mesh:
    pre = steps.build_prefill_programs(cfg, mesh, ShapeSpec("p", "prefill", L, B))
    logits, state = pre.step(params(), {"tokens": jnp.asarray(toks[:, :S]),
                                        **{k: jnp.asarray(v) for k, v in extra.items()}})
    out["prefill"] = np.array(logits)
    save_state("state_prefill", state)
    dec = steps.build_decode_programs(cfg, mesh, ShapeSpec("d", "decode", L, B))
    for i in range(G):
        logits, state = dec.step(params(), jnp.asarray(toks[:, S + i:S + i + 1]), state)
        out[f"decode{i}"] = np.array(logits)
        save_state(f"state{i}", state)
    tr = steps.build_train_programs(cfg, mesh, ShapeSpec("t", "train", S, B))
    batch = {"tokens": jnp.asarray(toks[:, :S + 1]), **{k: jnp.asarray(v) for k, v in extra.items()}}
    loss, grads = jax.jit(jax.value_and_grad(lambda p, b: api.loss_fn(tr.ctx, p, b)),
                          in_shardings=(tr.param_sharding, tr.batch_sharding))(params(), batch)
    out["loss"] = np.array(loss)
    save("grads", grads)
    p = params()
    new, _, metrics = tr.step(p, api.init_opt(cfg, p, AdamWConfig()), batch)
    out["step_loss"] = np.array(metrics["loss"])
    out["step_grad_norm"] = np.array(metrics["grad_norm"])
    save("stepped", new)
np.savez(out_path, **out)
print("REF-MESH-OK", len(out))
'''


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test fails with TimeoutError after TEST_LIMIT_S seconds."""

    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {TEST_LIMIT_S} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def reference(arch: str, shape: tuple, out_dir: Path, **upd) -> dict:
    """The reference script's results for ``arch`` (its reduced config with
    the integer fields ``upd`` replaced) on the ``shape`` mesh."""
    path = out_dir / f"{arch}-{shape[0]}x{shape[1]}.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(path), f"{shape[0]}x{shape[1]}", arch,
                        *(f"{k}={v}" for k, v in upd.items())],
                       env=env, capture_output=True, text=True, timeout=REF_TIMEOUT_S)
    assert r.returncode == 0 and "REF-MESH-OK" in r.stdout, f"stdout={r.stdout}\nstderr={r.stderr}"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module", params=SHAPES, ids=["4x2", "2x4"])
def world(request, tmp_path_factory):
    """(mesh shape, the port's mesh of that shape, the reference's results
    for the module's ``ARCH``). The reference runs before the ranks start:
    each takes the machine's cores."""
    ref = reference(request.module.ARCH, request.param, tmp_path_factory.mktemp("ref_mesh"))
    mesh = make_mesh(request.param, ("data", "model"), device="cpu", timeout=MESH_TIMEOUT_S)
    try:
        yield request.param, mesh, ref
    finally:
        mesh.close()
        assert mesh.exit_codes == [0] * mesh.size


@pytest.fixture(scope="module", autouse=True)
def _close_meshes():
    yield
    close_meshes()


def tree(ref: dict, prefix: str) -> dict:
    """The nested dict of the reference's leaves under ``prefix``."""
    out: dict = {}
    for key, a in ref.items():
        if key.startswith(prefix):
            node = out
            *head, last = key[len(prefix):].split(".")
            for part in head:
                node = node.setdefault(part, {})
            node[last] = a
    return out


def close(got, want, what: str) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=what, **TOL)


def grads_close(got: dict, want: dict) -> None:
    """Each leaf within GRAD_RTOL of its largest magnitude."""
    flat_got, flat_want = {}, {}

    def walk(node, out, path=""):
        for key, v in node.items():
            if isinstance(v, dict):
                walk(v, out, f"{path}{key}.")
            else:
                out[f"{path}{key}"] = v

    walk(lm_params_to_numpy(got), flat_got)
    walk(want, flat_want)
    assert set(flat_got) == set(flat_want)
    for name, w in flat_want.items():
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(flat_got[name], w, rtol=0, atol=GRAD_RTOL * scale, err_msg=name)


def inputs(cfg, ref: dict, n: int) -> dict:
    """The first ``n`` tokens of each row, and the frames (encdec) or the
    patches (vlm)."""
    batch = {"tokens": torch.as_tensor(ref["tokens"][:, :n]).long()}
    for name in ("frames", "patches"):
        if name in ref:
            batch[name] = torch.as_tensor(ref[name])
    return batch


def n_patches(cfg) -> int:
    """The positions before the prompt's tokens (the VLM's patches)."""
    return cfg.num_patches if cfg.family == "vlm" else 0


def check_state(state, ref: dict, prefix: str) -> None:
    for name in state._fields:
        if name != "length":
            close(getattr(state, name), ref[f"{prefix}/{name}"], f"{prefix} {name}")


def check_serve(mesh, ref: dict, arch: str, **upd) -> None:
    """Prefill logits, the state after it, 4 decode steps and the state
    after each, against the reference's."""
    cfg = dataclasses.replace(TC.reduced_config(arch), **upd)
    key = f"{arch}-{upd.get('attn_impl', 'reference')}"
    n = n_patches(cfg) + S + G
    pre = build_prefill_programs(cfg, mesh, ShapeSpec("p", "prefill", n, B), key=key)
    dec = build_decode_programs(cfg, mesh, ShapeSpec("d", "decode", n, B), key=key)
    pre.load(lm_params_from_numpy(cfg, tree(ref, "params/"), device="cpu"))
    close(pre.step(inputs(cfg, ref, S)), ref["prefill"], "prefill logits")
    check_state(pre.gather_state(), ref, "state_prefill")
    toks = torch.as_tensor(ref["tokens"]).long()
    for i in range(G):
        close(dec.step(toks[:, S + i:S + i + 1]), ref[f"decode{i}"], f"decode step {i}")
        state = dec.gather_state()
        if hasattr(state, "length"):
            assert state.length == n_patches(cfg) + S + i + 1
        check_state(state, ref, f"state{i}")
    assert set(pre.collectives()) <= {"data", "model"} and pre.collectives()["model"]["calls"] > 0
    pre.release()


def check_train(mesh, ref: dict, arch: str, **upd) -> None:
    """The loss and every gradient, then one train step (its loss, grad
    norm and every updated weight), against the reference's."""
    cfg = dataclasses.replace(TC.reduced_config(arch), **upd)
    train = build_train_programs(cfg, mesh, ShapeSpec("t", "train", S, B), key=f"{arch}-train")
    assert train.rules.residual_seq == ("model",)
    train.load(lm_params_from_numpy(cfg, tree(ref, "params/"), device="cpu"))
    batch = inputs(cfg, ref, S + 1)
    loss, grads = train.loss_and_grads(batch)
    close(loss, ref["loss"], "loss")
    grads_close(grads, tree(ref, "grads/"))
    metrics = train.step(batch)
    close(metrics["loss"], ref["step_loss"], "train step loss")
    close(metrics["grad_norm"], ref["step_grad_norm"], "train step grad norm")
    want = lm_params_from_numpy(cfg, tree(ref, "stepped/"), device="cpu")
    for name, t in train.gather_params().items():
        close(t, want[name], f"updated {name}")
    assert train.gather_opt_state().step == 1
    train.release()


def check_init(mesh, arch: str) -> None:
    """``init(seed)``: each rank draws every weight in ``init_params``'
    order and keeps its block, so the blocks put together are the model
    ``init_params(cfg, seed)`` draws whole."""
    cfg = TC.reduced_config(arch)
    pre = build_prefill_programs(cfg, mesh, ShapeSpec("p", "prefill", S + G, B), key=f"{arch}-init")
    pre.init(seed=3)
    whole = {n: p.detach() for n, p in api.init_params(cfg, seed=3, device="cpu").named_parameters()}
    got = pre.gather_params()
    assert set(got) == set(whole)
    for name, t in whole.items():
        assert torch.equal(got[name], t), name
    pre.release()
