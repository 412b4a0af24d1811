"""The port's LM ``(data, model)`` mesh (``launch/steps.py``'s programs on
``launch/mesh.py``'s rank processes; the sharded layers, MoE modes, loss
and optimizer) against the JAX package's sharded programs.

The reference runs in a subprocess on a forced 8-device host mesh (the one
``tests/test_moe.py`` and ``tests/test_perf_opts.py`` use), once for each
of the (4, 2) and (2, 4) meshes, in turn: its own
``launch/steps.py`` programs for the reduced llama3.2-3b and
moonshot-v1-16b-a3b configs in float32 (prefill, 4 decode steps, the
caches, ``jax.value_and_grad`` of the loss under the train program's
shardings, one train step), ``moe_sublayer`` in the three modes at
capacity factors 8 (nothing drops) and 1.25 (each mode drops by its own
capacity rules, recounted shard by shard with the reference's routing;
two experts' router columns scaled by 3 so that they overfill), and
the padded-head forward. It saves its weights and results; the port loads
the same weights onto 8 gloo rank processes of the same mesh shape (one
mesh a shape, module-scoped) and is held to them. Then a re-mesh from
(2, 2) to (1, 2) through ``plan_remesh``/``make_elastic_mesh``, and the
rank-side initialisation against the unsharded model.

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
from repro_torch.launch.mesh import (
    MeshShape, close_meshes, make_host_mesh, make_mesh, make_mesh_over,
)
from repro_torch.launch.steps import (
    MICROBATCHES, build_decode_programs, build_prefill_programs, build_programs,
    build_train_programs,
)
from repro_torch.models import api
from repro_torch.models import sharding as sh
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import make_rules
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import make_elastic_mesh, plan_remesh, remesh

import torch_lm_mesh_bodies as bodies

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(4, 2), (2, 4)]
ARCHS = ["llama3.2-3b", "moonshot-v1-16b-a3b"]
MODES = ["ep_push", "ep_pull", "tp"]
B, S, G = 8, 16, 4  # batch, prompt, decode steps (the reference script's)
LONG = 24  # the long-context cache: divides over data x model
TOL = dict(rtol=1e-4, atol=1e-4)  # float32 sums in another order (tests/test_torch_lm.py)
MOE_SINGLE_ATOL = 1e-3  # mesh modes vs single device, nothing dropped (tests/test_moe.py)
MESH_TIMEOUT_S = 60.0
TEST_LIMIT_S = 120
REF_TIMEOUT_S = 900

REF_SCRIPT = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.compat import make_mesh
from repro.configs import reduced_config
from repro.configs.shapes import ShapeSpec
from repro.launch import steps
from repro.models import api, Ctx
from repro.models.config import ModelConfig
from repro.models.moe import moe_params, moe_sublayer, _route, _positions_in_expert, _capacity
from repro.models.sharding import make_rules
from repro.optim import AdamWConfig

out_path, dims = sys.argv[1], tuple(int(v) for v in sys.argv[2].split("x"))
mesh = make_mesh(dims, ("data", "model"))
ds, ms = dims
B, S, G, LONG = 8, 16, 4, 24
out = {}


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def params_for(cfg, seed=0):
    """init_params with the norm weights (ones at init) moved by noise."""
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), api.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    for p in (tree["blocks"]["ln1"], tree["blocks"]["ln2"], tree["final_norm"]):
        p["w"] = (1 + 0.1 * rng.standard_normal(p["w"].shape)).astype(np.float32)
    return tree


for arch in ("llama3.2-3b", "moonshot-v1-16b-a3b"):
    cfg = reduced_config(arch)
    tree = params_for(cfg)
    for name, a in flat(tree):
        out[f"{arch}/params/{name}"] = a
    params = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + G + 1)).astype(np.int32)
    out[f"{arch}/tokens"] = toks
    with mesh:
        pre = steps.build_prefill_programs(cfg, mesh, ShapeSpec("p", "prefill", S + G, B))
        logits, state = pre.step(params, {"tokens": jnp.asarray(toks[:, :S])})
        out[f"{arch}/prefill"] = np.asarray(logits)
        dec = steps.build_decode_programs(cfg, mesh, ShapeSpec("d", "decode", S + G, B))
        for i in range(G):
            logits, state = dec.step(params, jnp.asarray(toks[:, S + i:S + i + 1]), state)
            out[f"{arch}/decode{i}"] = np.asarray(logits)
        out[f"{arch}/cache_k"], out[f"{arch}/cache_v"] = np.asarray(state.k), np.asarray(state.v)
        out[f"{arch}/cache_len"] = np.asarray(state.length)
        tr = steps.build_train_programs(cfg, mesh, ShapeSpec("t", "train", S, B))
        batch = {"tokens": jnp.asarray(toks[:, :S + 1])}
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: api.loss_fn(tr.ctx, p, b)),
                              in_shardings=(tr.param_sharding, tr.batch_sharding))(params, batch)
        out[f"{arch}/loss"] = np.asarray(loss)
        for name, a in flat(jax.tree.map(np.asarray, grads)):
            out[f"{arch}/grads/{name}"] = a
        opt = api.init_opt(cfg, params, AdamWConfig())
        _, _, metrics = tr.step(params, opt, batch)
        out[f"{arch}/step_loss"] = np.asarray(metrics["loss"])
        out[f"{arch}/step_grad_norm"] = np.asarray(metrics["grad_norm"])
        params = jax.tree.map(jnp.asarray, tree)  # the train step donated the last ones
        trc = steps.build_train_programs(cfg, mesh, ShapeSpec("t", "train", S, B),
                                         AdamWConfig(compress_grads=True))
        _, _, metrics = trc.step(params, api.init_opt(cfg, params, AdamWConfig(compress_grads=True)),
                                 batch)
        out[f"{arch}/int8_grad_norm"] = np.asarray(metrics["grad_norm"])
        if arch == "llama3.2-3b":  # long context: a batch smaller than data (2 or 1)
            b = 2 if ds > 2 else 1
            params = jax.tree.map(jnp.asarray, tree)  # the train step donated the last ones
            # its prefill program cannot take such a batch (jit needs data to divide
            # it), so the unsharded prefill makes the state the decode program reshards
            _, state = api.prefill(Ctx(cfg=cfg), params, jnp.asarray(toks[:b, :S]), LONG)
            dec = steps.build_decode_programs(cfg, mesh, ShapeSpec("d", "decode", LONG, b))
            assert dec.rules.batch is None and "data" in dec.rules.kv_seq
            for i in range(2):
                logits, state = dec.step(params, jnp.asarray(toks[:b, S + i:S + i + 1]), state)
                out[f"long/decode{i}"] = np.asarray(logits)

mcfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=64, num_heads=2,
                   num_kv_heads=2, d_ff=128, vocab_size=64, num_experts=8,
                   experts_per_token=2, moe_d_ff=32, capacity_factor=8.0,
                   dtype="float32", remat=False)
mp = moe_params(mcfg, jax.random.PRNGKey(0))
mp["router"] = mp["router"].at[:, :2].multiply(3.0)  # experts 0 and 1 overfill at 1.25
x = jax.random.normal(jax.random.PRNGKey(1), (8, 128, 64))
for k, v in mp.items():
    out[f"moe/params/{k}"] = np.asarray(v)
out["moe/x"] = np.asarray(x)
rules = make_rules(mesh, num_experts=8, num_heads=2, num_kv_heads=2)
out["moe/single"] = np.asarray(moe_sublayer(Ctx(cfg=mcfg), mp, x))


def kept_slots(cfg, p, x, mode):
    """The reference's kept slots under its mesh bodies, recounted shard by
    shard with its own routing, ranks and capacities."""
    b, s, d = x.shape
    e = cfg.num_experts
    shards = np.asarray(x).reshape(ds, (b // ds) * s, d)
    if mode == "tp":
        kept = 0
        for xt in shards:
            tc = min(8192, xt.shape[0])
            cap = _capacity(cfg, tc, e)
            for i in range(0, xt.shape[0], tc):
                _, ex = _route(cfg, jnp.asarray(xt[i:i + tc]), p["router"])
                kept += int((_positions_in_expert(ex.reshape(-1), e) < cap).sum())
        return kept
    e_local = e // ds
    t_full = shards.shape[1]
    slices = ms if (ms > 1 and t_full % ms == 0 and t_full >= ms) else 1
    t = t_full // slices
    kept = 0
    for mi in range(slices):
        efs = [np.asarray(_route(cfg, jnp.asarray(xt[mi * t:(mi + 1) * t]), p["router"])[1]).reshape(-1)
               for xt in shards]
        cap_e = _capacity(cfg, t * ds, e)
        for owner in range(ds):
            if mode == "ep_push":
                cap_pair = _capacity(cfg, t, ds)
                recv = []
                for ef in efs:
                    ow = ef // e_local
                    pos = np.asarray(_positions_in_expert(jnp.asarray(ow), ds))
                    slots = np.full(cap_pair, -1)
                    for sl in range(len(ef)):
                        if ow[sl] == owner and pos[sl] < cap_pair:
                            slots[pos[sl]] = ef[sl]
                    recv.append(slots)
                rf = np.concatenate(recv)
                le = np.where(rf >= 0, rf - owner * e_local, e_local)
            else:
                eg = np.concatenate(efs)
                le = np.where(eg // e_local == owner, eg - owner * e_local, e_local)
            rpos = np.asarray(_positions_in_expert(jnp.asarray(le), e_local + 1))
            kept += int(((le < e_local) & (rpos < cap_e)).sum())
    return kept


for cf in (8.0, 1.25):
    c = dataclasses.replace(mcfg, capacity_factor=cf)
    ctx = Ctx(cfg=c, mesh=mesh, rules=rules)
    for mode in ("ep_push", "ep_pull", "tp"):
        with mesh:
            o = jax.jit(lambda p, x: moe_sublayer(ctx, p, x, dispatch=mode))(mp, x)
        out[f"moe/{mode}/{cf}"] = np.asarray(o)
        out[f"moe/{mode}/{cf}/kept"] = np.asarray(kept_slots(c, mp, x, mode))

pcfg = dataclasses.replace(reduced_config("llama3.2-3b"), num_heads=6, num_kv_heads=2,
                           head_dim=16, d_model=96, d_ff=192)
prules = make_rules(mesh, num_heads=6, num_kv_heads=2, vocab_size=pcfg.vocab_size)
ptree = params_for(pcfg)
for name, a in flat(ptree):
    out[f"pad/params/{name}"] = a
ptoks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0, pcfg.vocab_size))
out["pad/tokens"] = ptoks
pparams = jax.tree.map(jnp.asarray, ptree)
m = api.module_for(pcfg)
for tag, c in (("base", pcfg), ("padded", dataclasses.replace(pcfg, tp_pad_heads=True))):
    ctx = Ctx(cfg=c, mesh=mesh, rules=prules)
    with mesh:
        out[f"pad/{tag}"] = np.asarray(jax.jit(lambda p, t: m.forward(ctx, p, t))(pparams, ptoks))
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


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference script's results for each mesh shape, run when first
    needed (one subprocess at a time: each takes the machine's cores)."""
    out = tmp_path_factory.mktemp("ref_mesh")
    return {"dir": out}


def _results(runs, shape) -> dict:
    if shape not in runs:
        path = runs["dir"] / f"{shape[0]}x{shape[1]}.npz"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(path), f"{shape[0]}x{shape[1]}"],
                           env=env, capture_output=True, text=True, timeout=REF_TIMEOUT_S)
        assert r.returncode == 0 and "REF-MESH-OK" in r.stdout, f"stdout={r.stdout}\nstderr={r.stderr}"
        with np.load(path) as z:
            runs[shape] = {k: z[k] for k in z.files}
    return runs[shape]


@pytest.fixture(scope="module", params=SHAPES, ids=["4x2", "2x4"])
def world(request, reference_runs):
    """(mesh shape, the port's mesh of that shape, the reference's results)."""
    ref = _results(reference_runs, request.param)
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


def _tree(ref: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, a in ref.items():
        if key.startswith(prefix):
            node = tree
            *head, last = key[len(prefix):].split(".")
            for part in head:
                node = node.setdefault(part, {})
            node[last] = a
    return tree


def _weights(cfg, ref: dict, tag: str) -> dict:
    return lm_params_from_numpy(cfg, _tree(ref, f"{tag}/params/"), device="cpu")


def _close(got, want, what: str, **tol) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               err_msg=what, **(tol or TOL))


def _programs(cfg, mesh, key):
    pre = build_prefill_programs(cfg, mesh, ShapeSpec("p", "prefill", S + G, B), key=key)
    dec = build_decode_programs(cfg, mesh, ShapeSpec("d", "decode", S + G, B), key=key)
    return pre, dec


# -- the LM on the mesh against the reference's sharded programs --------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_caches_match_the_reference_mesh(world, arch):
    shape, mesh, ref = world
    cfg = TC.reduced_config(arch)
    pre, dec = _programs(cfg, mesh, key=arch)
    pre.load(_weights(cfg, ref, arch))
    toks = torch.as_tensor(ref[f"{arch}/tokens"]).long()
    _close(pre.step({"tokens": toks[:, :S]}), ref[f"{arch}/prefill"], "prefill logits")
    for i in range(G):
        _close(dec.step(toks[:, S + i:S + i + 1]), ref[f"{arch}/decode{i}"], f"decode step {i}")
    state = dec.gather_state()
    assert state.length == int(ref[f"{arch}/cache_len"]) == S + G
    _close(state.k, ref[f"{arch}/cache_k"], "cache k")
    _close(state.v, ref[f"{arch}/cache_v"], "cache v")
    assert set(pre.collectives()) <= {"data", "model"} and pre.collectives()["model"]["calls"] > 0
    flash = build_prefill_programs(dataclasses.replace(cfg, attn_impl="flash"), mesh,
                                   ShapeSpec("p", "prefill", S + G, B), key=arch)
    _close(flash.step({"tokens": toks[:, :S]}), ref[f"{arch}/prefill"], "flash prefill logits")


def test_long_context_decode_matches_the_reference_mesh(world):
    """A batch smaller than ``data``: the decode rules replicate it and shard
    the KV sequence over ``data`` (and ``model``, llama's one kv head not
    dividing it); the prefill's caches are relaid on the first step, and
    attention reduces its softmax over both axes. The reference's state
    comes from its unsharded prefill (its prefill program cannot take the
    batch), resharded by its decode program."""
    shape, mesh, ref = world
    cfg = TC.reduced_config("llama3.2-3b")
    b = 2 if shape[0] > 2 else 1
    pre = build_prefill_programs(cfg, mesh, ShapeSpec("p", "prefill", LONG, b), key="long")
    dec = build_decode_programs(cfg, mesh, ShapeSpec("d", "decode", LONG, b), key="long")
    assert pre.rules.batch is None  # data does not divide the batch: replicated
    assert dec.rules.batch is None and dec.rules.kv_seq == ("data", "model")
    pre.load(_weights(cfg, ref, "llama3.2-3b"))
    toks = torch.as_tensor(ref["llama3.2-3b/tokens"]).long()
    pre.step({"tokens": toks[:b, :S]})
    for i in range(2):
        _close(dec.step(toks[:b, S + i:S + i + 1]), ref[f"long/decode{i}"], f"long decode {i}")
    assert dec.gather_state().length == S + 2


def _grads_close(got: dict, ref: dict, prefix: str) -> None:
    """Each leaf within 1e-4 of its largest magnitude (``GRAD_RTOL`` of
    ``tests/torch_lm_families.py``: float32 sums in other orders)."""
    want = {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}
    flat = {}

    def walk(tree, path=""):
        for key, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}{key}.")
            else:
                flat[f"{path}{key}"] = v

    walk(lm_params_to_numpy(got))
    assert set(flat) == set(want)
    for name, w in want.items():
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(flat[name], w, rtol=0, atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_train_step_match_the_reference_mesh(world, arch):
    shape, mesh, ref = world
    cfg = TC.reduced_config(arch)
    train = build_train_programs(cfg, mesh, ShapeSpec("t", "train", S, B), key=f"{arch}-train")
    assert train.microbatches == 1 and train.rules.residual_seq == ("model",)
    train.load(_weights(cfg, ref, arch))
    batch = {"tokens": torch.as_tensor(ref[f"{arch}/tokens"][:, :S + 1]).long()}
    loss, grads = train.loss_and_grads(batch)
    _close(loss, ref[f"{arch}/loss"], "loss")
    _grads_close(grads, ref, f"{arch}/grads/")
    metrics = train.step(batch)
    _close(metrics["loss"], ref[f"{arch}/step_loss"], "train step loss")
    _close(metrics["grad_norm"], ref[f"{arch}/step_grad_norm"], "train step grad norm")
    assert train.gather_opt_state().step == 1
    int8 = build_train_programs(cfg, mesh, ShapeSpec("t", "train", S, B),
                                AdamWConfig(compress_grads=True), key=f"{arch}-int8")
    int8.load(_weights(cfg, ref, arch))
    # the norm of the dequantized grads: each int8 scale's amax over every shard
    _close(int8.step(batch)["grad_norm"], ref[f"{arch}/int8_grad_norm"], "int8 grad norm")
    assert int8.gather_opt_state().ef_residual is not None


def _moe_cfg(cf: float) -> ModelConfig:
    return ModelConfig(name="t", family="moe", num_layers=1, d_model=64, num_heads=2,
                       num_kv_heads=2, d_ff=128, vocab_size=64, num_experts=8,
                       experts_per_token=2, moe_d_ff=32, capacity_factor=cf,
                       dtype="float32", remat=False)


@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("mode", MODES)
def test_moe_modes_match_the_reference_mesh(world, mode, cf):
    """At factor 8 nothing drops and every mode equals the single-device
    sublayer (1e-3, as ``tests/test_moe.py``); at 1.25 each mode drops by
    its own capacities, and the kept slots and outputs equal the
    reference's mesh."""
    shape, mesh, ref = world
    cfg = _moe_cfg(cf)
    rules = make_rules(mesh, num_experts=8, num_heads=2, num_kv_heads=2)
    params = {k: torch.as_tensor(ref[f"moe/params/{k}"]) for k in ("router", "w_gate", "w_up",
                                                                     "w_down")}
    x = torch.as_tensor(ref["moe/x"])
    out = mesh.run(bodies.moe_layer, (params, x), cfg=cfg, rules=rules, mode=mode)
    got = sh.unblock([r["out"] for r in out], [r["coords"] for r in out],
                     rules.spec("batch", None, None), mesh.shape)
    kept = sum(r["kept"] for r in out)
    routed = sum(r["routed"] for r in out)
    assert routed == x.shape[0] * x.shape[1] * cfg.experts_per_token
    assert kept == int(ref[f"moe/{mode}/{cf}/kept"])
    _close(got, ref[f"moe/{mode}/{cf}"], f"{mode} at {cf}")
    if cf == 8.0:
        assert kept == routed
        _close(got, ref["moe/single"], f"{mode} vs single device", rtol=0, atol=MOE_SINGLE_ATOL)
    else:
        assert kept < routed


def test_padded_head_tp_matches_the_reference_mesh(world):
    """6 heads on a model axis that does not divide them: the replicated
    attention and the padded-head path (``tp_pad_heads``) equal the
    reference's, and each other (``tests/test_perf_opts.py``)."""
    shape, mesh, ref = world
    base = dataclasses.replace(TC.reduced_config("llama3.2-3b"), num_heads=6, num_kv_heads=2,
                               head_dim=16, d_model=96, d_ff=192)
    rules = make_rules(mesh, num_heads=6, num_kv_heads=2, vocab_size=base.vocab_size)
    weights = _weights(base, ref, "pad")
    toks = torch.as_tensor(ref["pad/tokens"]).long()
    outs = {}
    for tag, cfg in (("base", base), ("padded", dataclasses.replace(base, tp_pad_heads=True))):
        if shape[1] == 4:
            assert rules.heads4d is None
        out = mesh.run(bodies.lm_forward, (weights, toks), cfg=cfg, rules=rules)
        outs[tag] = sh.unblock([r["logits"] for r in out], [r["coords"] for r in out],
                               rules.spec("batch", None, "vocab"), mesh.shape)
        _close(outs[tag], ref[f"pad/{tag}"], tag)
    _close(outs["padded"], outs["base"], "padded vs base")


# -- the rank side's own contracts -----------------------------------------------------------


@pytest.fixture(scope="module")
def mesh22():
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu", timeout=MESH_TIMEOUT_S)
    try:
        yield mesh
    finally:
        mesh.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_ranks_draw_the_unsharded_model_from_the_seed(mesh22, arch):
    """``init(seed)``: each rank draws every weight in ``init_params``'
    order and keeps its block, so the blocks put together are the model
    ``init_params(cfg, seed)`` draws whole."""
    cfg = TC.reduced_config(arch)
    pre = build_prefill_programs(cfg, mesh22, ShapeSpec("p", "prefill", S + G, 4),
                                 key=f"{arch}-init")
    stats = pre.init(seed=3)
    assert len(stats) == 4
    whole = {n: p.detach() for n, p in api.init_params(cfg, seed=3, device="cpu").named_parameters()}
    got = pre.gather_params()
    assert set(got) == set(whole)
    for name, t in whole.items():
        assert torch.equal(got[name], t), name


def test_host_mesh_and_a_mesh_over_listed_devices():
    """``make_host_mesh``: a 1-D ``data`` mesh of what the host offers (n
    gloo ranks on the CPU); ``make_mesh_over``: a 1-D mesh, a rank a listed
    device; a shape and names that do not match raise before any process
    starts."""
    with pytest.raises(ValueError, match="one distinct name a dim"):
        make_mesh((2, 2), ("data",), device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        make_mesh_over(["cpu", "cpu"], ("data", "model"))
    host = make_host_mesh(2, device="cpu", timeout=MESH_TIMEOUT_S)
    over = None
    try:
        assert (host.shape, host.backend, host.coords) == ({"data": 2}, "gloo",
                                                           [{"data": 0}, {"data": 1}])
        over = make_mesh_over(["cpu", "cpu", "cpu"], ("nodelet",), timeout=MESH_TIMEOUT_S)
        assert over.shape == {"nodelet": 3} and over.size == 3 and "nodelet 3" in over.describe()
    finally:
        host.close()
        if over is not None:
            over.close()
    assert host.exit_codes == [0, 0] and over.exit_codes == [0, 0, 0]


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b", "whisper-small"])
def test_other_families_build_programs_for_every_kind(arch):
    """The ssm, hybrid and encdec families build train, prefill and decode
    programs (no processes: a mesh shape); a weight spec a parameter, the
    family's decode state specs, and whisper's frames among the inputs
    (their parity on a mesh: ``tests/test_torch_lm_mesh_{rwkv6,zamba2,whisper}.py``)."""
    mesh = MeshShape((2, 2), ("data", "model"))
    for cfg in (TC.reduced_config(arch), TC.get_config(arch)):
        names = {n for n, _ in api.abstract_params(cfg).named_parameters()}
        state = api.decode_state_specs(cfg)
        for kind in ("train", "prefill", "decode"):
            progs = build_programs(cfg, mesh, ShapeSpec(kind, kind, 32, 4))
            assert set(progs.param_sharding) == names and callable(progs.step)
            if kind == "train":
                assert progs.microbatches == MICROBATCHES.get(cfg.name, 1)
            else:
                assert type(progs.state_sharding) is type(state)
                assert progs.state_sharding._fields == state._fields
            if kind != "decode":
                assert ("frames" in progs.batch_sharding) == (cfg.family == "encdec")


def test_remesh_from_2x2_to_1x2_continues_the_loss():
    """A step on (2, 2), then the next step two ways: on (2, 2), and on the
    (1, 2) mesh ``plan_remesh`` picks for two healthy devices (state
    re-sharded through the host, global batch kept, microbatched by the
    plan). The two losses agree."""
    cfg = TC.reduced_config("llama3.2-3b")
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(5)
    batches = [{"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, S + 1)))}
               for _ in range(2)]
    shape = ShapeSpec("t", "train", S, 4)
    old_mesh = make_mesh((2, 2), ("data", "model"), device="cpu", timeout=MESH_TIMEOUT_S)
    new_mesh = None
    try:
        old = build_train_programs(cfg, old_mesh, shape, opt)
        old.init(seed=0)
        first = old.step(batches[0])
        plan = plan_remesh(n_healthy=2, model_axis=2, global_batch=4, prev_data_axis=2)
        assert (plan.data_axis, plan.model_axis, plan.microbatches) == (1, 2, 2)
        new_mesh = make_elastic_mesh(plan, device="cpu", timeout=MESH_TIMEOUT_S)
        assert new_mesh.shape == {"data": 1, "model": 2}
        new = build_train_programs(cfg, new_mesh, shape, opt, microbatches=plan.microbatches)
        remesh(old, new)
        stay = old.step(batches[1])
        moved = new.step(batches[1])
        assert moved["loss"] != first["loss"]
        np.testing.assert_allclose(moved["loss"], stay["loss"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(moved["grad_norm"], stay["grad_norm"], rtol=1e-4, atol=1e-6)
        after = {n: t for n, t in new.gather_params().items()}
        for name, t in old.gather_params().items():
            np.testing.assert_allclose(after[name].numpy(), t.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    finally:
        old_mesh.close()
        if new_mesh is not None:
            new_mesh.close()
