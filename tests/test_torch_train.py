"""The port's training path (``repro_torch.models``: ``loss_fn`` with remat
and the chunked cross-entropy, ``api.train_step``) against the JAX
package's on the CPU, with the same weights carried across by
``convert.lm_params_from_numpy``, on the reduced float32 configs of
llama3.2-3b, qwen2-7b (qkv bias), moonshot-v1-16b-a3b and mixtral-8x22b
(MoE; mixtral with a sliding window)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.data as JD
import repro.models.api as JAPI
import repro.models.losses as JLoss
import repro.models.transformer as JT
import repro.optim as JO
from repro.models.layers import Ctx as JCtx
import repro_torch.configs as TC
import repro_torch.data as TD
import repro_torch.models.layers as TL
import repro_torch.models.losses as TLoss
import repro_torch.optim as TO
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy, opt_state_from_numpy
from repro_torch.models import Ctx, api

ARCHS = ["llama3.2-3b", "qwen2-7b", "moonshot-v1-16b-a3b", "mixtral-8x22b"]
LOSS_RTOL = 1e-5  # float32 sums in another order, over 2 layers and a 512-word vocab
# grads: the same float32 sums in other orders; the backward of the row
# gathers (embedding, MoE capacity buffers) is an accumulating index put,
# in slot order on the CPU (with float atomics in no fixed order on the card)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def both_models(arch: str, seed: int = 0, **upd):
    """(jax cfg, jax params, port cfg, port model) with the same weights,
    the norm weights (ones at init) redrawn so that their gradients matter."""
    jcfg = dataclasses.replace(JC.reduced_config(arch), **upd)
    tcfg = dataclasses.replace(TC.reduced_config(arch), **upd)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), JT.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    for p in (tree["blocks"]["ln1"], tree["blocks"]["ln2"], tree["final_norm"]):
        p["w"] = (1 + 0.1 * rng.standard_normal(p["w"].shape)).astype(np.float32)
    model = api.init_params(tcfg, seed=0, device="cpu")
    model.load_state_dict(lm_params_from_numpy(tcfg, tree, device="cpu"))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, model


def _tokens(vocab: int, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, vocab, (b, s + 1)).astype(np.int32)


def port_grads(ctx, model, batch) -> tuple[float, dict]:
    named = dict(model.named_parameters())
    loss = api.loss_fn(ctx, model, batch)
    return float(loss), lm_params_to_numpy(dict(zip(named, torch.autograd.grad(loss, list(named.values())))))


def assert_trees_close(got, want, **tol):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0])
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(g, flat_w[path], err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("s,chunk", [(37, 16), (48, 16), (20, 512)])
def test_chunked_cross_entropy_and_grad_match_reference(s, chunk):
    rng = np.random.default_rng(s)
    b, d, v = 3, 16, 50
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[0, -5:] = -1  # pads, also in the last (padded) chunk
    labels[2, :3] = -1
    ctx = JCtx(JC.reduced_config("llama3.2-3b"))
    jl, (jgx, jgw) = jax.value_and_grad(
        lambda x, w: JLoss.chunked_cross_entropy(ctx, x, w, jnp.asarray(labels), chunk=chunk),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    tl = TLoss.chunked_cross_entropy(Ctx(TC.reduced_config("llama3.2-3b")), tx, tw,
                                     torch.as_tensor(labels), chunk=chunk)
    tl.backward()
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-5, atol=1e-5)


def test_chunked_cross_entropy_all_pad_is_zero():
    x = torch.randn(2, 8, 4, requires_grad=True)
    loss = TLoss.chunked_cross_entropy(None, x, torch.randn(4, 10), torch.full((2, 8), -1), chunk=4)
    loss.backward()
    assert float(loss) == 0.0 and float(x.grad.abs().max()) == 0.0


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grad_match_reference(arch, remat):
    jcfg, jparams, tcfg, model = both_models(arch, remat=remat)
    toks = _tokens(jcfg.vocab_size, 2, 48, seed=1)
    jl, jg = jax.value_and_grad(lambda p: JT.loss_fn(JCtx(jcfg), p, {"tokens": jnp.asarray(toks)}))(jparams)
    tl, tg = port_grads(Ctx(tcfg), model, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tl, float(jl), rtol=LOSS_RTOL)
    assert_trees_close(tg, jg, **GRAD_TOL)


def test_remat_keeps_fewer_activations_and_the_same_grads():
    """Under remat only each block's input (and the chunked loss's inputs)
    are kept for backward; the grads do not change."""
    _, _, tcfg, model = both_models("llama3.2-3b")
    batch = {"tokens": torch.as_tensor(_tokens(tcfg.vocab_size, 2, 64, seed=2))}
    saved, grads = {}, {}
    for remat in (False, True):
        ctx = Ctx(dataclasses.replace(tcfg, remat=remat))
        nbytes = []

        def pack(t):
            nbytes.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = api.loss_fn(ctx, model, batch)
        saved[remat] = sum(nbytes)
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()))
    assert saved[True] < saved[False] / 2, saved
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_q_chunked_attention_checkpoints_each_tile_and_matches_dense(monkeypatch):
    """A small score budget forces the q-chunked branch (2 tiles of 128
    queries); under grad each tile runs under its own checkpoint, and the
    grads equal the dense branch's."""
    _, _, tcfg, model = both_models("llama3.2-3b")
    batch = {"tokens": torch.as_tensor(_tokens(tcfg.vocab_size, 2, 256, seed=3))}
    ctx = Ctx(tcfg)
    dense_loss, dense = port_grads(ctx, model, batch)

    tiles = []
    checkpoint = TL.checkpoint

    def counting(fn, *args, **kw):
        tiles.append(fn.__name__)
        return checkpoint(fn, *args, **kw)

    monkeypatch.setattr(TL, "_SCORE_BYTE_BUDGET", 1 << 18)
    monkeypatch.setattr(TL, "checkpoint", counting)
    chunked_loss, chunked = port_grads(ctx, model, batch)
    assert tiles.count("tile") == 2 * tcfg.num_layers
    np.testing.assert_allclose(chunked_loss, dense_loss, rtol=1e-6)
    assert_trees_close(chunked, dense, rtol=1e-5, atol=1e-7)
    with torch.no_grad():  # no checkpoint without grad
        tiles.clear()
        api.loss_fn(ctx, model, batch)
        assert tiles == []


def test_flash_under_grad_raises_instead_of_dropping_gradients():
    _, _, tcfg, model = both_models("llama3.2-3b", attn_impl="flash")
    batch = {"tokens": torch.as_tensor(_tokens(tcfg.vocab_size, 2, 32, seed=4))}
    ctx = Ctx(tcfg)
    with pytest.raises(RuntimeError, match="no backward"):
        api.loss_fn(ctx, model, batch)
    opt_cfg = TO.AdamWConfig()
    with pytest.raises(RuntimeError, match="no backward"):
        api.train_step(ctx, model, api.init_opt(tcfg, model, opt_cfg), batch, opt_cfg)
    with torch.no_grad():  # scoring without grad still takes the kernel
        flash = float(api.loss_fn(ctx, model, batch))
        ref = float(api.loss_fn(Ctx(dataclasses.replace(tcfg, attn_impl="reference")), model, batch))
    np.testing.assert_allclose(flash, ref, rtol=1e-5)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "moonshot-v1-16b-a3b"])
def test_train_step_matches_reference(arch, microbatches):
    """One step from the same weights and the same moments (at step 3, both
    carried across): the moments keep the update linear in the grads. From
    zero moments the first update is about lr * sign(g), which a grad near
    eps within the grads' tolerance can move by a share of lr."""
    jcfg, jparams, tcfg, model = both_models(arch)
    rng = np.random.default_rng(7)
    state = {"step": np.int32(3), "ef_residual": None,
             "mu": jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32), jparams),
             "nu": jax.tree.map(lambda a: (np.abs(rng.standard_normal(a.shape)) * 1e-6 + 1e-7)
                                .astype(np.float32), jparams)}
    toks = _tokens(jcfg.vocab_size, 4, 32, seed=5)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jo = JO.AdamWConfig(**kw)
    jstate = JO.AdamWState(**{k: jax.tree.map(jnp.asarray, v) for k, v in state.items()})
    jp, js, jm = JAPI.train_step(JCtx(jcfg), jparams, jstate, {"tokens": jnp.asarray(toks)},
                                 jo, microbatches=microbatches)
    to = TO.AdamWConfig(**kw)
    _, ts, tm = api.train_step(Ctx(tcfg), model, opt_state_from_numpy(tcfg, state, device="cpu"),
                               {"tokens": torch.as_tensor(toks)}, to, microbatches=microbatches)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert ts.step == int(js.step) == 4
    assert_trees_close(lm_params_to_numpy(model), jp, rtol=1e-5, atol=1e-7)
    assert_trees_close(lm_params_to_numpy(ts.mu), js.mu, **GRAD_TOL)
    assert_trees_close(lm_params_to_numpy(ts.nu), js.nu, rtol=1e-4, atol=1e-9)


def test_train_step_microbatches_match_one_batch():
    _, _, tcfg, model = both_models("llama3.2-3b")
    batch = {"tokens": torch.as_tensor(_tokens(tcfg.vocab_size, 4, 32, seed=6))}
    opt_cfg = TO.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10, clip_norm=None)
    out = {}
    for m in (1, 4):
        model_m = api.init_params(tcfg, seed=0, device="cpu")
        model_m.load_state_dict(model.state_dict())
        _, state, metrics = api.train_step(Ctx(tcfg), model_m, api.init_opt(tcfg, model_m, opt_cfg), batch,
                                           opt_cfg, microbatches=m)
        out[m] = (float(metrics["loss"]), state.mu)
    np.testing.assert_allclose(out[4][0], out[1][0], rtol=1e-6)
    for n in out[1][1]:
        torch.testing.assert_close(out[4][1][n], out[1][1][n], rtol=1e-4, atol=1e-9)
    with pytest.raises(ValueError):
        api.train_step(Ctx(tcfg), model, api.init_opt(tcfg, model, opt_cfg), batch, opt_cfg, microbatches=3)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mixtral-8x22b"])
def test_ten_step_loss_trajectory_matches_reference(arch):
    jcfg, jparams, tcfg, model = both_models(arch, seed=1)
    data_kw = dict(vocab_size=jcfg.vocab_size, seq_len=64, global_batch=2)
    jdata, tdata = JD.SyntheticTokens(JD.DataConfig(**data_kw)), TD.SyntheticTokens(TD.DataConfig(**data_kw))
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    jo, to = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jstep = jax.jit(lambda p, o, b: JAPI.train_step(JCtx(jcfg), p, o, b, jo))
    jstate, tstate = JO.init(jparams, jo), api.init_opt(tcfg, model, to)
    jl, tl = [], []
    for step in range(10):
        jparams, jstate, jm = jstep(jparams, jstate, jdata.jax_batch(step))
        _, tstate, tm = api.train_step(Ctx(tcfg), model, tstate, tdata.torch_batch(step, "cpu"), to)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
