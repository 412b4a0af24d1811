"""The port's MoE LM family (``repro_torch.models``, MoE blocks in the
transformer) against the JAX package's, on the reduced float32 configs of
moonshot-v1-16b-a3b and mixtral-8x22b with the same weights, carried over by
``lm_params_from_numpy``: parameter shapes, forward, prefill and
teacher-forced decode under both attention backends; and the full-width
moonshot config pinned from the config alone."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models.layers as JL
import repro.models.transformer as JT
import repro_torch.configs as TC
import repro_torch.models.layers as TL
import repro_torch.models.transformer as TT
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import api

ARCHS = ["moonshot-v1-16b-a3b", "mixtral-8x22b"]  # 4 experts top-2 reduced; mixtral with SWA
IMPLS = ["reference", "flash"]
TOL = dict(rtol=1e-4, atol=1e-4)  # float32 sums in another order, over 2 layers


def reduced(arch: str, impl: str = "reference"):
    return (dataclasses.replace(JC.reduced_config(arch), attn_impl=impl),
            dataclasses.replace(TC.reduced_config(arch), attn_impl=impl))


def both_models(arch: str, impl: str = "reference", seed: int = 0):
    """(jax cfg, jax params, port cfg, port model) holding the same weights;
    the norm weights (ones at init) redrawn so that the comparison sees them."""
    jcfg, tcfg = reduced(arch, impl)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), JT.init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    for p in (tree["blocks"]["ln1"], tree["blocks"]["ln2"], tree["final_norm"]):
        p["w"] = (1 + 0.1 * rng.standard_normal(p["w"].shape)).astype(np.float32)
    model = TT.Transformer(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(tcfg, tree, device="cpu"))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, model


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, s))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_reference_tree(arch):
    jcfg, tcfg = reduced(arch)
    tree = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = api.init_params(tcfg, seed=0, device="cpu")
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] == "blocks":  # stacked (L, ...) -> one entry a layer
            for i in range(tcfg.num_layers):
                want[".".join(["blocks", str(i), *keys[1:]])] = (leaf.shape[1:], str(leaf.dtype))
        else:
            want[".".join(keys)] = (leaf.shape, str(leaf.dtype))
    got = {name: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for name, t in model.state_dict().items()}
    assert got == want
    assert model.blocks[0].moe.router.dtype == torch.float32
    # a bf16 config keeps the router in float32 through the conversion
    bf16 = dataclasses.replace(tcfg, dtype="bfloat16")
    sd = lm_params_from_numpy(bf16, jax.tree.map(np.asarray, tree), device="cpu")
    assert sd["blocks.1.moe.router"].dtype == torch.float32
    assert sd["blocks.1.moe.w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch):
    jcfg, jparams, tcfg, model = both_models(arch)
    toks = _tokens(tcfg, 2, 20, 6)
    want = JT.forward(JL.Ctx(jcfg), jparams, jnp.asarray(toks))
    with torch.no_grad():
        got = TT.forward(TL.Ctx(tcfg), model, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match(arch, impl):
    jcfg, jparams, tcfg, model = both_models(arch, impl)
    jctx, tctx = JL.Ctx(jcfg), TL.Ctx(tcfg)
    prompt, max_len = _tokens(tcfg, 2, 40, 7), 48
    wl, wc = jax.jit(lambda p, t: JT.prefill(jctx, p, t, max_len))(jparams, jnp.asarray(prompt))
    gl, gc = api.prefill(tctx, model, torch.from_numpy(prompt), max_len)
    np.testing.assert_allclose(_np(gl), _np(wl), **TOL)
    assert gc.length == int(wc.length) == 40 and gc.k.shape == wc.k.shape
    np.testing.assert_allclose(_np(gc.k), _np(wc.k), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(gc.v), _np(wc.v), rtol=1e-5, atol=1e-5)

    # four teacher-forced decode steps: the same token into both caches
    jdecode = jax.jit(lambda p, t, c: JT.decode_step(jctx, p, t, c))
    for step, tok in enumerate(_tokens(tcfg, 4, 2, 8)):
        tok = tok[:, None]
        wl, wc = jdecode(jparams, jnp.asarray(tok, jnp.int32), wc)
        gl, gc = api.decode_step(tctx, model, torch.from_numpy(tok), gc)
        np.testing.assert_allclose(_np(gl), _np(wl), **TOL, err_msg=f"decode step {step}")
        assert gc.length == int(wc.length) == 41 + step


def test_moe_family_is_served():
    """The MoE family runs through the family API (it raised before its
    port) and the full serve loop, on the CPU."""
    from repro_torch.launch.serve import lm_serve

    tcfg = TC.reduced_config("moonshot-v1-16b-a3b")
    assert api.module_for(tcfg) is TT
    model = api.init_params(tcfg, seed=0, device="cpu")
    res = lm_serve(tcfg, model, _tokens(tcfg, 2, 12, 3), 4, device="cpu")
    assert tuple(res.tokens.shape) == (2, 4)
    assert bool(((res.tokens >= 0) & (res.tokens < tcfg.vocab_size)).all())


def test_moonshot_full_width_shapes():
    cfg = TC.get_config("moonshot-v1-16b-a3b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.num_experts,
            cfg.experts_per_token, cfg.moe_d_ff, cfg.vocab_size, cfg.dtype) == (
        48, 2048, 16, 16, 128, 64, 6, 1408, 163840, "bfloat16")
    # about 28.06e9 weights with the embedding and head (56.1 GB in bf16):
    # 48 layers of 570.6e6 and two 335.5e6 tables
    per_layer = cfg.param_count // cfg.num_layers
    assert 570.5e6 < per_layer < 570.7e6
    total = cfg.param_count + 2 * cfg.vocab_size * cfg.d_model
    assert 28.05e9 < total < 28.07e9
