"""The port's dense LM (``repro_torch.models``) against the JAX package's,
on reduced float32 configs with the same weights, carried over by
``lm_params_from_numpy``: configs, layers, forward, prefill under both
attention backends, teacher-forced decode, and the q-chunked branch."""
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
from repro_torch.convert import decode_state_from_numpy, lm_params_from_numpy
from repro_torch.models import api

ARCHS = ["llama3.2-3b", "qwen2-7b", "glm4-9b"]  # plain GQA, qkv_bias, rope_fraction=0.5
IMPLS = ["reference", "flash"]
TOL = dict(rtol=1e-4, atol=1e-4)  # float32 sums in another order, over 2 layers


def reduced(arch: str, impl: str = "reference"):
    """(JAX config, port config) of the reduced arch under ``impl``."""
    return (dataclasses.replace(JC.reduced_config(arch), attn_impl=impl),
            dataclasses.replace(TC.reduced_config(arch), attn_impl=impl))


def jax_params_numpy(cfg, seed: int = 0) -> dict:
    """The JAX package's init_params tree as numpy, with the norm weights and
    biases (ones and zeros at init) redrawn so that the comparison sees them."""
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), JT.init_params(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    for p in (tree["blocks"]["ln1"], tree["blocks"]["ln2"], tree["final_norm"]):
        p["w"] = (1 + 0.1 * rng.standard_normal(p["w"].shape)).astype(np.float32)
    for name in ("bq", "bk", "bv"):
        if name in tree["blocks"]["attn"]:
            a = tree["blocks"]["attn"][name]
            tree["blocks"]["attn"][name] = (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return tree


def both_models(arch: str, impl: str = "reference", seed: int = 0):
    """(jax cfg, jax params, port cfg, port model) holding the same weights."""
    jcfg, tcfg = reduced(arch, impl)
    tree = jax_params_numpy(jcfg, seed)
    model = TT.Transformer(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(tcfg, tree, device="cpu"))
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, model


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# -- configs ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted([*JC.ARCHS, *JC.AUX_CONFIGS]))
def test_configs_identical(arch):
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.hd, tcfg.param_count, tcfg.active_param_count) == (
        jcfg.hd, jcfg.param_count, jcfg.active_param_count)
    if arch in JC.ARCHS:
        assert dataclasses.asdict(TC.reduced_config(arch)) == dataclasses.asdict(JC.reduced_config(arch))
    assert sorted(TC.ARCHS) == sorted(JC.ARCHS)


@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_every_family_builds_through_the_api(arch):
    """Every config's family has a module (the families past dense and MoE
    raised NotImplementedError before their port)."""
    cfg = TC.reduced_config(arch)
    module = api.module_for(cfg)
    assert module.__name__.rsplit(".", 1)[-1] == {
        "dense": "transformer", "moe": "transformer", "vlm": "transformer", "ssm": "rwkv6",
        "hybrid": "zamba2", "encdec": "whisper"}[TC.get_config(arch).family]
    model = api.init_params(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) > 0


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b", "whisper-small", "phi-3-vision-4.2b"])
def test_family_entry_points_ask_for_the_card_by_default(arch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.convert import decode_state_from_numpy, lm_params_from_numpy
    from repro_torch.launch.serve import lm_serve

    cfg = TC.reduced_config(arch)
    model = api.init_params(cfg, device="cpu")
    for call in (lambda: api.init_params(cfg), lambda: api.init_decode_state(cfg, 1, 8),
                 lambda: lm_params_from_numpy(cfg, {}),
                 lambda: decode_state_from_numpy(cfg, api.init_decode_state(cfg, 1, 8, device="cpu")),
                 lambda: lm_serve(cfg, model, np.ones((1, 4)), 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_init_decode_state_matches_jax_caches():
    jcfg, tcfg = reduced("glm4-9b")
    want = JT.init_caches(jcfg, 3, 20)
    got = api.init_decode_state(tcfg, 3, 20, device="cpu")
    assert got.k.shape == want.k.shape and got.v.shape == want.v.shape
    assert got.k.dtype == torch.float32 and got.length == int(want.length) == 0
    assert not got.k.any() and not got.v.any()


def test_llama_full_width_shapes():
    cfg = TC.get_config("llama3.2-3b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.d_ff,
            cfg.vocab_size, cfg.dtype, cfg.rope_theta) == (
        28, 3072, 24, 8, 128, 8192, 128256, "bfloat16", 5e5)
    # about 3.6e9 weights with the embedding and head (7.2 GB in bf16)
    assert 3.5e9 < cfg.param_count + 2 * cfg.vocab_size * cfg.d_model < 3.7e9


# -- layers ----------------------------------------------------------------------


def test_rmsnorm_and_layernorm_match():
    rng = np.random.default_rng(0)
    x, w, b = (rng.standard_normal(s).astype(np.float32) for s in ((2, 5, 64), (64,), (64,)))
    np.testing.assert_allclose(_np(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)),
                               _np(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _np(TL.layernorm(*map(torch.from_numpy, (x, w, b)), 1e-5)),
        _np(JL.layernorm(*map(jnp.asarray, (x, w, b)), 1e-5)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("batched_pos", [False, True])
def test_rope_matches(fraction, batched_pos):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = np.arange(9) + 40
    if batched_pos:
        pos = np.stack([pos, pos + 7])
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5, fraction)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 5e5, fraction)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def _layer0(tree, model):
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"]["attn"])
    return jp, model.blocks[0].attn


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
@torch.no_grad()  # the layer's weights require grad, and flash under grad raises
def test_attn_sublayer_matches(arch, impl):
    jcfg, tcfg = reduced(arch, impl)
    tree = jax_params_numpy(jcfg)
    model = TT.Transformer(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(tcfg, tree, device="cpu"))
    jp, tp = _layer0(tree, model)
    x = np.random.default_rng(2).standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    want, (wk, wv) = JL.attn_sublayer(JL.Ctx(jcfg), jp, jnp.asarray(x), pos_offset=3)
    got, (gk, gv) = TL.attn_sublayer(TL.Ctx(tcfg), tp, torch.from_numpy(x), pos_offset=3)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5)

    # cache decode: two new tokens after 24 cached ones, in a cache of 32
    ck = np.random.default_rng(3).standard_normal((2, 32, tcfg.num_kv_heads, tcfg.hd)).astype(np.float32)
    cv = np.random.default_rng(4).standard_normal(ck.shape).astype(np.float32)
    xn = x[:, :2]
    want, (wk, wv) = JL.attn_sublayer(JL.Ctx(jcfg), jp, jnp.asarray(xn), pos_offset=24,
                                      cache=(jnp.asarray(ck), jnp.asarray(cv)), cache_len=jnp.int32(24))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, (gk, gv) = TL.attn_sublayer(TL.Ctx(tcfg), tp, torch.from_numpy(xn), pos_offset=24,
                                     cache=(tk, tv), cache_len=24)
    assert gk is tk and gv is tv  # written in place
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-5)


def test_mlp_sublayer_matches_swiglu_and_gelu():
    for arch in ("llama3.2-3b", "whisper-small"):  # swiglu, gelu (tanh approximation)
        jcfg, tcfg = reduced(arch)
        jp = JL.mlp_params(jcfg, jax.random.PRNGKey(0))
        tp = TL.MLP(tcfg, torch.Generator().manual_seed(0), "cpu")
        tp.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in jp.items()})
        x = np.random.default_rng(5).standard_normal((2, 6, tcfg.d_model)).astype(np.float32)
        np.testing.assert_allclose(_np(TL.mlp_sublayer(TL.Ctx(tcfg), tp, torch.from_numpy(x))),
                                   _np(JL.mlp_sublayer(JL.Ctx(jcfg), jp, jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)


# -- the model -------------------------------------------------------------------


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, s))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch):
    jcfg, jparams, tcfg, model = both_models(arch)
    toks = _tokens(tcfg, 2, 20, 6)
    want = JT.forward(JL.Ctx(jcfg), jparams, jnp.asarray(toks))
    got = TT.forward(TL.Ctx(tcfg), model, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(model(torch.from_numpy(toks))), _np(got), rtol=0, atol=0)


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
        assert torch.equal(gl[:, -1].argmax(-1), torch.from_numpy(np.asarray(wl[:, -1].argmax(-1))).long())
        assert gc.length == int(wc.length) == 41 + step
    np.testing.assert_allclose(_np(gc.k), _np(wc.k), rtol=1e-5, atol=1e-5)


def test_decode_from_converted_jax_caches():
    jcfg, jparams, tcfg, model = both_models("qwen2-7b")
    prompt = _tokens(tcfg, 2, 12, 9)
    _, wc = JT.prefill(JL.Ctx(jcfg), jparams, jnp.asarray(prompt), 16)
    caches = decode_state_from_numpy(tcfg, {"k": np.asarray(wc.k), "v": np.asarray(wc.v), "length": wc.length},
                                     device="cpu")
    tok = _tokens(tcfg, 2, 1, 10)
    wl, _ = JT.decode_step(JL.Ctx(jcfg), jparams, jnp.asarray(tok, jnp.int32), wc)
    gl, gc = api.decode_step(TL.Ctx(tcfg), model, torch.from_numpy(tok), caches)
    np.testing.assert_allclose(_np(gl), _np(wl), **TOL)
    assert gc.length == 13


@pytest.mark.parametrize("impl", IMPLS)
def test_chunked_attend_matches(monkeypatch, impl):
    """A budget small enough to cut a 256-token prompt into two 128-query
    tiles, set in both packages (the flash branch ignores it)."""
    budget = 2 * 4 * 128 * 256 * 4
    monkeypatch.setattr(JL, "_SCORE_BYTE_BUDGET", budget)
    monkeypatch.setattr(TL, "_SCORE_BYTE_BUDGET", budget)
    jcfg, tcfg = reduced("llama3.2-3b", impl)
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 256, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 256, 2, 32)).astype(np.float32) for _ in "kv")
    want = JL._attend(JL.Ctx(jcfg), *map(jnp.asarray, (q, k, v)), causal=True, window=None)
    got = TL._attend(TL.Ctx(tcfg), *map(torch.from_numpy, (q, k, v)), causal=True, window=None)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    unchunked = TL._attend_dense(*map(torch.from_numpy, (q, k, v)), causal=True, window=None,
                                 scale=32 ** -0.5, q_offset=0, sq_total=256, kv_valid_len=None)
    np.testing.assert_allclose(_np(got), _np(unchunked), rtol=1e-5, atol=1e-6)

    _, jparams, _, model = both_models("llama3.2-3b", impl)
    prompt = _tokens(tcfg, 2, 256, 12)
    wl, _ = jax.jit(lambda p, t: JT.prefill(JL.Ctx(jcfg), p, t, 256))(jparams, jnp.asarray(prompt))
    gl, _ = api.prefill(TL.Ctx(tcfg), model, torch.from_numpy(prompt), 256)
    np.testing.assert_allclose(_np(gl), _np(wl), **TOL)
