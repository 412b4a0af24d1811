"""The port's Whisper (``repro_torch.models.whisper``, the ``encdec``
family) against the JAX package's on the reduced config of whisper-small
(2 encoder and 2 decoder layers, 16 frames), in float32 and bf16, under
both attention backends: parameters, encoder, forward, prefill with its
self and cross caches, decode from the port's caches and the reference's,
loss and grads, serving; and where the flash kernel is called (the
encoder, the decoder's self and cross attention at prefill, the cached
cross attention at every decode step)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
import repro.models.whisper as JW
import repro_torch.configs as TC
import repro_torch.models.layers as TL
import repro_torch.models.whisper as TW
from repro_torch.launch.serve import lm_serve, stub_inputs
from repro_torch.models import api
from torch_lm_families import (
    assert_close, both_models, check_cli, check_forward, check_loss_and_grads, check_param_layout,
    check_prefill_decode, check_serve, check_train_cli, tokens,
)

ARCH = "whisper-small"
DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_param_layout_matches_reference_tree(dtype):
    check_param_layout(ARCH, dtype)


# the frequencies are float32 exps, which may round an ulp apart between
# the two libraries (6e-8 relative), and the angle multiplies that by the
# position: seen 3.0e-5 at 447 (the decoder's last position), 3.9e-3 at 65533
@pytest.mark.parametrize("start", [0, 447, 65533])
def test_sinusoidal_matches(start):
    want = JL.sinusoidal(start + 3, 768, jnp.float32)[start:]
    got = TL.sinusoidal(3, 768, torch.float32, start=start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6 + 1e-7 * (start + 3))
    assert TL.sinusoidal(5, 64, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_encoder_and_cross_attention_match(impl):
    jctx, jp, tctx, model = both_models(ARCH, impl)
    frames = stub_inputs(tctx.cfg, 2, 3)["frames"]
    want = JW.encode(jctx, jp, jnp.asarray(frames))
    with torch.no_grad():
        got = TW.encode(tctx, model, torch.as_tensor(frames))
        assert_close(got, want, "float32", "encoder states")
        x = np.random.default_rng(4).standard_normal((2, 5, tctx.cfg.d_model)).astype(np.float32)
        xp = {k: jnp.asarray(v[0]) for k, v in jp["dec_blocks"]["xattn"].items()}
        wo, (wk, wv) = JL.attn_sublayer(jctx, xp, jnp.asarray(x), xkv=want, use_rope=False)
        go, (gk, gv) = TL.attn_sublayer(tctx, model.dec_blocks[0].xattn, torch.as_tensor(x), xkv=got,
                                        use_rope=False)
    for g, w, what in ((go, wo, "cross-attention out"), (gk, wk, "k"), (gv, wv, "v")):
        assert_close(g, w, "float32", what)
    assert gk.shape[1] == tctx.cfg.encoder_frames


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_logits_match(dtype):
    check_forward(ARCH, dtype)


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_caches_and_decode_match(dtype, impl):
    check_prefill_decode(ARCH, impl, dtype)


def test_loss_and_grads_match():
    check_loss_and_grads(ARCH, remat=True)


def test_lm_serve_matches_reference_loop():
    check_serve(ARCH, "flash")


def test_serve_cli(capsys):
    check_cli(ARCH, capsys)


def test_flash_calls_at_prefill_and_decode(monkeypatch):
    """On the plain path: encoder_layers + 2 num_layers flash calls a
    prefill (encoder; decoder self and cross), num_layers a decode step
    (the cached cross attention, q of one row over every frame; the self
    attention over the cache takes the dense branch)."""
    cfg = TC.reduced_config(ARCH)
    calls = []
    flash = TL.flash_attention

    def counting(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2], kw["causal"]))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(TL, "flash_attention", counting)
    _, _, tctx, model = both_models(ARCH, "flash")
    prompts, gen = tokens(cfg, 2, 7, 1), 4
    lm_serve(tctx.cfg, model, prompts, gen, device="cpu", batch=stub_inputs(cfg, 2, 2))
    n_pre = cfg.encoder_layers + 2 * cfg.num_layers
    assert len(calls) == n_pre + (gen - 1) * cfg.num_layers
    f = cfg.encoder_frames
    assert calls[:n_pre] == ([(f, f, False)] * cfg.encoder_layers
                             + [(7, 7, True), (7, f, False)] * cfg.num_layers)
    assert set(calls[n_pre:]) == {(1, f, False)}


def test_caches_have_the_frames_and_the_decoder_length():
    cfg = TC.reduced_config(ARCH)
    caches = api.init_decode_state(cfg, 3, 40, device="cpu")
    assert isinstance(caches, TW.WhisperCaches) and caches.length == 0
    assert caches.self_k.shape == (2, 3, 40, cfg.num_kv_heads, cfg.hd)
    assert caches.cross_k.shape == (2, 3, cfg.encoder_frames, cfg.num_kv_heads, cfg.hd)


def test_train_cli(tmp_path, capsys, monkeypatch):
    check_train_cli(ARCH, tmp_path, capsys, monkeypatch)
