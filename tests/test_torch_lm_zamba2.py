"""The port's Zamba2 (``repro_torch.models.zamba2`` over ``mamba2``, the
``hybrid`` family) against the JAX package's on the reduced config of
zamba2-2.7b (4 Mamba layers, the shared attention block after every 2,
chunks of 16), in float32 and bf16, under both attention backends:
parameters, forward, prefill and every cache, decode from the port's caches
and the reference's, loss and grads, serving; and the reference's
non-finite Mamba-2 gradients at a 256-token chunk, which the port does not
copy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models.api as JAPI
import repro_torch.configs as TC
import repro_torch.models.zamba2 as TZ
from repro.models.layers import Ctx as JCtx
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import Ctx, api
from torch_lm_families import (
    assert_grads_close, check_chunked_vs_stepwise, check_cli, check_forward, check_loss_and_grads,
    check_param_layout, check_prefill_decode, check_serve, port_grads,
)

ARCH = "zamba2-2.7b"
DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_param_layout_matches_reference_tree(dtype):
    check_param_layout(ARCH, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_logits_match(dtype):
    check_forward(ARCH, dtype)


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_caches_and_decode_match(dtype, impl):
    check_prefill_decode(ARCH, impl, dtype)


def test_loss_and_grads_match():
    check_loss_and_grads(ARCH, remat=True)


@pytest.mark.parametrize("s", [37, 6])
def test_chunked_prefill_equals_stepwise_decode(s):
    check_chunked_vs_stepwise(ARCH, s, "flash")


def test_lm_serve_matches_reference_loop():
    check_serve(ARCH, "flash")


def test_serve_cli(capsys):
    check_cli(ARCH, capsys)


def test_one_shared_block_and_a_cache_a_point():
    cfg = TC.reduced_config(ARCH)
    model = api.init_params(cfg, device="cpu")
    assert len(model.blocks) == 4 and not hasattr(model.blocks[0], "attn")
    caches = api.init_decode_state(cfg, 2, 24, device="cpu")
    assert isinstance(caches, TZ.ZambaCaches)
    assert caches.attn_k.shape == (2, 2, 24, cfg.num_kv_heads, cfg.hd)  # 4 layers / period 2
    assert caches.mamba_h.shape == (4, 2, 4, 16, 64) and caches.mamba_h.dtype == torch.float32
    assert caches.mamba_conv.shape == (4, 2, 3, 2 * 128 + 2 * 16)
    with pytest.raises(ValueError, match="groups"):
        api.init_params(dataclasses.replace(cfg, shared_attn_period=3), device="cpu")


# The reference's mamba2_sublayer takes exp of the decay ratio L_t - L_i
# above the diagonal, then zeroes it (jnp.where): at a 256-token chunk and
# dt near softplus(0) = 0.69 a token, the ratio reaches about 177 and exp
# overflows float32; the forward is finite, its backward multiplies 0 by
# inf. The chunked scan is exact for any chunk, so the port's gradients at
# chunk 256 are held against both packages' at chunk 16 (GRAD_RTOL)
def test_reference_mamba2_grads_overflow_at_chunk_256_and_the_port_s_do_not():
    tok = np.random.default_rng(1).integers(1, 512, (1, 257)).astype(np.int32)  # one 256-token chunk
    grads = {}
    for chunk in (256, 16):
        jcfg = dataclasses.replace(JC.reduced_config(ARCH), ssm_chunk=chunk)
        tcfg = dataclasses.replace(TC.reduced_config(ARCH), ssm_chunk=chunk)
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            JAPI.init_params(jcfg, jax.random.PRNGKey(0)))
        jl, jg = jax.value_and_grad(lambda p: JAPI.loss_fn(JCtx(jcfg), p, {"tokens": jnp.asarray(tok)}))(
            jax.tree.map(jnp.asarray, tree))
        model = api.init_params(tcfg, device="cpu")
        model.load_state_dict(lm_params_from_numpy(tcfg, tree, device="cpu"))
        tl, tg = port_grads(Ctx(tcfg), model, {"tokens": torch.as_tensor(tok)})
        grads[chunk] = (float(jl), jg, tl, tg)
    jl256, jg256, tl256, tg256 = grads[256]
    jl16, jg16, tl16, tg16 = grads[16]
    assert np.isfinite(jl256) and np.isfinite(tl256)
    non_finite = [jax.tree_util.keystr(p) for p, g in jax.tree_util.tree_flatten_with_path(jg256)[0]
                  if not np.isfinite(np.asarray(g)).all()]
    assert "['blocks']['mamba']['a_log']" in non_finite and len(non_finite) >= 10
    np.testing.assert_allclose([tl256, tl16], jl16, rtol=1e-5)
    assert_grads_close(tg256, jg16, "port at chunk 256 vs reference at chunk 16: ")
    assert_grads_close(tg16, jg16, "port at chunk 16 vs reference at chunk 16: ")
