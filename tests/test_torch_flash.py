"""The port's flash attention (its plain blockwise version, on the CPU)
against the JAX package's (the Pallas kernel in interpret mode), on the same
numpy inputs. The kernel itself is held against the plain version on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_reference as jax_reference
from repro_torch.kernels.flash_attention.kernel import (
    KERNEL_BLOCK_K, flash_attention_plain, flash_attn,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_reference

F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16: both versions round p to bf16 at the same k blocks and the output to
# bf16, so they differ where a float32 sum in another order lands on the
# other side of a rounding boundary: one bf16 ulp (2**-8 relative)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def _qkv(rng, b, hq, hkv, sq, skv, d):
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


def _both(arrays, dtype):
    """The same arrays as JAX and torch inputs of ``dtype`` (both round to
    bf16 to nearest even)."""
    jax_in = [jnp.asarray(a).astype(dtype) for a in arrays]
    torch_in = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jax_in, torch_in


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# the parametrize list of tests/test_kernels_flash.py
CASES = [
    (2, 4, 2, 64, 64, 32, True, None),    # GQA causal
    (1, 8, 8, 128, 128, 64, True, None),  # MHA
    (1, 8, 1, 64, 64, 32, True, None),    # MQA
    (1, 4, 4, 64, 192, 32, True, None),   # q tail of longer kv (chunked decode)
    (2, 4, 2, 96, 96, 32, True, 48),      # sliding window (Mixtral SWA)
    (1, 2, 1, 64, 64, 32, False, None),   # non-causal (encoder / cross-attn)
    (1, 2, 2, 100, 100, 32, True, None),  # non-block-multiple seq (padding)
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", CASES)
def test_flash_matches_jax(b, hq, hkv, sq, skv, d, causal, window):
    arrays = _qkv(np.random.default_rng(b * sq + skv), b, hq, hkv, sq, skv, d)
    (jq, jk, jv), (q, k, v) = _both(arrays, "float32")
    want = jax_flash(jq, jk, jv, causal=causal, window=window, block_q=32, block_k=32)
    got = flash_attention(q, k, v, causal=causal, window=window, block_k=32)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    ref = attention_reference(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(_np(ref), _np(jax_reference(jq, jk, jv, causal=causal, window=window)),
                               **F32_TOL)
    np.testing.assert_allclose(_np(flash_attention(q, k, v, causal=causal, window=window,
                                                   use_kernel=False)), _np(ref), rtol=0, atol=0)


@pytest.mark.parametrize("bq,bk", [(32, 32), (64, 32), (32, 64), (128, 128)])
def test_flash_block_size_invariance(bq, bk):
    arrays = _qkv(np.random.default_rng(7), 1, 4, 2, 128, 128, 32)
    (jq, jk, jv), (q, k, v) = _both(arrays, "float32")
    got = flash_attention(q, k, v, block_k=bk)
    np.testing.assert_allclose(_np(got), _np(jax_flash(jq, jk, jv, block_q=bq, block_k=bk)), **F32_TOL)
    np.testing.assert_allclose(_np(got), _np(flash_attention(q, k, v, block_k=32)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", [
    (1, 4, 2, 64, 64, 64, True, None),    # the JAX package's bf16 case
    (2, 4, 2, 96, 96, 32, True, 48),      # window, ragged in 64-blocks
    (1, 4, 4, 64, 192, 32, True, None),   # q tail of longer kv
])
def test_flash_bf16_matches_jax_blockwise(b, hq, hkv, sq, skv, d, causal, window):
    arrays = _qkv(np.random.default_rng(3), b, hq, hkv, sq, skv, d)
    (jq, jk, jv), (q, k, v) = _both(arrays, "bfloat16")
    want = jax_flash(jq, jk, jv, causal=causal, window=window, block_q=32, block_k=32)
    got = flash_attention(q, k, v, causal=causal, window=window, block_k=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", CASES)
def test_flash_bf16_at_the_kernel_tile_matches_jax(b, hq, hkv, sq, skv, d, causal, window):
    """The oracle the bf16 kernel is held to on the card (the plain version
    at the kernel's k tile) rounds like the JAX kernel at that block_k."""
    arrays = _qkv(np.random.default_rng(sq + skv + d), b, hq, hkv, sq, skv, d)
    (jq, jk, jv), (q, k, v) = _both(arrays, "bfloat16")
    want = jax_flash(jq, jk, jv, causal=causal, window=window, block_k=KERNEL_BLOCK_K)
    got = flash_attention(q, k, v, causal=causal, window=window, block_k=KERNEL_BLOCK_K)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_flash_window_equals_full_when_wide():
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(5), 1, 2, 2, 64, 64, 32))
    torch.testing.assert_close(flash_attention(q, k, v, window=64, block_k=32),
                               flash_attention(q, k, v, window=None, block_k=32), rtol=1e-6, atol=0)


def test_flash_attn_on_cpu_runs_the_plain_version_without_counting():
    q, k, v = (torch.from_numpy(a[0]) for a in _qkv(np.random.default_rng(6), 1, 4, 2, 40, 40, 32))
    before = flash_attn.launches
    got = flash_attn(q, k, v, window=16, block_k=16)
    assert flash_attn.launches == before
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, window=16, block_k=16),
                               rtol=0, atol=0)
