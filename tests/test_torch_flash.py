"""The port's flash attention (its plain blockwise version, on the CPU)
against the JAX package's (the Pallas kernel in interpret mode), on the same
numpy inputs. The kernel itself is held against the plain version on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_folded as jax_flash_folded
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_reference as jax_reference
from repro_torch.kernels.flash_attention.kernel import (
    KERNEL_BLOCK_K, MAX_HEAD_DIM, flash_attention_plain, flash_attn, kernel_block_k,
    on_tensor_cores,
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


# (bh_q, bh_kv, sq, skv, causal, window) at the head dims of phi-3-vision-4.2b
# (96) and zamba2-2.7b (80): GQA causal, a sliding window, q the tail of a
# longer kv; lengths are multiples of the reference kernel's 32-row blocks
FOLDED_CASES = [(8, 4, 64, 64, True, None), (4, 2, 96, 96, True, 48), (4, 4, 64, 128, True, None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [80, 96])
@pytest.mark.parametrize("bhq,bhkv,sq,skv,causal,window", FOLDED_CASES)
def test_flash_plain_matches_folded_kernel_at_config_head_dims(bhq, bhkv, sq, skv, causal, window,
                                                               d, dtype):
    """The plain version (what the card's kernel is held to) against the
    JAX package's folded Pallas kernel in interpret mode, at the same k
    blocks, for head dims that are not 64 or 128."""
    rng = np.random.default_rng(bhq * sq + skv + d)
    arrays = [rng.standard_normal((n, s_, d)).astype(np.float32)
              for n, s_ in ((bhq, sq), (bhkv, skv), (bhkv, skv))]
    (jq, jk, jv), (q, k, v) = _both(arrays, dtype)
    want = jax_flash_folded(jq, jk, jv, causal=causal, window=window, block_q=32, block_k=32,
                            interpret=True)
    got = flash_attention_plain(q, k, v, causal=causal, window=window, block_k=32)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_flash_kernel_dispatch_rule():
    """Which kernel takes (dtype, head dim), and so at which k tile the plain
    version rounds like it: the tensor cores take bf16 at multiples of 8 up
    to 128, the CUDA cores everything else up to MAX_HEAD_DIM."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert [on_tensor_cores(bf16, d) for d in (8, 32, 64, 72, 80, 96, 128)] == [True] * 7
    assert not any(on_tensor_cores(bf16, d) for d in (20, 36, 100, 136, 256))
    assert not any(on_tensor_cores(f32, d) for d in (32, 64, 128))
    assert [kernel_block_k(bf16, d) for d in (32, 96, 20, 200)] == [KERNEL_BLOCK_K, KERNEL_BLOCK_K, 64, 64]
    assert kernel_block_k(f32, 128) == 64
    assert MAX_HEAD_DIM == 256


@pytest.mark.parametrize("d", [20, 80, 96])
def test_flash_attn_on_cpu_takes_every_head_dim(d):
    """On CPU tensors the wrapper runs the plain version at any head dim,
    counting no launch."""
    q, k, v = (torch.from_numpy(a[0]) for a in _qkv(np.random.default_rng(d), 1, 4, 2, 40, 40, d))
    before = flash_attn.launches
    got = flash_attn(q, k, v, block_k=kernel_block_k(q.dtype, d))
    assert flash_attn.launches == before and got.shape == q.shape
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, block_k=64), rtol=0, atol=0)
