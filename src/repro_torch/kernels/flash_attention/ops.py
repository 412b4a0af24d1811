"""Public flash-attention op: (B, H, S, D) API, folding and dispatch."""
from __future__ import annotations

import torch

from .kernel import flash_attn
from .ref import attention_reference


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    block_k: int = 128,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Tiled attention. On CUDA tensors the kernel runs (its tiles are fixed);
    on CPU tensors its plain version runs with k blocks of ``block_k``, as
    the JAX package's kernel does with the same ``block_k``. No padding: the
    kernel and the plain version both take ragged lengths as they are."""
    if not use_kernel:
        return attention_reference(q, k, v, causal=causal, window=window, scale=scale)
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    o = flash_attn(
        q.reshape(b * hq, sq, d), k.reshape(b * hkv, skv, d), v.reshape(b * hkv, skv, d),
        causal=causal, window=window, scale=scale, block_k=min(block_k, max(8, skv)),
    )
    return o.reshape(b, hq, sq, d)
