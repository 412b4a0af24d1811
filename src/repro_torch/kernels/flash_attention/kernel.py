"""Flash attention over folded heads: the CUDA kernel ``csrc/flash_attn.cu``
and its plain PyTorch version.

``flash_attn`` launches the kernel on CUDA tensors and runs
:func:`flash_attention_plain` on CPU tensors
(:mod:`repro_torch.kernels.runtime`). Queries are ``(B*Hq, Sq, D)``, keys
and values ``(B*Hkv, Skv, D)``; q row ``bh`` reads kv row ``bh // group``.
The kernel masks ragged tiles itself, so nothing is padded. Its tiles are
fixed at 64 x 64; ``block_k`` shapes only the plain version's k blocks,
which set where its online softmax rounds.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import check, load, stream_of
from ..runtime import on_card

#: head dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(
    q: torch.Tensor,  # (BHq, Sq, D)
    k: torch.Tensor,  # (BHkv, Skv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    block_k: int = 128,
) -> torch.Tensor:
    """The TPU kernel's algorithm in PyTorch: a loop over k blocks of
    ``block_k`` with float32 m, l and acc, ``p`` rounded to v's type before
    the PV product. So it rounds like the Pallas kernel in bf16 as well."""
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    group = bhq // bhkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(bhkv, group, sq, d).float()  # q rows of one kv row are adjacent
    m = torch.full((bhkv, group, sq, 1), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((bhkv, group, sq, d), device=q.device)
    q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    for k0 in range(0, skv, block_k):
        kb = k[:, None, k0:k0 + block_k].float()
        vb = v[:, None, k0:k0 + block_k]
        s = torch.matmul(qg, kb.transpose(-1, -2)) * scale
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=q.device)[None, :]
        mask = torch.ones((sq, kb.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos >= k_pos
        if window is not None:
            mask &= q_pos - k_pos < window
        s = s.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe)  # rows fully masked -> exp(-inf - 0) = 0
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)
    return out.reshape(bhq, sq, d).to(q.dtype)


@functools.cache
def _entry():
    lib = load("flash_attn")
    fn = lib.flash_attn
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attn(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    block_k: int = 128,
) -> torch.Tensor:
    """Attention of q (BHq, Sq, D) over k, v (BHkv, Skv, D) -> (BHq, Sq, D)
    in q's type; the causal mask and the window are aligned to the kv tail."""
    if not on_card(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window, scale=scale,
                                     block_k=block_k)
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 or k.shape[2] != q.shape[2]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    if bhkv == 0 or bhq % bhkv:
        raise ValueError(f"q rows {bhq} must be a multiple of kv rows {bhkv}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"unsupported head dim {d}: the kernel takes {KERNEL_HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"need one of float32/bfloat16 for q, k, v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attn needs contiguous q, k and v")
    if max(sq, skv) >= 2**31:
        raise ValueError(f"sequence too long for the kernel: {sq}, {skv}")
    scale = scale if scale is not None else d ** -0.5
    # the window tests q_pos + skv - sq - k_pos < window, and that difference
    # lies in [1 - sq, skv - 1]: a window of skv or more masks nothing and one
    # of -sq or less masks everything, so clamping to [-sq, skv] keeps the
    # meaning and fits a C int
    w = skv if window is None else min(max(int(window), -sq), skv)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib, fn = _entry()
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             bhq, bhkv, sq, skv, d, int(causal), w, float(scale), stream_of(o))
    check(lib, err, "flash_attn")
    flash_attn.launches += 1
    return o


flash_attn.launches = 0  # kernel launches since the count was last set to 0
