"""Fused GSANA similarity + top-k: the CUDA kernel ``csrc/topk_sim.cu`` and
its plain PyTorch version.

``topk_sim`` launches the kernel on CUDA tensors and runs
:func:`topk_sim_plain` on CPU tensors (:mod:`repro_torch.kernels.runtime`).
One task = one ⟨B, B'⟩ PAIR task (paper Alg. 5): feature planes
``feat_v (A, F)`` and ``feat_u (B, F)`` -> the k best (score, u slot) of
every v row, from k argmax-and-mask passes (the first index among equal
maxima; a row with fewer than k valid slots repeats slot 0 at -inf, as the
TPU kernel does). The kernel takes any A, B and k, k > B included.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...core.gsana import NEG, sim_from_feats, task_chunk
from ...trace import count_launch
from ..build import check, load, stream_of
from ..runtime import on_card

#: the most scored feature columns (5 + t1 + t2 + t3) the kernel takes: its
#: wide instance keeps 40 rows of them in a block's 227 KB of shared memory
MAX_SCORED_COLUMNS = 1441


def topk_sim_plain(
    feat_v: torch.Tensor, feat_u: torch.Tensor, mask_v: torch.Tensor, mask_u: torch.Tensor,
    *, t1: int, t2: int, t3: int, k: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, A, F), (P, B, F), (P, A), (P, B) -> scores (P, A, k) float32,
    idx (P, A, k) int32. Tasks run in batches that bound the histogram
    temporaries."""
    p, a, _ = feat_v.shape
    b = feat_u.shape[1]
    scores = torch.empty((p, a, k), dtype=torch.float32, device=feat_v.device)
    idx = torch.empty((p, a, k), dtype=torch.int32, device=feat_v.device)
    step = task_chunk(a, b, max(t1, t2, t3))
    for lo in range(0, p, step):
        hi = min(lo + step, p)
        s = sim_from_feats(feat_v[lo:hi], feat_u[lo:hi], t1, t2, t3)
        valid = (mask_v[lo:hi] > 0)[:, :, None] & (mask_u[lo:hi] > 0)[:, None, :]
        s = torch.where(valid, s, NEG)
        for j in range(k):
            arg = s.argmax(dim=-1, keepdim=True)  # first index among equal maxima
            scores[lo:hi, :, j] = s.gather(-1, arg)[..., 0]
            idx[lo:hi, :, j] = arg[..., 0].to(torch.int32)
            s.scatter_(-1, arg, NEG)
    return scores, idx


@functools.cache
def _entry():
    lib = load("topk_sim")
    fn = lib.topk_sim_f32
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def topk_sim(
    feat_v: torch.Tensor, feat_u: torch.Tensor, mask_v: torch.Tensor, mask_u: torch.Tensor,
    *, t1: int, t2: int, t3: int, k: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Similarity + top-k of every PAIR task; shapes as :func:`topk_sim_plain`."""
    if not on_card(feat_v, feat_u, mask_v, mask_u):
        return topk_sim_plain(feat_v, feat_u, mask_v, mask_u, t1=t1, t2=t2, t3=t3, k=k)
    p, a, f = feat_v.shape
    b = feat_u.shape[1]
    if feat_u.shape != (p, b, f) or mask_v.shape != (p, a) or mask_u.shape != (p, b):
        raise ValueError(
            f"feat_v {tuple(feat_v.shape)}, feat_u {tuple(feat_u.shape)}, "
            f"mask_v {tuple(mask_v.shape)}, mask_u {tuple(mask_u.shape)}"
        )
    tensors = (feat_v, feat_u, mask_v, mask_u)
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in tensors):
        raise TypeError("topk_sim needs contiguous float32 features and masks")
    width = 5 + t1 + t2 + t3
    if not (k >= 1 and b >= 1 and width <= min(f, MAX_SCORED_COLUMNS)):
        raise ValueError(f"unsupported shape: A={a}, B={b}, F={f}, k={k}, vocab={(t1, t2, t3)}")
    scores = torch.empty((p, a, k), dtype=torch.float32, device=feat_v.device)
    idx = torch.empty((p, a, k), dtype=torch.int32, device=feat_v.device)
    lib, fn = _entry()
    err = fn(feat_v.data_ptr(), feat_u.data_ptr(), mask_v.data_ptr(), mask_u.data_ptr(),
             scores.data_ptr(), idx.data_ptr(), p, a, b, f, t1, t2, t3, k, stream_of(scores))
    check(lib, err, "topk_sim")
    count_launch(topk_sim)
    return scores, idx


topk_sim.launches = 0  # kernel launches since the count was last set to 0
