"""One BFS frontier-expansion round: the CUDA kernel ``csrc/bfs_expand.cu``
and its plain PyTorch version.

``bfs_expand`` launches the kernel on CUDA tensors and runs
:func:`bfs_expand_plain` on CPU tensors (:mod:`repro_torch.kernels.runtime`).
Both return the same (N,) int32 array bit for bit: the merge is an integer
min, which no order of the atomics can change.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...core.bfs import UNVISITED, _expand_dense
from ..build import check, load, stream_of
from ..runtime import on_card


def bfs_expand_plain(adj: torch.Tensor, frontier: torch.Tensor) -> torch.Tensor:
    """(N, K) adjacency (-1 pad) + (N,) frontier mask -> (N,) proposed
    parents, UNVISITED where nothing was proposed."""
    return _expand_dense(adj, frontier, adj.shape[0])


@functools.cache
def _entry():
    lib = load("bfs_expand")
    fn = lib.bfs_expand_i32
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


def bfs_expand(
    adj: torch.Tensor, frontier: torch.Tensor, *, block_rows: int = 256
) -> torch.Tensor:
    """One expansion round. adj (N, K) int32, frontier (N,) mask (bool, or
    integer 0/1) -> (N,) int32. ``block_rows`` = rows per CUDA block."""
    if not on_card(adj, frontier):
        return bfs_expand_plain(adj, frontier)
    n, k = adj.shape
    if frontier.shape != (n,):
        raise ValueError(f"frontier {tuple(frontier.shape)} does not match adj {tuple(adj.shape)}")
    if adj.dtype != torch.int32:
        raise TypeError(f"adj must be int32, got {adj.dtype}")
    if not adj.is_contiguous():
        raise ValueError("bfs_expand needs a contiguous adj")
    frontier = frontier.to(torch.bool).contiguous()
    proposals = torch.full((n,), UNVISITED, dtype=torch.int32, device=adj.device)
    lib, fn = _entry()
    block = max(1, min(int(block_rows), max(n, 1)))
    err = fn(adj.data_ptr(), frontier.data_ptr(), proposals.data_ptr(), n, k, block,
             stream_of(adj))
    check(lib, err, "bfs_expand")
    bfs_expand.launches += 1
    return proposals


bfs_expand.launches = 0  # kernel launches since the count was last set to 0
