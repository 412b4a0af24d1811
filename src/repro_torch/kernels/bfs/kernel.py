"""One BFS frontier-expansion round: the CUDA kernel ``csrc/bfs_expand.cu``
and its plain PyTorch version.

``bfs_expand`` launches the kernel on CUDA tensors and runs
:func:`bfs_expand_plain` on CPU tensors (:mod:`repro_torch.kernels.runtime`).
Both return the same (N,) int32 array bit for bit: the merge is an integer
min, which no order of the atomics can change.

The adjacency comes as (N, K) rows in global vertex order or as a
partitioned graph's own (P, V_p, K) nodelet-major planes (global row v at
plane v % P, slot v // P); the kernel reads either in place.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...core.bfs import UNVISITED, _expand_dense, global_rows
from ...trace import count_launch
from ..build import check, load, stream_of
from ..runtime import on_card


def bfs_expand_plain(adj: torch.Tensor, frontier: torch.Tensor) -> torch.Tensor:
    """(N, K) or (P, V_p, K) adjacency (-1 pad) + (N,) frontier mask -> (N,)
    proposed parents, UNVISITED where nothing was proposed."""
    rows = global_rows(adj)
    return _expand_dense(rows, frontier, rows.shape[0])


@functools.cache
def _entry():
    lib = load("bfs_expand")
    fn = lib.bfs_expand_i32
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.bfs_expand_occupancy.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.bfs_expand_occupancy.restype = ctypes.c_int
    return lib, fn


def _planes(adj: torch.Tensor) -> tuple[int, int, int]:
    """(P, V_p, K) of an adjacency; an (N, K) one is a single plane."""
    if adj.dim() == 2:
        return (1, *adj.shape)
    if adj.dim() == 3:
        return tuple(adj.shape)
    raise ValueError(f"adj must be (N, K) or (P, V_p, K), got {tuple(adj.shape)}")


def bfs_expand(
    adj: torch.Tensor, frontier: torch.Tensor, *, block_rows: int = 256
) -> torch.Tensor:
    """One expansion round. adj (N, K) or (P, V_p, K) int32, frontier (N,)
    mask (bool, or integer, nonzero = in) -> (N,) int32. ``block_rows`` =
    rows one CUDA block owns."""
    if not on_card(adj, frontier):
        return bfs_expand_plain(adj, frontier)
    p, vp, k = _planes(adj)
    n = p * vp
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
    err = fn(adj.data_ptr(), frontier.data_ptr(), proposals.data_ptr(), p, vp, k, block,
             stream_of(adj))
    check(lib, err, "bfs_expand")
    count_launch(bfs_expand)
    return proposals


bfs_expand.launches = 0  # kernel launches since the count was last set to 0


def bfs_expand_occupancy(block_rows: int) -> dict:
    """The kernel's launch shape at a grain, on the current card: threads a
    CUDA block and blocks resident on one SM (CUDA's occupancy calculator)."""
    lib, _ = _entry()
    threads, blocks = ctypes.c_int(), ctypes.c_int()
    check(lib, lib.bfs_expand_occupancy(int(block_rows), ctypes.byref(threads), ctypes.byref(blocks)),
          "bfs_expand_occupancy")
    return {"threads_per_block": threads.value, "blocks_per_sm": blocks.value}
