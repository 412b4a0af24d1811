"""BFS on the card, ``csrc/bfs_expand.cu``: one frontier-expansion round
(``bfs_expand``) and a whole search in one cooperative launch
(``bfs_search``), each beside its plain PyTorch version.

Each wrapper launches its kernel on CUDA tensors and runs its plain version
on CPU tensors (:mod:`repro_torch.kernels.runtime`). Both return the same
int32 array bit for bit: the merge is an integer min, which no order of the
atomics can change.

The adjacency comes as (N, K) rows in global vertex order or as a
partitioned graph's own (P, V_p, K) nodelet-major planes (global row v at
plane v % P, slot v // P); the kernel reads either in place.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import trace
from ...core.bfs import UNVISITED, _expand_dense, bfs_rounds, global_rows
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
    lib.bfs_search_shape.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.bfs_search_shape.restype = ctypes.c_int
    lib.bfs_search_i32.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.bfs_search_i32.restype = ctypes.c_int
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


def bfs_search_plain(adj: torch.Tensor, root: int, max_rounds: "int | None" = None) -> torch.Tensor:
    """The host round loop over :func:`bfs_expand_plain`: (N,) int32
    parents of a search from ``root``, UNVISITED where unreached."""
    n = global_rows(adj).shape[0]
    return bfs_rounds(adj, root, max_rounds or n, bfs_expand_plain, n)


@functools.cache
def _search_ctas(device_index: int, block_rows: int) -> int:
    """The most CTAs one cooperative launch of the search kernel may hold at
    a grain, on the current card: its occupancy times the SMs."""
    lib, _ = _entry()
    threads, ctas = ctypes.c_int(), ctypes.c_int()
    check(lib, lib.bfs_search_shape(block_rows, ctypes.byref(threads), ctypes.byref(ctas)),
          "bfs_search_shape")
    if ctas.value < 1:
        raise RuntimeError(f"bfs_search: no CTA of {threads.value} threads fits an SM")
    return ctas.value


def bfs_search(
    adj: torch.Tensor, root: int, *, block_rows: int = 256, max_rounds: "int | None" = None
) -> torch.Tensor:
    """A whole BFS from ``root`` in one launch: adj (N, K) or (P, V_p, K)
    int32 -> (N,) int32 parents, UNVISITED where unreached; at most
    ``max_rounds`` levels (all of them by default). ``block_rows`` = rows a
    CUDA block expands at a time. No host wait."""
    if not on_card(adj):
        return bfs_search_plain(adj, root, max_rounds)
    p, vp, k = _planes(adj)
    n = p * vp
    root = int(root)
    if not 0 <= root < n:
        raise ValueError(f"root {root} outside the graph's {n} vertices")
    if adj.dtype != torch.int32:
        raise TypeError(f"adj must be int32, got {adj.dtype}")
    if not adj.is_contiguous():
        raise ValueError("bfs_search needs a contiguous adj")
    block = max(1, min(int(block_rows), n))
    ctas = min(_search_ctas(adj.device.index, block), -(-n // block))
    dev = adj.device
    parents = torch.empty(n, dtype=torch.int32, device=dev)
    frontier = torch.empty(n, dtype=torch.bool, device=dev)
    proposals = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    lib, _ = _entry()
    with trace.span("bfs.search"):
        err = lib.bfs_search_i32(
            adj.data_ptr(), parents.data_ptr(), frontier.data_ptr(), proposals.data_ptr(),
            counts.data_ptr(), p, vp, k, block, root, max_rounds or n, ctas, stream_of(adj))
        check(lib, err, "bfs_search")
    count_launch(bfs_search)
    return parents


bfs_search.launches = 0  # kernel launches since the count was last set to 0
