"""Full BFS on the card: what the ``("bfs", "cuda")`` engine kernel
dispatches to.

On CUDA tensors the whole search is one cooperative launch of
:func:`bfs_search` (``csrc/bfs_expand.cu``): the level loop, the commit, the
empty-frontier test and the root's stores run on the card, so a search
costs the host one launch and no wait; the card path no longer runs
:func:`repro_torch.core.bfs.bfs_rounds`. On CPU tensors the search is the
kernel's plain version, ``bfs_rounds`` (the local oracle's own loop) over
:func:`~.kernel.bfs_expand_plain`. The two paths share no loop logic: a
host test a level is what the card path must not do.
The min-merge is integer arithmetic, so the parent tree is bit-identical to
``bfs_local`` for every strategy, block size and ``max_rounds``. Both S2
comm strategies share the kernel; the strategy's contribution here is the
grain axis, ``block_rows``, and the search's grid is the kernel's
occupancy at that grain. The kernel reads the graph's (P, V_p, K) planes in
place: nothing is copied into global vertex order.
"""
from __future__ import annotations

import torch

from ...core.bfs import _finalize_parents
from ...core.strategies import MigratoryStrategy
from ...sparse.graph import PartitionedGraph
from .kernel import bfs_search


def bfs_cuda(
    g: PartitionedGraph,
    root: int,
    strategy: "MigratoryStrategy | None" = None,
    max_rounds: "int | None" = None,
    *,
    block_rows: "int | None" = None,
) -> torch.Tensor:
    """(n_vertices,) int32 parents, -1 unreached — bit-identical to
    ``bfs_local``. ``block_rows`` (explicit) beats the strategy's grain axis
    beats the dynamic grain over the whole padded graph."""
    n = g.P * g.v_per_nodelet
    max_rounds = max_rounds or n
    if block_rows is None:
        block_rows = (strategy or MigratoryStrategy()).dynamic_grain(n)
    block = max(1, min(int(block_rows), n))
    return _finalize_parents(g, bfs_search(g.adj, root, block_rows=block, max_rounds=max_rounds))
