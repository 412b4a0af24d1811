"""Full BFS through the round kernel: the loop the ``("bfs", "cuda")``
engine kernel dispatches to.

The loop is :func:`repro_torch.core.bfs.bfs_rounds`, the local oracle's own
loop, with the expansion round swapped for :func:`bfs_expand`; the
min-merge is integer arithmetic, so the parent tree is bit-identical to
``bfs_local`` for every strategy and block size. Both S2 comm strategies
share the kernel; the strategy's contribution here is the grain axis,
``block_rows``. The kernel reads the graph's (P, V_p, K) planes in place:
nothing is copied into global vertex order.
"""
from __future__ import annotations

import torch

from ...core.bfs import _finalize_parents, bfs_rounds
from ...core.strategies import MigratoryStrategy
from ...sparse.graph import PartitionedGraph
from .kernel import bfs_expand


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
    expand = lambda a, f: bfs_expand(a, f, block_rows=block)  # noqa: E731
    return _finalize_parents(g, bfs_rounds(g.adj, root, max_rounds, expand, n))
