"""Plain reference for the BFS cells: level-synchronous search over the
benchmark's own edge list (``src``, ``dst`` of every directed adjacency
entry), and Graph500's validation of a parent array against it.

Imports torch only: nothing of the program, no kernel, no oracle of it.
"""
from __future__ import annotations

import torch


def levels(src: torch.Tensor, dst: torch.Tensor, n: int, root: int,
           max_rounds: "int | None" = None) -> torch.Tensor:
    """(n,) int64 BFS depth from ``root``, -1 where unreached."""
    level = torch.full((n,), -1, dtype=torch.int64, device=src.device)
    level[root] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=src.device)
    frontier[root] = True
    depth = 0
    while (max_rounds is None or depth < max_rounds) and bool(frontier.any()):
        depth += 1
        nb = dst[frontier[src]]
        nb = nb[level[nb] < 0]
        level[nb] = depth
        frontier = torch.zeros_like(frontier)
        frontier[nb] = True
    return level


def parents(src: torch.Tensor, dst: torch.Tensor, n: int, root: int,
            max_rounds: "int | None" = None) -> torch.Tensor:
    """(n,) int64 parents of a level-synchronous search (any frontier
    neighbour wins), ``root`` its own parent, -1 where unreached."""
    par = torch.full((n,), -1, dtype=torch.int64, device=src.device)
    par[root] = root
    frontier = torch.zeros(n, dtype=torch.bool, device=src.device)
    frontier[root] = True
    depth = 0
    while (max_rounds is None or depth < max_rounds) and bool(frontier.any()):
        depth += 1
        hit = frontier[src]
        s, d = src[hit], dst[hit]
        new = par[d] < 0
        par[d[new]] = s[new]
        frontier = torch.zeros_like(frontier)
        frontier[d[new]] = True
    return par


def bad_vertices(par: torch.Tensor, keys: torch.Tensor, n: int, root: int,
                 level: torch.Tensor) -> int:
    """Graph500 validation, counted: vertices whose parent is wrong.

    A vertex is bad when the root is not its own parent; when it is reached
    in one array and not in the other; or when it is reached, is not the
    root, and its parent is not a neighbour one level nearer the root.
    ``keys`` is the sorted ``src * n + dst`` of every adjacency entry and
    ``level`` the reference's depths."""
    par = par.to(torch.int64)
    if par.shape != (n,):
        return n
    bad = int(par[root] != root)
    reached = par >= 0
    bad += int((reached != (level >= 0)).sum())
    v = torch.nonzero(reached & (level >= 0)).squeeze(1)
    v = v[v != root]
    p = par[v]
    in_range = p < n
    p_ok = p.clamp(max=n - 1)
    key = p_ok * n + v
    pos = torch.searchsorted(keys, key).clamp(max=keys.numel() - 1)
    is_edge = keys[pos] == key
    one_up = level[p_ok] == level[v] - 1
    bad += int((~(in_range & is_edge & one_up)).sum())
    return bad
