"""Graph500 BFS: migrating threads (Alg. 1) vs remote writes (Alg. 2).

Paper §3.2: the migrate version reads ``P[d]`` remotely (a thread migration
per traversed edge) and CASes; the remote-write version blindly pushes the
proposed parent into a shadow array ``nP`` (small one-sided packets, later
writes overwrite earlier ones) and commits in a local scan — two phases, no
atomics. We keep Alg. 2's two-phase structure exactly, replacing the
nondeterministic overwrite with a deterministic ``min`` merge (any proposed
parent is a valid BFS parent).

Both strategies produce identical parent trees (level-synchronous
min-merge); they differ in communication structure, which the numpy traffic
replay (:func:`bfs_traffic`) accounts for and the ``mesh`` substrate
(:func:`bfs_mesh`) runs for real between rank processes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import trace
from ..device import to_numpy
from ..sparse.graph import PartitionedGraph
from .strategies import Comm, MigratoryStrategy, TrafficStats

UNVISITED = torch.iinfo(torch.int32).max  # internal sentinel (min-merge friendly)


def _adj_global(g: PartitionedGraph) -> torch.Tensor:
    """(P, V_p, K) nodelet-major -> (N_pad, K) global-vertex-major view."""
    return global_rows(g.adj)


def global_rows(adj: torch.Tensor) -> torch.Tensor:
    """(P, V_p, K) nodelet-major planes -> (P*V_p, K) rows in global vertex
    order (row v is plane v % P, slot v // P); an (N, K) adjacency as it is."""
    if adj.dim() == 2:
        return adj
    p, vp, k = adj.shape
    return adj.permute(1, 0, 2).reshape(vp * p, k)


def _expand_dense(adj: torch.Tensor, frontier: torch.Tensor, n_pad: int) -> torch.Tensor:
    """One frontier expansion: dense proposal array nP (N_pad,) via min-scatter.

    For every frontier vertex s and neighbor d: propose parent s for d.
    Invalid slots scatter UNVISITED (a no-op for min); ids outside
    [0, n_pad) are dropped, as the reference's ``mode="drop"`` does.
    """
    n, k = adj.shape
    src = torch.arange(n, dtype=torch.int32, device=adj.device)[:, None].expand(n, k)
    valid = (frontier != 0)[:, None] & (adj >= 0) & (adj < n_pad)
    dst = torch.where(valid, adj, 0).reshape(-1).long()
    prop = torch.where(valid, src, UNVISITED).reshape(-1)
    out = torch.full((n_pad,), UNVISITED, dtype=torch.int32, device=adj.device)
    return out.scatter_reduce_(0, dst, prop, "amin")


def bfs_rounds(
    adj: torch.Tensor, root: int, max_rounds: int, expand, n: "int | None" = None
) -> torch.Tensor:
    """Level-synchronous BFS over ``adj`` with ``expand(adj, frontier)`` as
    the round body: the loop, the commit and the empty-frontier test, one
    host sync per round. ``n`` is the vertex count, ``adj.shape[0]`` unless
    given (``adj`` may be in any layout ``expand`` reads). Returns (n,) int32
    parents, UNVISITED where unreached."""
    n = adj.shape[0] if n is None else n
    parents = torch.full((n,), UNVISITED, dtype=torch.int32, device=adj.device)
    trace.count("sync.bfs_root")  # a host scalar stored on the card: a copy, then a wait
    parents[root] = root
    frontier = torch.zeros(n, dtype=torch.bool, device=adj.device)
    trace.count("sync.bfs_root")
    frontier[root] = True
    for _ in range(max_rounds):
        with trace.span("bfs.round"):
            trace.count("sync.bfs_frontier")
            if not bool(frontier.any()):
                break
            nP = expand(adj, frontier)
            newly = (parents == UNVISITED) & (nP != UNVISITED)
            parents = torch.where(newly, nP, parents)
            frontier = newly
    return parents


def _finalize_parents(g: PartitionedGraph, parents: torch.Tensor) -> torch.Tensor:
    """Trim padding and map the internal UNVISITED sentinel to -1."""
    parents = parents[: g.n_vertices]
    return torch.where(parents == UNVISITED, -1, parents)


def bfs_local(
    g: PartitionedGraph,
    root: int,
    strategy: MigratoryStrategy | None = None,
    max_rounds: int | None = None,
) -> torch.Tensor:
    """``local`` substrate: the single-device semantics oracle (both S2
    strategies compute the same tree here). (n_vertices,) int32, -1 unreached.
    """
    del strategy  # both comm strategies share the local oracle
    adj = _adj_global(g)
    max_rounds = max_rounds or g.P * g.v_per_nodelet
    expand = lambda a, f: _expand_dense(a, f, a.shape[0])  # noqa: E731
    return _finalize_parents(g, bfs_rounds(adj, root, max_rounds, expand))


def _bfs_rank(rank, world, group, adj_s, *, root: int, push: bool, max_rounds: int):
    """A mesh rank's BFS over its block of the vertex-major order (vertex v
    on rank v // vs, slot v % vs); returns its (vs,) slice of the parents.

    remote_write (Alg. 2, push): a dense proposal partial for the whole
    vertex space from local state only, pushed with an ``all_to_all`` of
    its P blocks and a local min (a reduce-scatter(min)). migrate (Alg. 1,
    pull): ``all_gather`` the parents (the remote read of P[d]), keep
    unvisited destinations, then ``all_gather`` every rank's partial, min,
    and take this rank's slice. Each round ends with an ``all_reduce`` of
    the newly visited count: the loop goes on while any rank has some."""
    vs, k = adj_s.shape
    n_pad = world * vs
    lo = rank * vs
    vids = lo + torch.arange(vs, dtype=torch.int32, device=adj_s.device)
    src = vids[:, None].expand(vs, k)
    parents = torch.where(vids == root, vids, UNVISITED)
    frontier = vids == root
    in_range = (adj_s >= 0) & (adj_s < n_pad)
    for _ in range(max_rounds):
        valid = frontier[:, None] & in_range
        dst = torch.where(valid, adj_s, 0).long()
        if not push:
            par_full = group.all_gather(parents)
            valid = valid & (par_full[dst] == UNVISITED)
        prop = torch.where(valid, src, UNVISITED).reshape(-1)
        partial = torch.full((n_pad,), UNVISITED, dtype=torch.int32, device=adj_s.device)
        partial.scatter_reduce_(0, dst.reshape(-1), prop, "amin")
        if push:
            nP = group.all_to_all(partial).view(world, vs).amin(0)
        else:
            nP = group.all_gather(partial).view(world, n_pad).amin(0)[lo:lo + vs]
        newly = (parents == UNVISITED) & (nP != UNVISITED)
        parents = torch.where(newly, nP, parents)
        frontier = newly
        if int(group.all_reduce(newly.sum().reshape(1))) == 0:
            break
    return parents


def bfs_mesh(
    g: PartitionedGraph,
    root: int,
    strategy: MigratoryStrategy | None = None,
    max_rounds: int | None = None,
    *,
    mesh,
) -> torch.Tensor:
    """``mesh`` substrate: the strategy's distributed BFS over ``mesh`` (a
    :class:`~repro_torch.launch.mesh.NodeletMesh` of ``g.P`` ranks), each
    rank holding a block of the vertex-major adjacency rows (not the
    nodelet-major partition). Same tree as :func:`bfs_local`."""
    strategy = strategy or MigratoryStrategy()
    max_rounds = max_rounds or g.P * g.v_per_nodelet
    parents = mesh.run(_bfs_rank, sharded=(_adj_global(g),), root=int(root),
                       push=strategy.comm == Comm.REMOTE_WRITE, max_rounds=max_rounds)
    return _finalize_parents(g, torch.cat(parents))


def bfs(
    g: PartitionedGraph,
    root: int,
    strategy: MigratoryStrategy | None = None,
    *,
    mesh=None,
    max_rounds: int | None = None,
) -> torch.Tensor:
    """Dispatch shim: the ``local`` substrate without a mesh, the ``mesh``
    substrate over ``mesh`` with one (on the graph's device)."""
    from ..engine.substrate import substrate_for_mesh

    return substrate_for_mesh(mesh, g.adj.device).kernel("bfs")(
        g, root, strategy=strategy or MigratoryStrategy(), max_rounds=max_rounds
    )


# -- paper-model traffic accounting (numpy simulator) -------------------------


@dataclasses.dataclass
class BFSRunStats:
    rounds: int
    edges_traversed: int
    traffic: TrafficStats


def _adj_numpy(g: PartitionedGraph) -> np.ndarray:
    p, vp, k = g.adj.shape
    return np.transpose(to_numpy(g.adj), (1, 0, 2)).reshape(vp * p, k)


def bfs_traffic(g: PartitionedGraph, root: int, strategy: MigratoryStrategy) -> BFSRunStats:
    """Replay BFS in numpy, counting the paper's traffic units.

    migrate (Alg. 1): one thread migration per traversed edge whose
    destination lives on a remote nodelet (read of P[d] moves the thread
    there), plus the hop back ("ping-pong", §7) — counted as 2 migrations.
    remote_write (Alg. 2): one small packet per traversed edge with a remote
    destination; no migrations.
    """
    p = g.P
    trace.count("sync.bfs_replay")  # the planes copied to the host: a wait
    adj = _adj_numpy(g)
    n_pad = adj.shape[0]
    owner = np.arange(n_pad) % p  # striped ownership (paper layout)
    parents = np.full(n_pad, -1, dtype=np.int64)
    parents[root] = root
    frontier = np.zeros(n_pad, dtype=bool)
    frontier[root] = True
    migrations = remote_writes = edges = rounds = 0
    while frontier.any():
        rounds += 1
        srcs = np.nonzero(frontier)[0]
        nbrs = adj[srcs]  # (f, K)
        valid = nbrs >= 0
        dst = nbrs[valid]
        src = np.repeat(srcs, valid.sum(axis=1))
        edges += len(dst)
        remote = owner[dst] != owner[src]
        if strategy.comm == Comm.MIGRATE:
            migrations += int(2 * remote.sum())
        else:
            remote_writes += int(remote.sum())
        nP = np.full(n_pad, np.iinfo(np.int64).max)
        np.minimum.at(nP, dst, src)
        newly = (parents == -1) & (nP != np.iinfo(np.int64).max)
        parents[newly] = nP[newly]
        frontier = newly
    return BFSRunStats(
        rounds=rounds,
        edges_traversed=edges,
        traffic=TrafficStats(migrations=migrations, remote_writes=remote_writes),
    )


def teps(n_edges_traversed: int, seconds: float) -> float:
    return n_edges_traversed / max(seconds, 1e-12)


def bfs_bytes_moved(n_edges: int) -> int:
    """Paper §5.2 unit of useful work: every traversed edge reads+writes one
    8-byte word (2 * 8 bytes per edge)."""
    return n_edges * 2 * 8


def bfs_effective_bandwidth(scale: int, seconds: float, edge_factor: int = 16) -> float:
    """Paper §5.2: BW = 16 * 2^scale * 2 * 8 / time = TEPS * 16."""
    return bfs_bytes_moved(edge_factor * (1 << scale)) / max(seconds, 1e-12)


def validate_parents(g: PartitionedGraph, root: int, parents) -> bool:
    """Graph500-style validation: root ok, every parent edge exists, and
    every reached vertex hangs off the root through its parent chain.

    Vectorised form of the reference's per-vertex loops, with the same
    verdict: a reached vertex whose chain never reaches the root (an
    unreached ancestor or a cycle) fails the check."""
    adj = _adj_numpy(g)
    n = g.n_vertices
    parents = np.asarray(to_numpy(parents) if isinstance(parents, torch.Tensor) else parents)
    parents = parents[:n].astype(np.int64)
    if parents[root] != root:
        return False
    reached = np.nonzero(parents >= 0)[0]
    others = reached[reached != root]
    for lo in range(0, len(others), 1 << 16):  # bounded (chunk, K) gathers
        v = others[lo:lo + (1 << 16)]
        if not (adj[parents[v]] == v[:, None]).any(axis=1).all():
            return False
    # pointer doubling: anc[v] walks 2^i steps up the parent chain; index n
    # is a sink for unreached vertices, the root is its own fixed point
    anc = np.append(np.where(parents >= 0, parents, n), n)
    for _ in range(max(1, int(n).bit_length()) + 1):
        anc = anc[anc]
    return bool((anc[reached] == root).all())
