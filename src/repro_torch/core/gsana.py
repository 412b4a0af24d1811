"""GSANA parallel similarity computation (paper §3.3, results §5.3).

Schemes (Alg. 3-5): ``ALL`` spawns one task per bucket B ∈ QT2 and compares
its vertices against all neighbor buckets B' ∈ QT1.Neig(B); ``PAIR`` spawns
one task per ⟨B, B'⟩ pair (finer grain, better balance, more merge work).
Both compute identical top-k results.

Layouts (§3.3.2): ``BLK`` partitions vertices by ID and buckets round-robin
(placement-oblivious); ``HCB`` sorts buckets in Hilbert order and assigns
contiguous runs to nodelets with an edge-balancing pass, co-locating each
vertex (and its metadata) with its bucket. The layout drives the
*placement and traffic model* (modeled makespan + migrations, the paper's
§5.3 metrics), which reports carry next to measured wall time.

Similarity σ(u, v) (paper §5.3): degree Δ, vertex type τ, adjacent vertex
types τ_V, adjacent edge types τ_E, vertex attributes C_V — the last three
compare neighborhoods as multiset histograms of the sorted arrays. The
per-vertex scalars and histograms are packed once into one dense feature
plane (:func:`pack_features`); the same plane feeds the CUDA kernel.

Top-k keeps the lowest index among equal scores, as ``jax.lax.top_k`` does:
a stable descending sort, then the first k.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import to_numpy
from .gsana_data import Buckets, VertexSet, neighbor_buckets
from .hilbert import hilbert_order_of_buckets
from .strategies import Scheme, TrafficStats

NEG = float("-inf")

# vocab sizes (n_types, n_etypes, n_attr_vocab) for the histogram overlap;
# must cover the generator's vocabularies (gsana_data defaults: 8, 6, 64).
DEFAULT_VOCAB = (16, 16, 64)

# bound on the elements of one (tasks, A, B, T) histogram-min temporary
# (256 MB of float32): task batches are cut to stay under it
_CHUNK_ELEMS = 1 << 26


# -- σ: the five similarity metrics -------------------------------------------


def _hist(a: torch.Tensor, vocab: int) -> torch.Tensor:
    """(n, K) sorted padded (-1) ids -> (n, vocab) multiset histogram; ids
    outside [0, vocab) are dropped."""
    idx = torch.where(a >= 0, a, vocab).clamp(max=vocab).long()
    h = torch.zeros(a.shape[0], vocab + 1, dtype=torch.float32, device=a.device)
    return h.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))[:, :vocab]


def pack_features(vs: VertexSet, vocab: tuple[int, int, int] = DEFAULT_VOCAB) -> torch.Tensor:
    """(n, F) dense feature plane, F = 5 + T1 + T2 + T3:
    [0] deg, [1] vtype, [2] |ntypes|, [3] |etypes|, [4] |attrs|,
    then the ntypes, etypes and attrs histograms."""
    t1, t2, t3 = vocab
    count = lambda a: (a >= 0).sum(-1, dtype=torch.float32)[:, None]  # noqa: E731
    return torch.cat(
        [
            vs.deg.float()[:, None], vs.vtype.float()[:, None],
            count(vs.ntypes), count(vs.etypes), count(vs.attrs),
            _hist(vs.ntypes, t1), _hist(vs.etypes, t2), _hist(vs.attrs, t3),
        ],
        dim=1,
    )


def sim_from_feats(fv: torch.Tensor, fu: torch.Tensor, t1: int, t2: int, t3: int) -> torch.Tensor:
    """(..., A, F) x (..., B, F) -> (..., A, B) σ scores (no masking).

    The reference's operation order: histogram min-sums (exact, integer
    valued), the five terms added left to right, then times 0.2."""
    s_deg = torch.reciprocal(1.0 + (fv[..., :, None, 0] - fu[..., None, :, 0]).abs())
    s_typ = (fv[..., :, None, 1] == fu[..., None, :, 1]).float()

    def ov(lo: int, width: int, nslot: int) -> torch.Tensor:
        hv = fv[..., :, None, lo:lo + width]
        hu = fu[..., None, :, lo:lo + width]
        inter = torch.minimum(hv, hu).sum(-1)
        denom = torch.maximum(fv[..., :, None, nslot], fu[..., None, :, nslot]).clamp(min=1.0)
        return inter / denom

    o = 5
    s_nt = ov(o, t1, 2)
    s_et = ov(o + t1, t2, 3)
    s_at = ov(o + t1 + t2, t3, 4)
    return 0.2 * (s_deg + s_typ + s_nt + s_et + s_at)


def task_chunk(a: int, b: int, t: int) -> int:
    """How many (A, B) tasks one batch of histogram work may hold."""
    return max(1, _CHUNK_ELEMS // max(1, a * b * t))


def _scores(f2, f1, v_idx, u_idx, vocab) -> torch.Tensor:
    """σ for batches of (v_idx (T, A) from G2) x (u_idx (T, B) from G1) ->
    (T, A, B); -inf on padded slots (-1 ids)."""
    s = sim_from_feats(f2[v_idx.clamp(min=0).long()], f1[u_idx.clamp(min=0).long()], *vocab)
    valid = (v_idx >= 0)[..., :, None] & (u_idx >= 0)[..., None, :]
    return torch.where(valid, s, NEG)


def similarity_block(
    vs2: VertexSet, vs1: VertexSet, v_idx: torch.Tensor, u_idx: torch.Tensor,
    vocab: tuple[int, int, int] = DEFAULT_VOCAB,
) -> torch.Tensor:
    """σ for all pairs (v ∈ v_idx from G2) x (u ∈ u_idx from G1).

    v_idx: (A,) int32 (-1 pad), u_idx: (B,) int32 (-1 pad) -> (A, B) scores,
    -inf on padded slots.
    """
    return _scores(pack_features(vs2, vocab), pack_features(vs1, vocab),
                   v_idx[None], u_idx[None], vocab)[0]


def topk_first(s: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis, lowest index first among equal scores
    (``jax.lax.top_k``'s order)."""
    sc, loc = torch.sort(s, dim=-1, descending=True, stable=True)
    return sc[..., :k], loc[..., :k]


# -- parallel similarity computation (ALL / PAIR) ------------------------------


def _task_topk(vs1, vs2, v_idx, u_idx, k):
    """Score and keep the top-k of every task: v_idx (T, A), u_idx (T, B) ->
    (cand (T, A, k) global u ids or -1, score (T, A, k))."""
    f1, f2 = pack_features(vs1), pack_features(vs2)
    n_tasks, a = v_idx.shape
    b = u_idx.shape[1]
    step = task_chunk(a, b, max(DEFAULT_VOCAB))
    cands, scores = [], []
    for lo in range(0, n_tasks, step):
        u = u_idx[lo:lo + step]
        sc, loc = topk_first(_scores(f2, f1, v_idx[lo:lo + step], u, DEFAULT_VOCAB), k)
        cands.append(torch.where(sc > NEG, torch.gather(u, 1, loc.flatten(1)).view_as(loc), -1))
        scores.append(sc)
    return torch.cat(cands), torch.cat(scores)


def _neighbor_u_ids(b1: Buckets, nbs: torch.Tensor) -> torch.Tensor:
    """Bucket ids (..., ) of QT1 (-1 = outside) -> their vertex ids (..., cap1)."""
    return torch.where(nbs[..., None] >= 0, b1.vid[nbs.clamp(min=0).long()], -1)


def compute_similarity_all(vs1, vs2, b1: Buckets, b2: Buckets, nb: torch.Tensor, k: int):
    """ALL scheme: one task per bucket B ∈ QT2 against its 9 neighbors.

    Returns (cand (G², cap, k) global u ids, score (G², cap, k))."""
    grid2 = b2.grid * b2.grid
    u_idx = _neighbor_u_ids(b1, nb).reshape(grid2, 9 * b1.cap)
    return _task_topk(vs1, vs2, b2.vid, u_idx, k)


def _merge_pair_topk(cands, scores, grid2: int, k: int):
    """Alg. 5's Merge: per-pair top-k lists -> per-bucket top-k."""
    kk = scores.shape[-1]
    cands = cands.reshape(grid2, 9, -1, kk).transpose(1, 2).reshape(grid2, -1, 9 * kk)
    scores = scores.reshape(grid2, 9, -1, kk).transpose(1, 2).reshape(grid2, -1, 9 * kk)
    sc, loc = topk_first(scores, k)
    cand = torch.gather(cands, -1, loc)
    return torch.where(sc > NEG, cand, -1), sc


def pair_tasks(grid: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The PAIR task list: (QT2 bucket, QT1 neighbor bucket or -1) per task,
    9 consecutive tasks per QT2 bucket."""
    grid2 = grid * grid
    pair_b2 = torch.arange(grid2, device=device).repeat_interleave(9)
    pair_b1 = torch.as_tensor(neighbor_buckets(grid).reshape(-1), device=device)
    return pair_b2, pair_b1


def compute_similarity_pair(vs1, vs2, b1: Buckets, b2: Buckets, k: int):
    """PAIR scheme: one task per ⟨B, B'⟩ bucket pair + merge. Same results
    as ALL."""
    kk = min(k, b1.cap)  # per-pair priority-list width (Alg. 5)
    pair_b2, pair_b1 = pair_tasks(b2.grid, b2.vid.device)
    cands, scores = _task_topk(vs1, vs2, b2.vid[pair_b2], _neighbor_u_ids(b1, pair_b1), kk)
    return _merge_pair_topk(cands, scores, b2.grid * b2.grid, k)


def _scatter_vertex_major(cand_b, score_b, b2: Buckets, n2: int, k: int):
    """Bucket-major (G², cap, k) results -> per-vertex (n2, k) arrays.

    Only valid slots are scattered: each vertex id appears once, so no
    write order matters. (The JAX reference also scatters every padding slot
    to vertex 0, which can overwrite vertex 0's row.)"""
    vid = b2.vid.reshape(-1)
    ok = vid >= 0
    rows = vid[ok].long()
    cand = torch.zeros((n2, k), dtype=torch.int32, device=vid.device)
    score = torch.full((n2, k), NEG, dtype=torch.float32, device=vid.device)
    cand[rows] = cand_b.reshape(-1, k)[ok].to(torch.int32)
    score[rows] = score_b.reshape(-1, k)[ok]
    return cand, score


def compute_similarity(
    vs1: VertexSet, vs2: VertexSet, b1: Buckets, b2: Buckets, k: int = 4,
    scheme: Scheme = Scheme.PAIR,
):
    """``local`` substrate: top-k alignment candidates for every v ∈ V2.
    Returns per-vertex arrays (n2, k) cand / score."""
    if scheme == Scheme.ALL:
        nb = torch.as_tensor(neighbor_buckets(b2.grid), device=b2.vid.device)
        cand_b, score_b = compute_similarity_all(vs1, vs2, b1, b2, nb, k)
    else:
        cand_b, score_b = compute_similarity_pair(vs1, vs2, b1, b2, k)
    return _scatter_vertex_major(cand_b, score_b, b2, vs2.n, k)


def _gsana_all_rank(rank, world, group, ids, vs1, vs2, b1, b2, nb, *, k):
    """A mesh rank's slice of the ALL task list: QT2 buckets ``ids``."""
    u_idx = _neighbor_u_ids(b1, nb[ids]).reshape(ids.shape[0], 9 * b1.cap)
    return _task_topk(vs1, vs2, b2.vid[ids], u_idx, k)


def _gsana_pair_rank(rank, world, group, pair_b2, pair_b1, vs1, vs2, b1, b2, *, kk):
    """A mesh rank's slice of the PAIR task list: (QT2 bucket, QT1 bucket)."""
    return _task_topk(vs1, vs2, b2.vid[pair_b2], _neighbor_u_ids(b1, pair_b1), kk)


def _pad_tasks(t: torch.Tensor, p: int, fill: torch.Tensor) -> torch.Tensor:
    """``t`` padded to a multiple of ``p`` entries with ``fill``."""
    pad = -t.shape[0] % p
    return torch.cat([t, fill.expand(pad)]) if pad else t


def compute_similarity_mesh(
    vs1: VertexSet, vs2: VertexSet, b1: Buckets, b2: Buckets, k: int = 4,
    scheme: Scheme = Scheme.PAIR, *, mesh,
):
    """``mesh`` substrate: the same task set over the ranks of ``mesh`` (a
    :class:`~repro_torch.launch.mesh.NodeletMesh`).

    Bucket metadata is replicated (the shared QT plane); each rank runs its
    slice of the task list, padded to a multiple of the rank count (ALL with
    repeats of the last bucket, PAIR with repeats of task 0) and sliced off
    afterwards: compute moves to tasks, which is why the scheme and layout
    show up in the traffic model, not in collectives. Results equal the
    local substrate's."""
    grid2 = b2.grid * b2.grid
    dev = b2.vid.device
    if scheme == Scheme.ALL:
        nb = torch.as_tensor(neighbor_buckets(b2.grid), device=dev)
        ids = torch.arange(grid2, device=dev)
        outs = mesh.run(_gsana_all_rank, sharded=(_pad_tasks(ids, mesh.p, ids[-1]),),
                        replicated=(vs1, vs2, b1, b2, nb), k=k)
        cand_b = torch.cat([c for c, _ in outs])[:grid2]
        score_b = torch.cat([sc for _, sc in outs])[:grid2]
    else:
        pair_b2, pair_b1 = pair_tasks(b2.grid, dev)
        n_pairs = pair_b2.shape[0]
        outs = mesh.run(
            _gsana_pair_rank,
            sharded=(_pad_tasks(pair_b2, mesh.p, pair_b2[0]),
                     _pad_tasks(pair_b1, mesh.p, pair_b1[0])),
            replicated=(vs1, vs2, b1, b2), kk=min(k, b1.cap),
        )
        cands = torch.cat([c for c, _ in outs])[:n_pairs]
        scores = torch.cat([sc for _, sc in outs])[:n_pairs]
        cand_b, score_b = _merge_pair_topk(cands, scores, grid2, k)
    return _scatter_vertex_major(cand_b, score_b, b2, vs2.n, k)


def recall_at_k(cand, pi: np.ndarray) -> float:
    """Fraction of v ∈ V2 whose ground-truth partner is among its candidates."""
    pi = to_numpy(pi) if isinstance(pi, torch.Tensor) else np.asarray(pi)
    truth = np.empty(len(pi), dtype=np.int64)  # truth[v2] = v1
    truth[pi] = np.arange(len(pi))
    cand = to_numpy(cand) if isinstance(cand, torch.Tensor) else np.asarray(cand)
    return float((cand == truth[:, None]).any(axis=1).mean())


# -- layouts (BLK / HCB) and the placement/traffic model ----------------------


@dataclasses.dataclass(frozen=True)
class Placement:
    bucket_owner: np.ndarray  # (G²,) nodelet of each bucket (shared plane)
    vertex_owner1: np.ndarray  # (n1,)
    vertex_owner2: np.ndarray  # (n2,)


def layout_blk(b1: Buckets, b2: Buckets, n1: int, n2: int, p: int) -> Placement:
    """BLK: vertices by ID blocks, buckets round-robin — placement-oblivious."""
    grid2 = b1.grid * b1.grid
    return Placement(
        bucket_owner=np.arange(grid2) % p,
        vertex_owner1=(np.arange(n1) * p) // max(n1, 1),
        vertex_owner2=(np.arange(n2) * p) // max(n2, 1),
    )


def layout_hcb(b1: Buckets, b2: Buckets, p: int) -> Placement:
    """HCB: buckets in Hilbert order, contiguous runs per nodelet, balanced by
    estimated comparison load (the paper's edges-per-nodelet balancing)."""
    grid = b1.grid
    ranks = hilbert_order_of_buckets(grid)  # bucket -> hilbert rank
    order = np.argsort(ranks)  # rank -> bucket id
    nb = neighbor_buckets(grid)
    c1 = to_numpy(b1.count).astype(np.int64)
    c2 = to_numpy(b2.count).astype(np.int64)
    load = np.zeros(grid * grid, dtype=np.int64)
    for b in range(grid * grid):
        ns = nb[b]
        load[b] = c2[b] * c1[ns[ns >= 0]].sum()
    # greedy prefix split of the Hilbert sequence into p balanced segments
    total = load[order].sum()
    target = max(total / p, 1)
    owner = np.zeros(grid * grid, dtype=np.int64)
    acc, seg = 0, 0
    for b in order:
        owner[b] = seg
        acc += load[b]
        if acc >= target * (seg + 1) and seg < p - 1:
            seg += 1
    vid1 = to_numpy(b1.vid)
    vid2 = to_numpy(b2.vid)
    n1 = int(vid1.max()) + 1 if (vid1 >= 0).any() else 0
    n2 = int(vid2.max()) + 1 if (vid2 >= 0).any() else 0
    vo1 = np.zeros(n1, dtype=np.int64)
    vo2 = np.zeros(n2, dtype=np.int64)
    for b in range(grid * grid):
        vs = vid1[b][vid1[b] >= 0]
        vo1[vs] = owner[b]
        vs = vid2[b][vid2[b] >= 0]
        vo2[vs] = owner[b]
    return Placement(bucket_owner=owner, vertex_owner1=vo1, vertex_owner2=vo2)


@dataclasses.dataclass
class PlanStats:
    """Modeled execution statistics for a (layout x scheme) configuration."""

    total_comparisons: int
    makespan: float  # modeled parallel time (comparison units)
    speedup_model: float  # total / makespan
    traffic: TrafficStats
    rw_total: int  # paper's Σ RW(σ(u,v)) read/write volume (words)


def rw_sigma(deg_u: np.ndarray, deg_v: np.ndarray, ka_u: np.ndarray, ka_v: np.ndarray):
    """Paper §5.3: RW(σ) = RW(τ)+RW(Δ)+RW(τ_V)+RW(τ_E)+RW(C_V)
    = 4 + 4 + (|N(u)|+|N(v)|+2) + (|N(u)|+|N(v)|+2) + (|A(u)|+|A(v)|+2)."""
    return 8 + 2 * (deg_u + deg_v + 2) + (ka_u + ka_v + 2)


def _model_arrays(vs1, vs2, b1, b2):
    """Host copies the numpy models read: counts, degrees, attribute
    counts and bucket members of both graphs."""
    return (
        to_numpy(b1.count).astype(np.int64), to_numpy(b2.count).astype(np.int64),
        to_numpy(vs1.deg).astype(np.int64), to_numpy(vs2.deg).astype(np.int64),
        (to_numpy(vs1.attrs) >= 0).sum(axis=1), (to_numpy(vs2.attrs) >= 0).sum(axis=1),
        to_numpy(b1.vid), to_numpy(b2.vid),
    )


def plan_stats(
    vs1: VertexSet, vs2: VertexSet, b1: Buckets, b2: Buckets,
    placement: Placement, scheme: Scheme, p: int, threads_per_nodelet: int = 64,
    migration_penalty: float = 0.3,
) -> PlanStats:
    """Replay the task schedule in numpy with the paper's cost model.

    Task cost = comparisons (+ penalty per remote-side read); tasks run on the
    owner nodelet of their QT2 bucket; within a nodelet, tasks are spread
    LPT-greedily over its worker threads. Makespan = max worker finish time.
    """
    grid = b2.grid
    nb = neighbor_buckets(grid)
    c1, c2, deg1, deg2, na1, na2, vid1, vid2 = _model_arrays(vs1, vs2, b1, b2)

    tasks: list[tuple[int, float]] = []  # (nodelet, cost)
    migrations = 0
    rw_total = 0
    total_cmp = 0
    for b in range(grid * grid):
        if c2[b] == 0:
            continue
        home = int(placement.bucket_owner[b])
        v_ids = vid2[b][vid2[b] >= 0]
        v_remote = (placement.vertex_owner2[v_ids] != home).sum()
        pair_costs = []
        for bp in nb[b]:
            if bp < 0 or c1[bp] == 0:
                continue
            u_ids = vid1[bp][vid1[bp] >= 0]
            cmp_count = len(v_ids) * len(u_ids)
            total_cmp += cmp_count
            rw = rw_sigma(
                deg1[u_ids][None, :], deg2[v_ids][:, None],
                na1[u_ids][None, :], na2[v_ids][:, None],
            ).sum()
            rw_total += int(rw)
            u_remote = (placement.vertex_owner1[u_ids] != home).sum()
            # each comparison touching a remote-side vertex migrates there+back
            mig = len(v_ids) * int(u_remote) + int(v_remote) * len(u_ids)
            migrations += mig
            pair_costs.append(cmp_count + migration_penalty * mig)
        if not pair_costs:
            continue
        if scheme == Scheme.ALL:
            tasks.append((home, float(sum(pair_costs))))
        else:
            tasks.extend((home, float(cs)) for cs in pair_costs)

    # LPT within each nodelet's thread pool
    finish = np.zeros((p, threads_per_nodelet))
    for home, cost in sorted(tasks, key=lambda t: -t[1]):
        w = int(np.argmin(finish[home]))
        finish[home, w] += cost
    makespan = float(finish.max()) if tasks else 0.0
    total_cost = float(sum(c for _, c in tasks))
    return PlanStats(
        total_comparisons=total_cmp,
        makespan=max(makespan, 1e-9),
        speedup_model=total_cost / max(makespan, 1e-9),
        traffic=TrafficStats(migrations=int(migrations)),
        rw_total=int(rw_total),
    )


def gsana_rw_bytes(
    vs1: VertexSet, vs2: VertexSet, b1: Buckets, b2: Buckets,
    word_bytes: int = 8,
) -> int:
    """Paper §5.3 useful-work volume: Σ_tasks (|B| + |B||B'| + ΣΣ RW(σ)) × sizeof(u)."""
    grid = b2.grid
    nb = neighbor_buckets(grid)
    c1, c2, deg1, deg2, na1, na2, vid1, vid2 = _model_arrays(vs1, vs2, b1, b2)
    words = 0
    for b in range(grid * grid):
        if c2[b] == 0:
            continue
        v_ids = vid2[b][vid2[b] >= 0]
        for bp in nb[b]:
            if bp < 0 or c1[bp] == 0:
                continue
            u_ids = vid1[bp][vid1[bp] >= 0]
            rw = rw_sigma(
                deg1[u_ids][None, :], deg2[v_ids][:, None],
                na1[u_ids][None, :], na2[v_ids][:, None],
            ).sum()
            words += int(c2[b]) + int(c2[b]) * int(c1[bp]) + int(rw)
    return words * word_bytes


def gsana_effective_bw(
    vs1: VertexSet, vs2: VertexSet, b1: Buckets, b2: Buckets, seconds: float,
    word_bytes: int = 8,
) -> float:
    """Paper §5.3 bandwidth: the RW-model volume over wall time."""
    return gsana_rw_bytes(vs1, vs2, b1, b2, word_bytes) / max(seconds, 1e-12)
