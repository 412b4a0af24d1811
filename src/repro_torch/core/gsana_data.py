"""GSANA alignment-problem substrate: vertex metadata, 2-D placement,
quadtree-leaf (grid) bucketization, and a DBLP-like pair generator.

Paper §3.3: GSANA places vertices on a 2-D plane from global structure; we
generate pairs with a latent ground-truth placement (corresponding vertices
land near each other, as GSANA's structural embedding achieves on DBLP).
Vertex metadata (types / neighbor types / edge types / attributes) is stored
in **sorted fixed-width arrays** — the paper's "metadata of a vertex's
neighborhood in sorted arrays" regularization, padded with -1.

The generator makes the JAX package's ``default_rng`` calls in the same
order, so one seed gives identical arrays; the per-vertex Python loops of
the reference are vectorised with numpy, which the tests pin.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device, to_numpy


@dataclasses.dataclass(frozen=True)
class VertexSet:
    """One graph's vertices + metadata used by the similarity function σ."""

    pos: torch.Tensor  # (n, 2) float32 in [0,1)^2
    deg: torch.Tensor  # (n,) int32
    vtype: torch.Tensor  # (n,) int32
    ntypes: torch.Tensor  # (n, Kn) int32 sorted asc, -1 pad — adjacent vertex types
    etypes: torch.Tensor  # (n, Ke) int32 sorted asc, -1 pad — adjacent edge types
    attrs: torch.Tensor  # (n, Ka) int32 sorted asc, -1 pad — vertex attributes

    @property
    def n(self) -> int:
        return self.pos.shape[0]


@dataclasses.dataclass(frozen=True)
class Buckets:
    """Grid bucketization (uniform-depth quadtree leaves)."""

    vid: torch.Tensor  # (grid*grid, cap) int32 vertex ids, -1 pad
    count: torch.Tensor  # (grid*grid,) int32
    grid: int  # power of two

    @property
    def cap(self) -> int:
        return self.vid.shape[1]


def _pad_sorted(keys: np.ndarray, vals: np.ndarray, n: int, width: int) -> np.ndarray:
    """Row ``i`` = the ``width`` smallest of ``vals[keys == i]``, ascending,
    -1 padded: the reference's sort-and-truncate per row, for all rows at
    once."""
    order = np.lexsort((vals, keys))
    keys, vals = keys[order], vals[order]
    counts = np.bincount(keys, minlength=n)
    starts = np.cumsum(counts) - counts
    rank = np.arange(len(keys)) - starts[keys]
    keep = rank < width
    out = np.full((n, width), -1, dtype=np.int32)
    out[keys[keep], rank[keep]] = vals[keep]
    return out


def _metadata_from_edges(
    n: int, edges: np.ndarray, vtype: np.ndarray, etype: np.ndarray,
    attrs_list: list[np.ndarray], kn: int, ke: int, ka: int,
) -> dict[str, np.ndarray]:
    # every edge (u, v) adds vtype[v], t to u's lists and vtype[u], t to v's
    keys = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int64)
    ntype = np.concatenate([vtype[edges[:, 1]], vtype[edges[:, 0]]]).astype(np.int32)
    etypes = np.concatenate([etype, etype]).astype(np.int32)
    attr_keys = np.repeat(np.arange(n), [len(a) for a in attrs_list])
    attr_vals = np.concatenate(attrs_list).astype(np.int32)
    return dict(
        deg=np.bincount(keys, minlength=n).astype(np.int32),
        ntypes=_pad_sorted(keys, ntype, n, kn),
        etypes=_pad_sorted(keys, etypes, n, ke),
        attrs=_pad_sorted(attr_keys, attr_vals, n, ka),
    )


def _vertex_set(pos, vtype, md, dev) -> VertexSet:
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return VertexSet(
        pos=t(pos), deg=t(md["deg"]), vtype=t(vtype), ntypes=t(md["ntypes"]),
        etypes=t(md["etypes"]), attrs=t(md["attrs"]),
    )


def generate_alignment_pair(
    n: int,
    avg_deg: float = 6.0,
    n_types: int = 8,
    n_etypes: int = 6,
    n_attr_vocab: int = 64,
    kn: int = 16,
    ke: int = 16,
    ka: int = 8,
    drop_frac: float = 0.1,
    pos_noise: float = 0.01,
    seed: int = 0,
    device="cuda",
) -> tuple[VertexSet, VertexSet, np.ndarray]:
    """DBLP-like pair: graph2 is a perturbed relabeling of graph1.

    Returns (vs1, vs2, pi) with ground truth pi: V1 -> V2 ids.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    e1 = rng.integers(0, n, size=(m, 2), dtype=np.int64)
    e1 = e1[e1[:, 0] != e1[:, 1]]
    vtype1 = rng.integers(0, n_types, size=n).astype(np.int32)
    etype1 = rng.integers(0, n_etypes, size=len(e1)).astype(np.int32)
    attr_counts = rng.integers(1, ka + 1, size=n)
    attrs1 = [rng.choice(n_attr_vocab, size=c, replace=False) for c in attr_counts]

    # latent placement: corresponding vertices land close on the plane
    pos_true = rng.random((n, 2)).astype(np.float32)
    pos1 = np.clip(pos_true + rng.normal(0, pos_noise, (n, 2)).astype(np.float32), 0, 0.999)

    # graph2: relabel + perturb edges, keep types/attrs (metadata preserved)
    pi = rng.permutation(n).astype(np.int64)
    keep = rng.random(len(e1)) >= drop_frac
    e2 = pi[e1[keep]]
    extra = rng.integers(0, n, size=(int(len(e1) * drop_frac), 2), dtype=np.int64)
    extra = extra[extra[:, 0] != extra[:, 1]]
    e2 = np.concatenate([e2, extra], axis=0)
    etype2 = np.concatenate(
        [etype1[keep], rng.integers(0, n_etypes, size=len(extra)).astype(np.int32)]
    )
    vtype2 = np.empty(n, dtype=np.int32)
    vtype2[pi] = vtype1
    inv_pi = np.argsort(pi)
    attrs2 = [attrs1[u] for u in inv_pi]  # attrs2[pi[u]] = attrs1[u]
    pos2 = np.empty((n, 2), dtype=np.float32)
    pos2[pi] = np.clip(pos_true + rng.normal(0, pos_noise, (n, 2)).astype(np.float32), 0, 0.999)

    md1 = _metadata_from_edges(n, e1, vtype1, etype1, attrs1, kn, ke, ka)
    md2 = _metadata_from_edges(n, e2, vtype2, etype2, attrs2, kn, ke, ka)
    return _vertex_set(pos1, vtype1, md1, dev), _vertex_set(pos2, vtype2, md2, dev), pi


def bucketize(vs: VertexSet, grid: int, cap: int | None = None, device="cuda") -> Buckets:
    """Assign vertices to grid x grid buckets by 2-D position; pad to cap."""
    dev = resolve_device(device)
    pos = to_numpy(vs.pos)
    bx = np.minimum((pos[:, 0] * grid).astype(np.int64), grid - 1)
    by = np.minimum((pos[:, 1] * grid).astype(np.int64), grid - 1)
    b = by * grid + bx
    order = np.argsort(b, kind="stable")
    counts = np.bincount(b, minlength=grid * grid)
    if cap is None:
        cap = max(1, int(counts.max()))
    if counts.max() > cap:
        raise ValueError(f"bucket overflow: max load {counts.max()} > cap {cap}; raise grid")
    vid = np.full((grid * grid, cap), -1, dtype=np.int32)
    starts = np.cumsum(counts) - counts
    vid[b[order], np.arange(len(order)) - starts[b[order]]] = order
    return Buckets(
        vid=torch.as_tensor(vid, device=dev),
        count=torch.as_tensor(counts.astype(np.int32), device=dev),
        grid=grid,
    )


def pick_grid(n: int, target_bucket: int) -> int:
    """Power-of-two grid so the average bucket holds ~target_bucket vertices
    (paper Table 4 pairs |V| with a bucket size |B|)."""
    g = 1
    while (n / (g * g)) > target_bucket:
        g *= 2
    return max(g, 2)


def neighbor_buckets(grid: int) -> np.ndarray:
    """(grid*grid, 9) neighbor bucket ids (3x3 window, -1 outside) — the
    quadtree-neighbor task structure of Fig. 3."""
    ids = np.arange(grid * grid)
    bx, by = ids % grid, ids // grid
    out = np.full((grid * grid, 9), -1, dtype=np.int32)
    j = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            xx, yy = bx + dx, by + dy
            ok = (xx >= 0) & (xx < grid) & (yy >= 0) & (yy < grid)
            out[ok, j] = (yy * grid + xx)[ok]
            j += 1
    return out
