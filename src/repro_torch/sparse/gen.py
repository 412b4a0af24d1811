"""Input generators matching the paper's experiment inputs (§4.2).

- ``laplacian_2d``: d=2, k=5 point stencil => n^2 x n^2 pentadiagonal
  Laplacian (SpMV synthetic input, Figs. 4-6).
- ``erdos_renyi`` / ``rmat``: Graph500-style balanced vs skewed graphs
  (BFS, Figs. 7-9), scale/edge-factor parameterization.
- ``skewed_matrix``: degree-distribution proxies for the Table 3 real-world
  matrices (the published Avg/Max-degree signatures).

Every generator makes the same ``numpy.random.default_rng`` calls in the
same order as the JAX package's, so one seed gives identical arrays in both.
"""
from __future__ import annotations

import numpy as np

from .csr import CSR


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` by sort and adjacent compare. numpy 2.3 computes
    ``np.unique`` through a hash table, more than ten times slower than a
    sort for the tens of millions of int64 keys of a scale-20 graph."""
    a = np.sort(a)
    return a[np.concatenate([[True], a[1:] != a[:-1]])] if len(a) else a


def laplacian_2d(n: int, dtype=np.float32, device="cuda") -> CSR:
    """5-point stencil Laplacian on an n x n grid -> (n^2, n^2) pentadiagonal."""
    N = n * n
    idx = np.arange(N)
    r, c = divmod(idx, n)
    rows = [idx]
    cols = [idx]
    vals = [np.full(N, 4.0, dtype=dtype)]
    for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        rr, cc = r + dr, c + dc
        ok = (rr >= 0) & (rr < n) & (cc >= 0) & (cc < n)
        rows.append(idx[ok])
        cols.append((rr * n + cc)[ok])
        vals.append(np.full(ok.sum(), -1.0, dtype=dtype))
    return CSR.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals), (N, N),
        device=device,
    )


def erdos_renyi_edges(scale: int, edge_factor: int = 16, seed: int = 0) -> np.ndarray:
    """Uniform-random (balanced) edge list, Graph500 sizing: 2^scale vertices,
    edge_factor * 2^scale undirected edges. Returns (m, 2) int64."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    return rng.integers(0, n, size=(m, 2), dtype=np.int64)


def rmat_edges(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> np.ndarray:
    """RMAT (Graph500 Kronecker) edge list with skewed degree distribution."""
    rng = np.random.default_rng(seed)
    m = edge_factor * (1 << scale)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for _ in range(scale):
        u = rng.random(m)
        # quadrant probabilities a,b,c,d
        src_bit = u >= a + b
        dst_bit = ((u >= a) & (u < a + b)) | (u >= a + b + c)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return np.stack([src, dst], axis=1)


def edges_to_csr(
    edges: np.ndarray, n: int, symmetrize: bool = True, dtype=np.float32, device="cuda"
) -> CSR:
    """Edge list -> unweighted adjacency CSR (dedup, no self loops)."""
    e = edges
    if symmetrize:
        e = np.concatenate([e, e[:, ::-1]], axis=0)
    e = e[e[:, 0] != e[:, 1]]
    key = _sorted_unique(e[:, 0] * n + e[:, 1])
    rows, cols = key // n, key % n
    return CSR.from_coo(rows, cols, np.ones(len(rows), dtype=dtype), (n, n), device=device)


def skewed_matrix(
    n: int, avg_deg: float, max_deg: int, seed: int = 0, dtype=np.float32, device="cuda"
) -> CSR:
    """Matrix with given average and max row degree: lognormal-ish body plus a
    few max-degree hub rows (the Stanford/ins2 pathology)."""
    rng = np.random.default_rng(seed)
    if max_deg <= avg_deg * 2:
        lens = rng.poisson(avg_deg, size=n).clip(1, max_deg)
    else:
        sigma = 1.0
        mu = np.log(max(avg_deg, 1.01)) - sigma**2 / 2
        lens = np.exp(rng.normal(mu, sigma, size=n)).astype(np.int64).clip(1, max_deg)
        n_hubs = max(1, n // 2000)
        hubs = rng.choice(n, size=n_hubs, replace=False)
        lens[hubs] = max_deg
        # rescale body so the average lands near avg_deg
        body = np.setdiff1d(np.arange(n), hubs)
        target = avg_deg * n - n_hubs * max_deg
        if target > len(body):
            lens[body] = np.maximum(1, (lens[body] * target / lens[body].sum()).astype(np.int64))
    lens = np.minimum(lens, n)
    rows = np.repeat(np.arange(n), lens)
    cols = rng.integers(0, n, size=lens.sum())
    # dedupe within row
    key = _sorted_unique(rows * n + cols)
    rows, cols = key // n, key % n
    vals = rng.standard_normal(len(rows)).astype(dtype)
    return CSR.from_coo(rows, cols, vals, (n, n), device=device)
