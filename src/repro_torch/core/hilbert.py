"""Vectorized 2-D Hilbert curve order (paper §3.3.2 HCB layout).

``xy_to_d`` maps integer grid coordinates on a 2^order x 2^order grid to the
Hilbert distance; used to linearize quadtree buckets so that spatially
adjacent buckets (whose vertices get compared) land on the same shard.
"""
from __future__ import annotations

import numpy as np


def xy_to_d(order: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Hilbert distance of (x, y) on a 2^order grid. Vectorized int64."""
    x = np.asarray(x, dtype=np.int64).copy()
    y = np.asarray(y, dtype=np.int64).copy()
    rx = np.zeros_like(x)
    ry = np.zeros_like(y)
    d = np.zeros_like(x)
    s = np.int64(1) << (order - 1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        # rotate
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f, y_f = x.copy(), y.copy()
        x = np.where(flip, s - 1 - x_f, x_f)
        y = np.where(flip, s - 1 - y_f, y_f)
        x2, y2 = x.copy(), y.copy()
        x = np.where(swap, y2, x2)
        y = np.where(swap, x2, y2)
        s >>= 1
    return d


def d_to_xy(order: int, d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`xy_to_d` (scalar loop-free, vectorized)."""
    d = np.asarray(d, dtype=np.int64)
    t = d.copy()
    x = np.zeros_like(d)
    y = np.zeros_like(d)
    s = np.int64(1)
    while s < (np.int64(1) << order):
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        # rotate
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f, y_f = x.copy(), y.copy()
        x = np.where(flip, s - 1 - x_f, x_f)
        y = np.where(flip, s - 1 - y_f, y_f)
        x2, y2 = x.copy(), y.copy()
        x = np.where(swap, y2, x2)
        y = np.where(swap, x2, y2)
        x += s * rx
        y += s * ry
        t //= 4
        s *= 2
    return x, y


def hilbert_order_of_buckets(grid: int) -> np.ndarray:
    """Permutation: bucket (row-major id) -> Hilbert rank, for a grid x grid
    bucket decomposition. ``grid`` must be a power of two."""
    order = int(np.log2(grid))
    assert (1 << order) == grid, "grid must be a power of two"
    ids = np.arange(grid * grid)
    bx, by = ids % grid, ids // grid
    d = xy_to_d(order, bx, by)
    return np.argsort(np.argsort(d))  # rank of each bucket
