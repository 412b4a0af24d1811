"""CSR-stripe SpMV: sliced-ELL over row stripes for skewed degree mixes.

The blocked-ELL kernel pads every row to the *global* max degree K — a
power-law matrix with one hub row executes its padding everywhere. This
variant keeps the CSR row structure at stripe granularity instead: rows are
cut into stripes of ``block_rows``, each stripe is padded only to *its own*
max width (rounded to a power of two so shapes bucket), and stripes of equal
width share one launch of the blocked-ELL kernel (``csrc/spmv_ell.cu``).

The stripe decomposition depends on the *values* of ``cols`` (degrees), so
it is built from a concrete matrix on the host (:func:`build_stripe_plan`,
one numpy pass) and can be reused for every later product with that matrix.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core.util import ceil_div
from ...device import to_numpy
from .kernel import spmv_ell


@dataclasses.dataclass(frozen=True)
class StripeBucket:
    """Stripes of equal padded width: one kernel launch per bucket."""

    k: int  # padded width every row in this bucket is sliced to
    rows: np.ndarray  # global row ids, concatenated stripe ranges (int32)


@dataclasses.dataclass(frozen=True)
class StripePlan:
    """Static stripe decomposition of one concrete matrix."""

    block_rows: int
    n_rows: int
    k_full: int
    buckets: tuple[StripeBucket, ...]

    @property
    def padded_slots(self) -> int:
        """Σ rows·K_stripe — the slots the striped kernels execute."""
        return sum(b.k * len(b.rows) for b in self.buckets)

    @property
    def waste_ratio(self) -> float:
        """Dense-ELL slots / striped slots: how much padding striping
        avoids (1.0 = none; hub-skewed matrices reach 5-50x)."""
        return (self.n_rows * self.k_full) / max(1, self.padded_slots)


def _row_widths(cols: np.ndarray) -> np.ndarray:
    """Per-row ELL width = last valid slot + 1 (0 for empty rows). Robust
    to non-left-packed planes."""
    valid = cols >= 0
    any_valid = valid.any(axis=1)
    last = cols.shape[1] - np.argmax(valid[:, ::-1], axis=1)
    return np.where(any_valid, last, 0).astype(np.int64)


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, int(v - 1).bit_length())


def build_stripe_plan(cols, block_rows: int = 256) -> StripePlan:
    """One numpy pass over concrete ``cols`` (a tensor or an array): stripe
    widths, power-of-two bucketing, row-id concatenation per bucket."""
    c = to_numpy(cols) if isinstance(cols, torch.Tensor) else np.asarray(cols)
    r, k = c.shape
    block = max(1, min(block_rows, r))
    widths = _row_widths(c)
    by_k: dict[int, list[np.ndarray]] = {}
    for s in range(ceil_div(r, block)):
        lo, hi = s * block, min((s + 1) * block, r)
        w = int(widths[lo:hi].max(initial=0))
        k_s = min(k, _pow2_at_least(w)) if w > 0 else 0
        by_k.setdefault(k_s, []).append(np.arange(lo, hi, dtype=np.int32))
    buckets = tuple(
        StripeBucket(k=k_s, rows=np.concatenate(ranges))
        for k_s, ranges in sorted(by_k.items())
    )
    return StripePlan(block_rows=block, n_rows=r, k_full=k, buckets=buckets)


def spmv_ell_stripes(
    cols: torch.Tensor,
    vals: torch.Tensor,
    x: torch.Tensor,
    *,
    block_rows: int = 256,
    plan: "StripePlan | None" = None,
) -> torch.Tensor:
    """y = A @ x through per-width stripe buckets (one blocked-ELL launch
    each). Without ``plan`` it is built from ``cols`` first."""
    if plan is None:
        plan = build_stripe_plan(cols, block_rows)
    r, k = cols.shape
    if (r, k) != (plan.n_rows, plan.k_full):
        raise ValueError(
            f"stripe plan built for shape {(plan.n_rows, plan.k_full)}, got {(r, k)}"
        )
    y = torch.zeros(r, dtype=vals.dtype, device=vals.device)
    for bucket in plan.buckets:
        if bucket.k == 0:
            continue  # all-empty stripes: y stays 0
        rows = torch.as_tensor(bucket.rows, device=cols.device).long()
        y[rows] = spmv_ell(
            cols[rows, : bucket.k].contiguous(),
            vals[rows, : bucket.k].contiguous(),
            x,
            block_rows=plan.block_rows,
        )
    return y
