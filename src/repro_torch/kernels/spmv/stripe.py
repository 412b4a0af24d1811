"""CSR-stripe SpMV: sliced-ELL over row stripes for skewed degree mixes.

The blocked-ELL kernel pads every row to the *global* max degree K — a
power-law matrix with one hub row executes its padding everywhere. This
variant keeps the CSR row structure at stripe granularity instead: rows are
cut into stripes of ``block_rows``, and each stripe reads only *its own*
max width (rounded to a power of two, as the JAX package buckets widths).

The stripe decomposition depends on the *values* of ``cols`` (degrees), so
it is built from a concrete matrix on the host (:func:`build_stripe_plan`,
one numpy pass) and can be reused for every later product with that matrix.

``spmv_ell_stripes`` launches the CUDA kernel ``spmv_stripes_f32`` of
``csrc/spmv_ell.cu`` on CUDA tensors: one launch, the planes read in place,
the plan's width table uploaded once per device. On CPU tensors it runs
:func:`spmv_stripes_plain`, the JAX package's loop (one blocked-ELL product
per width bucket over gathered rows) with the ELL kernel's plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ...core.util import ceil_div
from ...device import to_numpy
from ...trace import count_launch
from ..build import check, load, stream_of
from ..runtime import on_card
from .kernel import check_planes, spmv_ell_plain


@dataclasses.dataclass(frozen=True)
class StripeBucket:
    """Stripes of equal padded width, as the JAX package's plan holds them;
    derived from the width table on demand (:attr:`StripePlan.buckets`)."""

    k: int  # padded width every row in this bucket is sliced to
    rows: np.ndarray  # global row ids, concatenated stripe ranges (int32)


@dataclasses.dataclass(frozen=True)
class StripePlan:
    """Static stripe decomposition of one concrete matrix."""

    block_rows: int
    n_rows: int
    k_full: int
    widths: np.ndarray  # (n_stripes,) int32: the slots stripe s reads
    # widths as an int32 tensor per device, uploaded at first use
    _device_widths: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def padded_slots(self) -> int:
        """Σ rows·K_stripe — the slots the striped kernels execute."""
        starts = self.block_rows * np.arange(len(self.widths), dtype=np.int64)
        rows = np.minimum(self.block_rows, self.n_rows - starts)
        return int((rows * self.widths).sum())

    @property
    def buckets(self) -> tuple[StripeBucket, ...]:
        """The stripes grouped by width, in ascending width, each bucket's
        row ids in ascending order: the JAX package's plan."""
        width_of_row = np.repeat(self.widths, self.block_rows)[: self.n_rows]
        return tuple(
            StripeBucket(k=int(k_s), rows=np.flatnonzero(width_of_row == k_s).astype(np.int32))
            for k_s in np.unique(self.widths)
        )

    @property
    def waste_ratio(self) -> float:
        """Dense-ELL slots / striped slots: how much padding striping
        avoids (1.0 = none; hub-skewed matrices reach 5-50x)."""
        return (self.n_rows * self.k_full) / max(1, self.padded_slots)

    def widths_on(self, device: torch.device) -> torch.Tensor:
        """The width table on ``device``, copied there once."""
        t = self._device_widths.get(device)
        if t is None:
            t = self._device_widths[device] = torch.as_tensor(self.widths, device=device)
        return t


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
    """One numpy pass over concrete ``cols`` (a tensor or an array): each
    stripe's width, rounded up to a power of two."""
    c = to_numpy(cols) if isinstance(cols, torch.Tensor) else np.asarray(cols)
    r, k = c.shape
    block = max(1, min(block_rows, r))
    row_widths = _row_widths(c)
    widths = np.zeros(ceil_div(r, block), dtype=np.int32)
    for s in range(len(widths)):
        w = int(row_widths[s * block:(s + 1) * block].max(initial=0))
        widths[s] = min(k, _pow2_at_least(w)) if w > 0 else 0
    return StripePlan(block_rows=block, n_rows=r, k_full=k, widths=widths)


def spmv_stripes_plain(
    cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, plan: StripePlan
) -> torch.Tensor:
    """The JAX package's loop: per width bucket, gather its rows' first k
    slots, take the ELL product, scatter into y."""
    y = torch.zeros(plan.n_rows, dtype=vals.dtype, device=vals.device)
    width_of_row = plan.widths_on(cols.device).repeat_interleave(plan.block_rows)[: plan.n_rows]
    for k_s in np.unique(plan.widths).tolist():
        if k_s == 0:
            continue  # all-empty stripes: y stays 0
        rows = torch.nonzero(width_of_row == k_s).squeeze(1)
        y[rows] = spmv_ell_plain(cols[rows, :k_s], vals[rows, :k_s], x)
    return y


@functools.cache
def _entry():
    lib = load("spmv_ell")
    fn = lib.spmv_stripes_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


def spmv_ell_stripes(
    cols: torch.Tensor,
    vals: torch.Tensor,
    x: torch.Tensor,
    *,
    block_rows: int = 256,
    plan: "StripePlan | None" = None,
) -> torch.Tensor:
    """y = A @ x reading each stripe's own width of the ELL planes cols
    (R, K) int32, vals (R, K) float32, x (N,) float32 -> y (R,) float32.
    Without ``plan`` it is built from ``cols`` first."""
    if plan is None:
        plan = build_stripe_plan(cols, block_rows)
    r, k = cols.shape
    if (r, k) != (plan.n_rows, plan.k_full):
        raise ValueError(
            f"stripe plan built for shape {(plan.n_rows, plan.k_full)}, got {(r, k)}"
        )
    if not on_card(cols, vals, x):
        return spmv_stripes_plain(cols, vals, x, plan)
    check_planes(cols, vals, x, "spmv_ell_stripes")
    widths = plan.widths_on(cols.device)
    y = torch.empty(r, dtype=torch.float32, device=cols.device)
    lib, fn = _entry()
    err = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(), widths.data_ptr(),
             r, k, x.shape[0], plan.block_rows, stream_of(y))
    check(lib, err, "spmv_ell_stripes")
    count_launch(spmv_ell_stripes)
    return y


spmv_ell_stripes.launches = 0  # kernel launches since the count was last set to 0
