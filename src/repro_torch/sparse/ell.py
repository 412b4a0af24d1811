"""Padded ELL / blocked-ELL formats.

The accelerator re-think of the Emu's fine-grained jagged rows: the Chick's
NCDRAM is efficient at <64 B accesses, a GPU wants whole rows of a block
to walk the same number of slots — so rows are padded into planes of equal
width. ``ELL`` is the dense-padded format the CUDA SpMV kernel consumes;
padding slots carry ``col = -1`` and ``val = 0`` so they are arithmetic
no-ops.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device, to_numpy
from .csr import CSR, ell_coords


@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK: (n_rows, k) column-index / value planes, row-major padded."""

    cols: torch.Tensor  # (n_rows, k) int32, -1 = padding
    vals: torch.Tensor  # (n_rows, k)
    shape: tuple[int, int]  # static logical shape

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    @property
    def nnz_padded(self) -> int:
        return self.cols.shape[0] * self.cols.shape[1]


def ell_from_csr(a: CSR, k: int | None = None, row_pad_to: int = 1, device="cuda") -> ELL:
    """Convert CSR -> padded ELL. ``k`` defaults to max row degree.

    ``row_pad_to`` pads the row count (for tile-aligned kernels).
    """
    indptr = to_numpy(a.indptr).astype(np.int64)
    indices = to_numpy(a.indices)
    data = to_numpy(a.data)
    n = a.n_rows
    lens = np.diff(indptr)
    kmax = int(lens.max()) if n else 0
    if k is None:
        k = max(kmax, 1)
    if kmax > k:
        raise ValueError(f"k={k} < max row degree {kmax}; split rows first")
    n_pad = -(-n // row_pad_to) * row_pad_to
    cols = np.full((n_pad, k), -1, dtype=np.int32)
    vals = np.zeros((n_pad, k), dtype=data.dtype)
    rows, slots = ell_coords(indptr)
    cols[rows, slots] = indices
    vals[rows, slots] = data
    dev = resolve_device(device)
    return ELL(cols=torch.as_tensor(cols, device=dev), vals=torch.as_tensor(vals, device=dev),
               shape=a.shape)


def spmv_ell_ref(a: ELL, x: torch.Tensor) -> torch.Tensor:
    """Reference ELL SpMV: masked gather + row-sum (plain torch oracle)."""
    mask = a.cols >= 0
    xg = x[a.cols.clamp(min=0).long()]
    y = torch.where(mask, a.vals * xg, torch.zeros_like(a.vals)).sum(dim=1)
    return y[: a.n_rows]


def split_long_rows(a: CSR, k: int, device="cuda") -> tuple[CSR, np.ndarray]:
    """Split rows with degree > k into chains of sub-rows (vertex-delegate
    style mitigation for Table 3's high-max-degree pathology, §5.1).

    Returns the split CSR and an int32 map ``sub_row -> original_row`` so the
    caller can segment-sum sub-row results back together. The nonzeros keep
    their order; only the row offsets change.
    """
    indptr = to_numpy(a.indptr).astype(np.int64)
    indices = to_numpy(a.indices)
    data = to_numpy(a.data)
    lens = np.diff(indptr)
    # a row of degree <= k stays one sub-row (empty rows included); a longer
    # one becomes ceil(len / k) sub-rows of k, the last holding the rest
    n_sub = np.where(lens <= k, 1, -(-lens // max(k, 1)))
    owner = np.repeat(np.arange(a.n_rows), n_sub)
    first = np.cumsum(n_sub) - n_sub
    j = np.arange(len(owner)) - first[owner]
    sub_lens = np.where(lens[owner] <= k, lens[owner], np.minimum(k, lens[owner] - j * k))
    nip = np.zeros(len(owner) + 1, dtype=np.int64)
    nip[1:] = np.cumsum(sub_lens)
    span = slice(int(indptr[0]), int(indptr[-1]))
    dev = resolve_device(device)
    out = CSR(
        indptr=torch.as_tensor(nip.astype(np.int32), device=dev),
        indices=torch.as_tensor(indices[span], device=dev),
        data=torch.as_tensor(data[span], device=dev),
        shape=(len(owner), a.n_cols),
    )
    return out, owner.astype(np.int32)
