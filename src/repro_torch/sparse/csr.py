"""CSR sparse-matrix container (paper §3.1 Fig. 2 layout).

The Emu stores the row-offset array striped across nodelets and keeps each
row's nonzeros together on one nodelet (jagged ``col``/``V`` arrays). Here the
container holds three tensors on one device; the *partitioned* views used by
the distributed ops live in :mod:`repro_torch.core.spmv`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix: three tensors + a static shape."""

    indptr: torch.Tensor  # (n_rows + 1,) int32
    indices: torch.Tensor  # (nnz,) int32 column ids
    data: torch.Tensor  # (nnz,) values
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    def row_lengths(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, device="cuda") -> "CSR":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        # row-major order, stable among duplicates: the reference's
        # np.lexsort((cols, rows)), skipped when the entries already are
        key = rows * max(shape[1], 1) + cols
        if not (key[1:] >= key[:-1]).all():
            order = np.argsort(key, kind="stable")
            rows, cols, vals = rows[order], cols[order], vals[order]
        # same offsets as the reference's np.add.at + cumsum, in one pass
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(np.bincount(rows, minlength=shape[0]))
        dev = resolve_device(device)
        return cls(
            indptr=torch.as_tensor(indptr.astype(np.int32), device=dev),
            indices=torch.as_tensor(cols.astype(np.int32), device=dev),
            data=torch.as_tensor(vals, device=dev),
            shape=tuple(int(s) for s in shape),
        )


def ell_coords(indptr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(row, slot) of every nonzero: the padded-ELL position each CSR entry
    lands in. Vectorised form of the reference builders' per-row loops."""
    lens = np.diff(indptr)
    rows = np.repeat(np.arange(len(lens)), lens)
    return rows, np.arange(int(indptr[-1])) - indptr[rows]


def spmv_csr_ref(a: CSR, x: torch.Tensor) -> torch.Tensor:
    """Reference CSR SpMV (y = A @ x) via segment-sum. Oracle for all SpMV paths."""
    row_of_nnz = torch.repeat_interleave(
        torch.arange(a.n_rows, device=a.data.device), a.row_lengths().long()
    )
    prod = a.data * x[a.indices.long()]
    return torch.zeros(a.n_rows, dtype=prod.dtype, device=prod.device).index_add_(
        0, row_of_nnz, prod
    )
