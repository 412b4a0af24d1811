"""Blocked-ELL SpMV: the CUDA kernel ``csrc/spmv_ell.cu`` and its plain
PyTorch version.

``spmv_ell`` launches the kernel on CUDA tensors and runs
:func:`spmv_ell_plain` on CPU tensors (:mod:`repro_torch.kernels.runtime`).
``block_rows`` is the paper's grain: rows per CUDA block. Any row count
works; the kernel masks the ragged last block itself, so nothing is padded.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...trace import count_launch
from ..build import check, load, stream_of
from ..runtime import on_card


def spmv_ell_plain(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_k vals[r,k] * x[cols[r,k]] over valid (col >= 0) slots."""
    mask = cols >= 0
    xg = x[cols.clamp(min=0).long()]
    return torch.where(mask, vals * xg, torch.zeros_like(vals)).sum(dim=1)


def check_planes(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, what: str) -> None:
    """Raise unless the kernels take these planes: cols (R, K) int32, vals
    (R, K) float32, x (N,) float32, all contiguous."""
    if vals.shape != cols.shape or cols.dim() != 2 or x.dim() != 1:
        raise ValueError(f"cols {tuple(cols.shape)}, vals {tuple(vals.shape)}, x {tuple(x.shape)}")
    if cols.dtype != torch.int32 or vals.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"need int32 cols and float32 vals/x, got {cols.dtype}, {vals.dtype}, {x.dtype}")
    if not (cols.is_contiguous() and vals.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{what} needs contiguous cols, vals and x")


@functools.cache
def _entry():
    lib = load("spmv_ell")
    fn = lib.spmv_ell_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib, fn


def spmv_ell(
    cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, *, block_rows: int = 256
) -> torch.Tensor:
    """y = A @ x for ELL planes. cols (R, K) int32, vals (R, K) float32,
    x (N,) float32 -> y (R,) float32."""
    if not on_card(cols, vals, x):
        return spmv_ell_plain(cols, vals, x)
    check_planes(cols, vals, x, "spmv_ell")
    r, k = cols.shape
    y = torch.empty(r, dtype=torch.float32, device=cols.device)
    lib, fn = _entry()
    block = max(1, min(int(block_rows), max(r, 1)))
    err = fn(cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(), r, k,
             x.shape[0], block, stream_of(y))
    check(lib, err, "spmv_ell")
    count_launch(spmv_ell)
    return y


spmv_ell.launches = 0  # kernel launches since the count was last set to 0
