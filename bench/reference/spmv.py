"""Plain reference for the SpMV cells: y = A x for the 2-D 5-point Laplacian,
worked out from the stencil itself (4 on the diagonal, -1 for each of the
four grid neighbours that exists), not from the ELL planes the program reads.

Imports torch only: nothing of the program, no kernel, no oracle of it.
"""
from __future__ import annotations

import torch


def _shifted(g: torch.Tensor) -> "list[tuple[tuple[slice, slice], torch.Tensor]]":
    """The four neighbour terms as (destination slice, source view): the
    row above, below, left and right of every point that has one."""
    a = slice(None)
    return [
        ((slice(1, None), a), g[:-1, :]),
        ((slice(None, -1), a), g[1:, :]),
        ((a, slice(1, None)), g[:, :-1]),
        ((a, slice(None, -1)), g[:, 1:]),
    ]


def laplacian_apply(x: torch.Tensor, n: int, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(n*n,) x -> (n*n,) y = L x, computed in ``dtype`` throughout."""
    g = x.to(dtype).view(n, n)
    y = 4 * g
    for dst, src in _shifted(g):
        y[dst] -= src
    return y.reshape(-1)


def laplacian_abs(x: torch.Tensor, n: int) -> torch.Tensor:
    """sum_k |a_rk x_k| per row: the scale a row's rounding error is held to."""
    g = x.to(torch.float64).abs().view(n, n)
    s = 4 * g
    for dst, src in _shifted(g):
        s[dst] += src
    return s.reshape(-1)


def max_rel_error(y: torch.Tensor, x: torch.Tensor, n: int) -> float:
    """max over rows of |y - L x| / sum_k |a_rk x_k|, with L x in float64."""
    ref = laplacian_apply(x, n)
    err = (y.to(torch.float64) - ref).abs() / laplacian_abs(x, n).clamp_min(1e-300)
    return float(err.max())


def control(x: torch.Tensor, n: int) -> torch.Tensor:
    """The reference one precision below the configuration's float32:
    inputs and arithmetic in bfloat16, the result handed back as float32."""
    return laplacian_apply(x, n, torch.bfloat16).to(torch.float32)
