"""Distributed SpMV with the paper's replication strategy (S1, §3.1/§5.1).

Layout (paper Fig. 2): the row array is striped across ``P`` logical nodelets
(row ``r`` on nodelet ``r % P``); each row's nonzeros live with their row
(jagged arrays -> padded ELL planes per nodelet). The input vector ``x`` is
either

- **replicated** on every nodelet (paper's winning strategy): zero per-element
  communication after a one-time broadcast, or
- **striped** (``x[j]`` on nodelet ``j % P``): every nonzero whose column
  lives remotely triggers a thread migration on the Emu.

``grain`` = rows per task (paper Fig. 4): the local path executes row chunks
of ``grain`` rows in a loop (sequential across chunks, vector within), and
the CUDA kernel uses it as rows per block, and a mesh rank runs its own
plane in the same chunks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import trace
from ..device import resolve_device, to_numpy
from ..sparse.csr import CSR, ell_coords
from .strategies import MigratoryStrategy, TrafficStats
from .util import ceil_div, round_up


@dataclasses.dataclass(frozen=True)
class PartitionedELL:
    """Per-nodelet padded ELL planes. Global row r <-> (p=r%P, slot=r//P)."""

    cols: torch.Tensor  # (P, R_p, K) int32 global col ids, -1 pad
    vals: torch.Tensor  # (P, R_p, K)
    shape: tuple[int, int]

    @property
    def P(self) -> int:
        return self.cols.shape[0]

    @property
    def rows_per_nodelet(self) -> int:
        return self.cols.shape[1]

    @property
    def k(self) -> int:
        return self.cols.shape[2]


def partition_ell(
    a: CSR, p: int, k: int | None = None, pad_rows_to: int = 1, device="cuda"
) -> PartitionedELL:
    """Stripe a CSR matrix's rows over ``p`` nodelets as padded ELL planes."""
    dev = resolve_device(device)
    indptr = to_numpy(a.indptr).astype(np.int64)
    indices = to_numpy(a.indices)
    data = to_numpy(a.data)
    n = a.n_rows
    lens = np.diff(indptr)
    kmax = int(lens.max()) if n else 1
    k = k or max(kmax, 1)
    if kmax > k:
        raise ValueError(f"max row degree {kmax} > k={k}; use split_long_rows first")
    rp = round_up(ceil_div(n, p), pad_rows_to)
    cols = np.full((p, rp, k), -1, dtype=np.int32)
    vals = np.zeros((p, rp, k), dtype=data.dtype)
    rows, slots = ell_coords(indptr)
    cols[rows % p, rows // p, slots] = indices
    vals[rows % p, rows // p, slots] = data
    return PartitionedELL(
        cols=torch.as_tensor(cols, device=dev), vals=torch.as_tensor(vals, device=dev),
        shape=a.shape,
    )


def stripe_vector(x: torch.Tensor, p: int) -> torch.Tensor:
    """(N,) -> (P, N_p) striped layout, x[j] at (j % p, j // p). Pads with 0."""
    n = x.shape[0]
    npp = ceil_div(n, p)
    return F.pad(x, (0, npp * p - n)).reshape(npp, p).T


def unstripe_vector(xs: torch.Tensor, n: int) -> torch.Tensor:
    p, npp = xs.shape
    return xs.T.reshape(p * npp)[:n]


def _rows_kernel(cols, vals, x_full):
    """Compute one chunk of rows: masked gather + reduce. cols/vals (..., K)."""
    mask = cols >= 0
    xg = x_full[cols.clamp(min=0).long()]
    return torch.where(mask, vals * xg, torch.zeros_like(vals)).sum(dim=-1)


def _planes_in_chunks(cols, vals, x_full, grain: int) -> torch.Tensor:
    """(P', R_p, K) planes -> (P', R_p): row chunks of ``grain`` rows in
    turn, every plane at once. The local path runs all P planes, a mesh
    rank its own, so both reduce each row alike."""
    rp = cols.shape[1]
    y = torch.empty(cols.shape[:2], dtype=vals.dtype, device=vals.device)
    for lo in range(0, rp, grain):
        y[:, lo:lo + grain] = _rows_kernel(cols[:, lo:lo + grain], vals[:, lo:lo + grain], x_full)
    return y


def _grain(a: PartitionedELL, strategy: MigratoryStrategy) -> int:
    rp = a.rows_per_nodelet
    return max(1, min(strategy.dynamic_grain(rp), rp))


def spmv_local(a: PartitionedELL, x: torch.Tensor, strategy: MigratoryStrategy) -> torch.Tensor:
    """``local`` substrate: plain torch with the distributed path's
    semantics, all nodelets at once, row chunks of ``grain`` rows in turn.
    ``x``: full (N,) if ``strategy.replicate_x`` else striped (P, N_p).
    Returns y in striped (P, R_p) layout."""
    x_full = x if strategy.replicate_x else unstripe_vector(x, a.shape[1])
    return _planes_in_chunks(a.cols, a.vals, x_full, _grain(a, strategy))


def _spmv_rank(rank, world, group, cols_p, vals_p, x, *, n: int, replicate_x: bool, grain: int):
    """A mesh rank's SpMV on its (1, R_p, K) planes. With x replicated: pure
    local compute (the paper's S1 win); striped: ``all_gather`` the rank's
    (1, N_p) stripe of x first (the migrate pull)."""
    x_full = x if replicate_x else unstripe_vector(group.all_gather(x), n)
    return _planes_in_chunks(cols_p, vals_p, x_full, grain)


def spmv_mesh(a: PartitionedELL, x: torch.Tensor, strategy: MigratoryStrategy,
              mesh) -> torch.Tensor:
    """``mesh`` substrate: nodelet plane ``r`` on rank ``r`` of ``mesh`` (a
    :class:`~repro_torch.launch.mesh.NodeletMesh` of ``a.P`` ranks). Same
    input and output conventions as :func:`spmv_local`."""
    if strategy.replicate_x:
        sharded, replicated = (a.cols, a.vals), (x,)
    else:  # the striped (P, N_p) x: stripe r on rank r
        sharded, replicated = (a.cols, a.vals, x), ()
    ys = mesh.run(_spmv_rank, sharded=sharded, replicated=replicated, n=a.shape[1],
                  replicate_x=strategy.replicate_x, grain=_grain(a, strategy))
    return torch.cat(ys)


def spmv(a: PartitionedELL, x: torch.Tensor, strategy: MigratoryStrategy, *, mesh=None):
    """Dispatch shim: the ``local`` substrate without a mesh, the ``mesh``
    substrate over ``mesh`` with one (on the inputs' device)."""
    from ..engine.substrate import substrate_for_mesh

    return substrate_for_mesh(mesh, a.cols.device).kernel("spmv")(a, x, strategy=strategy)


def gather_result(y_striped: torch.Tensor, n: int) -> torch.Tensor:
    """(P, R_p) striped result -> global (N,) row order."""
    return unstripe_vector(y_striped, n)


def spmv_traffic(a: PartitionedELL, strategy: MigratoryStrategy) -> TrafficStats:
    """Paper-model traffic: striped x costs one migration per nonzero whose
    column owner differs from the row's nodelet; replication costs none."""
    if strategy.replicate_x:
        return TrafficStats(migrations=0, remote_writes=0)
    cols = to_numpy(a.cols)
    p_idx = np.arange(a.P)[:, None, None]
    remote = (cols >= 0) & ((cols % a.P) != p_idx)
    return TrafficStats(migrations=int(remote.sum()), remote_writes=0)


def spmv_bytes_moved(a: PartitionedELL, n: int, dtype_bytes: int = 4) -> int:
    """Bytes the paper's §5.1 bandwidth formula charges one SpMV with:
    sizeof(A) (true nonzeros: value + column index) + sizeof(x) + sizeof(y).
    """
    trace.count("sync.spmv_nnz")
    nnz = int((a.cols >= 0).sum())
    return nnz * (dtype_bytes + 4) + (n + a.shape[0]) * dtype_bytes


def effective_bandwidth(a: PartitionedELL, n: int, seconds: float, dtype_bytes: int = 4) -> float:
    """Paper §5.1 metric: (sizeof(A) + sizeof(x) + sizeof(y)) / time."""
    return spmv_bytes_moved(a, n, dtype_bytes) / max(seconds, 1e-12)
