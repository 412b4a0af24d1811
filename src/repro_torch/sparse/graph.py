"""STINGER-inspired partitioned graph (paper §3.2).

Vertices are striped across ``P`` logical nodelets exactly as on the Chick
(vertex ``v`` lives on nodelet ``v % P``); each vertex's adjacency stays with
its owner ("edge blocks from the local pool"). The blocked realization is a
padded (P, V_p, K) neighbor tensor — edge-block chains become contiguous
padded rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device, to_numpy
from .csr import CSR, ell_coords


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Graph striped over P logical nodelets.

    Global vertex id v  <->  (nodelet p = v % P, local slot l = v // P).
    """

    adj: torch.Tensor  # (P, V_p, K) int32 global neighbor ids, -1 = pad
    deg: torch.Tensor  # (P, V_p) int32 true degrees
    n_vertices: int  # (<= P * V_p)

    @property
    def P(self) -> int:
        return self.adj.shape[0]

    @property
    def v_per_nodelet(self) -> int:
        return self.adj.shape[1]

    @property
    def k(self) -> int:
        return self.adj.shape[2]

    @property
    def n_edges(self) -> int:
        return int(self.deg.sum())


def partition_graph(a: CSR, p: int, k: int | None = None, device="cuda") -> PartitionedGraph:
    """Stripe an adjacency CSR over ``p`` nodelets (v % p ownership)."""
    dev = resolve_device(device)
    indptr = to_numpy(a.indptr).astype(np.int64)
    indices = to_numpy(a.indices)
    n = a.n_rows
    vp = -(-n // p)
    lens = np.diff(indptr)
    kmax = int(lens.max()) if n else 1
    k = k or max(kmax, 1)
    if kmax > k:
        raise ValueError(f"max degree {kmax} > k={k}")
    adj = np.full((p, vp, k), -1, dtype=np.int32)
    deg = np.zeros((p, vp), dtype=np.int32)
    rows, slots = ell_coords(indptr)
    adj[rows % p, rows // p, slots] = indices
    v = np.arange(n)
    deg[v % p, v // p] = lens
    return PartitionedGraph(
        adj=torch.as_tensor(adj, device=dev), deg=torch.as_tensor(deg, device=dev),
        n_vertices=n,
    )


def owner_of(v, p: int):
    return v % p


def local_slot(v, p: int):
    return v // p


def global_id(p_idx, slot, p: int):
    return slot * p + p_idx
