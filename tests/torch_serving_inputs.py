"""Inputs shared by the serving-plane tests (``test_torch_service*.py``,
``test_torch_request_api.py``, ``test_torch_wire.py``): the reference's and
the port's SpMV, BFS and GSANA inputs built from the same numpy arrays (the
JAX package's generators, carried across by ``convert.from_numpy``), and the
six main-path signatures the tests rotate over."""
import functools

import numpy as np
import torch

import repro.core as R
import repro.engine as J
import repro.sparse as RS
import repro_torch.core as T
from repro_torch.convert import from_numpy, numpy_fields
from repro_torch.core.gsana_data import Buckets, VertexSet
from repro_torch.core.spmv import PartitionedELL
from repro_torch.engine import BFSInputs, GSANAInputs, SpMVInputs
from repro_torch.sparse.graph import PartitionedGraph

CPU = "cpu"
SPMV_TOL = dict(rtol=1e-5, atol=1e-5)
GSANA_ATOL = 1e-6


def _port(cls, ref_obj):
    return from_numpy(cls, numpy_fields(ref_obj), device=CPU)


@functools.cache
def spmv_pair(n: int = 16, seed: int = 0):
    """(reference SpMVInputs, port SpMVInputs) on ``laplacian_2d(n)``, P=8."""
    a = R.partition_ell(RS.laplacian_2d(n), 8)
    x = np.random.default_rng(seed).standard_normal(n * n).astype(np.float32)
    return J.SpMVInputs(a, x), SpMVInputs(_port(PartitionedELL, a), torch.from_numpy(x.copy()))


@functools.cache
def bfs_pair(scale: int = 9, degree: int = 6, seed: int = 2, root: int = 3):
    """(reference, port) BFSInputs on ``erdos_renyi_edges(scale, degree)``, P=8."""
    n = 1 << scale
    g = RS.partition_graph(RS.edges_to_csr(RS.erdos_renyi_edges(scale, degree, seed=seed), n), 8)
    return J.BFSInputs(g, root), BFSInputs(_port(PartitionedGraph, g), root)


@functools.cache
def gsana_pair(n: int = 512, seed: int = 1):
    """(reference, port) GSANAInputs on ``generate_alignment_pair(n)``, k=4."""
    r1, r2, pi = R.generate_alignment_pair(n, seed=seed)
    grid = R.pick_grid(n, 32)
    cap = max(R.bucketize(r1, grid).cap, R.bucketize(r2, grid).cap)
    b1, b2 = R.bucketize(r1, grid, cap=cap), R.bucketize(r2, grid, cap=cap)
    ref = J.GSANAInputs(r1, r2, b1, b2, k=4, ground_truth=pi)
    port = GSANAInputs(_port(VertexSet, r1), _port(VertexSet, r2), _port(Buckets, b1),
                       _port(Buckets, b2), k=4, ground_truth=pi)
    return ref, port


def signatures(pkg: str):
    """The six main-path signatures ``(op, inputs, strategy)`` of one
    package (``"ref"`` or ``"port"``): SpMV with S1 on and off, BFS
    remote_write and migrate, GSANA HCB/PAIR and BLK/PAIR."""
    core, i = (R, 0) if pkg == "ref" else (T, 1)
    st = core.MigratoryStrategy
    return [
        ("spmv", spmv_pair()[i], st()),
        ("spmv", spmv_pair()[i], st(replicate_x=False)),
        ("bfs", bfs_pair()[i], st(comm=core.Comm.REMOTE_WRITE)),
        ("bfs", bfs_pair()[i], st(comm=core.Comm.MIGRATE)),
        ("gsana", gsana_pair()[i], st(layout=core.Layout.HCB, scheme=core.Scheme.PAIR)),
        ("gsana", gsana_pair()[i], st(layout=core.Layout.BLK, scheme=core.Scheme.PAIR)),
    ]


def assert_equal_results(got, want):
    """Bit-identity of two port results (a tensor or a tuple of them)."""
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    else:
        assert torch.equal(got, want)


def assert_matches_reference(op: str, got, want):
    """A port result against the reference's: BFS parents equal, SpMV
    within ``SPMV_TOL``, GSANA scores allclose and candidates equal where
    the scores are not tied and the vertex is not 0 (the reference's
    ``_scatter_vertex_major`` overwrites vertex 0 with padding slots)."""
    if op == "bfs":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    elif op == "spmv":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SPMV_TOL)
    else:
        (cand, score), (rc, rs) = got, want
        cand, score, rc, rs = cand.numpy()[1:], score.numpy()[1:], np.asarray(rc)[1:], np.asarray(rs)[1:]
        np.testing.assert_allclose(score, rs, rtol=0, atol=GSANA_ATOL)
        tied = np.zeros(score.shape, bool)
        tied[:, 1:] |= np.isclose(score[:, 1:], score[:, :-1], rtol=0, atol=GSANA_ATOL)
        tied[:, :-1] |= np.isclose(score[:, :-1], score[:, 1:], rtol=0, atol=GSANA_ATOL)
        np.testing.assert_array_equal(np.where(tied, -2, cand), np.where(tied, -2, rc))
