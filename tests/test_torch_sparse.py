"""Generators, partitioners and containers of the PyTorch port against the JAX
package: the same seeds give identical arrays (same values, same dtypes).

The port vectorises the reference's per-row host loops (partition_ell,
partition_graph, bucketize, the GSANA metadata builder); these tests pin
that the arrays did not change."""
import numpy as np
import pytest
import torch

import repro.core as R
import repro.sparse as RS
import repro_torch.core as T
import repro_torch.sparse as TS
from repro.core.hilbert import hilbert_order_of_buckets as ref_hilbert
from repro_torch.convert import from_numpy, numpy_fields
from repro_torch.core.hilbert import hilbert_order_of_buckets

CPU = "cpu"


def assert_same(ref, port):
    """Every field equal: arrays by value and dtype, the rest by value."""
    fr, fp = numpy_fields(ref), numpy_fields(port)
    assert fr.keys() == fp.keys()
    for name in fr:
        if isinstance(fr[name], np.ndarray):
            assert fr[name].dtype == fp[name].dtype, name
            np.testing.assert_array_equal(fr[name], fp[name], err_msg=name)
        else:
            assert fr[name] == fp[name], name


@pytest.mark.parametrize("n", [16, 23, 32])
def test_laplacian_identical(n):
    assert_same(RS.laplacian_2d(n), TS.laplacian_2d(n, device=CPU))


@pytest.mark.parametrize("args", [(512, 4.0, 128, 9), (300, 4.0, 6, 1), (2000, 8.2, 386, 3)])
def test_skewed_matrix_identical(args):
    n, avg, mx, seed = args
    assert_same(RS.skewed_matrix(n, avg, mx, seed=seed),
                TS.skewed_matrix(n, avg, mx, seed=seed, device=CPU))


@pytest.mark.parametrize("kind,scale", [("er", 8), ("er", 10), ("rmat", 8), ("rmat", 10)])
def test_graph_edges_csr_and_partition_identical(kind, scale):
    gen_ref = RS.erdos_renyi_edges if kind == "er" else RS.rmat_edges
    gen_port = TS.erdos_renyi_edges if kind == "er" else TS.rmat_edges
    e = gen_ref(scale, 8, seed=3)
    np.testing.assert_array_equal(e, gen_port(scale, 8, seed=3))
    n = 1 << scale
    a_ref, a_port = RS.edges_to_csr(e, n), TS.edges_to_csr(e, n, device=CPU)
    assert_same(a_ref, a_port)
    assert_same(RS.partition_graph(a_ref, 8), TS.partition_graph(a_port, 8, device=CPU))
    k = int(np.diff(np.asarray(a_ref.indptr)).max()) + 2
    assert_same(RS.partition_graph(a_ref, 3, k=k), TS.partition_graph(a_port, 3, k=k, device=CPU))


@pytest.mark.parametrize("p,pad", [(8, 1), (8, 16), (5, 1)])
def test_partition_ell_identical(p, pad):
    assert_same(R.partition_ell(RS.laplacian_2d(19), p, pad_rows_to=pad),
                T.partition_ell(TS.laplacian_2d(19, device=CPU), p, pad_rows_to=pad, device=CPU))
    sk_ref = RS.skewed_matrix(400, 4.0, 64, seed=2)
    sk_port = TS.skewed_matrix(400, 4.0, 64, seed=2, device=CPU)
    assert_same(R.partition_ell(sk_ref, p, pad_rows_to=pad),
                T.partition_ell(sk_port, p, pad_rows_to=pad, device=CPU))


def test_partition_rejects_narrow_k():
    a = TS.laplacian_2d(6, device=CPU)
    with pytest.raises(ValueError, match="k=3"):
        T.partition_ell(a, 4, k=3, device=CPU)
    with pytest.raises(ValueError, match="k=3"):
        TS.partition_graph(a, 4, k=3, device=CPU)


@pytest.mark.parametrize("n,seed", [(256, 4), (512, 1), (384, 9)])
def test_alignment_pair_and_buckets_identical(n, seed):
    r1, r2, rpi = R.generate_alignment_pair(n, seed=seed)
    p1, p2, ppi = T.generate_alignment_pair(n, seed=seed, device=CPU)
    assert_same(r1, p1)
    assert_same(r2, p2)
    np.testing.assert_array_equal(rpi, ppi)
    grid = R.pick_grid(n, 32)
    assert grid == T.pick_grid(n, 32)
    for rv, pv in ((r1, p1), (r2, p2)):
        assert_same(R.bucketize(rv, grid), T.bucketize(pv, grid, device=CPU))
        assert_same(R.bucketize(rv, grid, cap=80), T.bucketize(pv, grid, cap=80, device=CPU))
    with pytest.raises(ValueError, match="overflow"):
        T.bucketize(p1, 2, cap=1, device=CPU)


@pytest.mark.parametrize("grid", [2, 4, 8, 64])
def test_grid_helpers_identical(grid):
    np.testing.assert_array_equal(R.neighbor_buckets(grid), T.neighbor_buckets(grid))
    np.testing.assert_array_equal(ref_hilbert(grid), hilbert_order_of_buckets(grid))


@pytest.mark.parametrize("n,p", [(10, 3), (64, 8), (1, 4)])
def test_stripe_roundtrip_matches_reference(n, p):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    xs_ref = np.asarray(R.stripe_vector(x, p))
    xs = T.stripe_vector(torch.as_tensor(x), p)
    np.testing.assert_array_equal(xs_ref, xs.numpy())
    np.testing.assert_array_equal(T.unstripe_vector(xs, n).numpy(), x)


def test_spmv_csr_ref_matches_reference():
    a_ref = RS.skewed_matrix(300, 5.0, 40, seed=7)
    a = TS.skewed_matrix(300, 5.0, 40, seed=7, device=CPU)
    x = np.random.default_rng(0).standard_normal(300).astype(np.float32)
    np.testing.assert_allclose(TS.spmv_csr_ref(a, torch.as_tensor(x)).numpy(),
                               np.asarray(RS.spmv_csr_ref(a_ref, x)), rtol=1e-5, atol=1e-5)


def test_convert_builds_port_containers_from_reference_fields():
    a = RS.laplacian_2d(9)
    e = R.partition_ell(a, 4)
    g = RS.partition_graph(RS.edges_to_csr(RS.erdos_renyi_edges(6, 4), 64), 4)
    vs1, _, _ = R.generate_alignment_pair(128, seed=2)
    b = R.bucketize(vs1, 4)
    for ref, cls in ((a, TS.CSR), (e, T.PartitionedELL), (g, TS.PartitionedGraph),
                     (vs1, T.VertexSet), (b, T.Buckets)):
        fields = numpy_fields(ref)
        port = from_numpy(cls, fields, device=CPU)
        assert isinstance(port, cls)
        assert_same(ref, port)
        for name, value in fields.items():
            if isinstance(value, np.ndarray):
                assert getattr(port, name).device.type == "cpu"
    with pytest.raises(ValueError, match="needs fields"):
        from_numpy(TS.CSR, {"indptr": np.zeros(2)}, device=CPU)
    with pytest.raises(TypeError):
        from_numpy(dict, {}, device=CPU)


def test_constructors_default_to_the_card(monkeypatch):
    """Without a card, a constructor that was not asked for the CPU raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = TS.laplacian_2d(4, device=CPU)
    vs1, _, _ = T.generate_alignment_pair(32, seed=0, device=CPU)
    calls = [
        lambda: TS.laplacian_2d(4),
        lambda: T.partition_ell(a, 2),
        lambda: TS.partition_graph(a, 2),
        lambda: T.generate_alignment_pair(32, seed=0),
        lambda: T.bucketize(vs1, 2),
        lambda: from_numpy(TS.CSR, numpy_fields(a)),
        lambda: TS.ell_from_csr(a),
        lambda: TS.split_long_rows(a, 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# (a name, both packages' builder of one matrix): a stencil, skewed rows, and
# a scale-free graph with empty rows (isolated vertices)
ELL_MATRICES = {
    "lap16": lambda mod, **kw: mod.laplacian_2d(16, **kw),
    "skewed": lambda mod, **kw: mod.skewed_matrix(600, 4.0, 64, seed=5, **kw),
    "rmat": lambda mod, **kw: mod.edges_to_csr(mod.rmat_edges(8, 4, seed=2), 256, **kw),
}


@pytest.mark.parametrize("k,pad", [(None, 1), (None, 16), ("max+3", 7)])
@pytest.mark.parametrize("name", list(ELL_MATRICES))
def test_ell_from_csr_identical(name, k, pad):
    a_ref, a = ELL_MATRICES[name](RS), ELL_MATRICES[name](TS, device=CPU)
    if k == "max+3":
        k = int(np.diff(np.asarray(a_ref.indptr)).max()) + 3
    ref = RS.ell_from_csr(a_ref, k=k, row_pad_to=pad)
    port = TS.ell_from_csr(a, k=k, row_pad_to=pad, device=CPU)
    assert_same(ref, port)
    assert (port.n_rows, port.k, port.nnz_padded) == (ref.n_rows, ref.k, ref.nnz_padded)
    x = np.random.default_rng(0).standard_normal(a.n_cols).astype(np.float32)
    # float32 row sums in another order: the reference's pallas-vs-local tolerance
    np.testing.assert_allclose(TS.spmv_ell_ref(port, torch.as_tensor(x)).numpy(),
                               np.asarray(RS.spmv_ell_ref(ref, x)), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="split rows first"):
        TS.ell_from_csr(a, k=int(np.diff(np.asarray(a_ref.indptr)).max()) - 1, device=CPU)


@pytest.mark.parametrize("k", [1, 3, 16, 1000])
@pytest.mark.parametrize("name", list(ELL_MATRICES))
def test_split_long_rows_identical(name, k):
    a_ref, a = ELL_MATRICES[name](RS), ELL_MATRICES[name](TS, device=CPU)
    ref, ref_owner = RS.split_long_rows(a_ref, k)
    port, owner = TS.split_long_rows(a, k, device=CPU)
    assert_same(ref, port)
    assert owner.dtype == ref_owner.dtype
    np.testing.assert_array_equal(owner, ref_owner)
