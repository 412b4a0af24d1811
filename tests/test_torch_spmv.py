"""SpMV in the PyTorch port against the JAX package, on the CPU.

The same numpy-built matrix and vector go through the JAX ``local`` and
``pallas`` (interpret mode) substrates and the port's ``local`` and ``cuda``
substrates (the kernel's plain version, since the tensors lie on the CPU).
Tolerance ``rtol=atol=1e-5``: the fp32 sums run in another order, the
reference's own pallas-vs-local tolerance."""
from dataclasses import astuple

import numpy as np
import pytest
import torch

import repro.core as R
import repro.sparse as RS
import repro_torch.core as T
import repro_torch.sparse as TS
from repro.engine import Request as JRequest, SpMVInputs as JSpMVInputs, run as jrun
from repro.kernels.spmv.ops import spmv as jspmv
from repro.kernels.spmv.stripe import build_stripe_plan as jbuild_stripe_plan
from repro_torch.engine import CudaSubstrate, LocalSubstrate, Request, SpMVInputs, run
from repro_torch.kernels.spmv.kernel import spmv_ell, spmv_ell_plain
from repro_torch.kernels.spmv.ops import STRIPE_WASTE_THRESHOLD, spmv
from repro_torch.kernels.spmv.stripe import (
    build_stripe_plan, spmv_ell_stripes, spmv_stripes_plain,
)

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)
# laplacian_2d(23): 529 rows, a multiple of neither P=8 nor any block size
MATRICES = {
    "lap16": lambda mod, **kw: mod.laplacian_2d(16, **kw),
    "lap23": lambda mod, **kw: mod.laplacian_2d(23, **kw),
    "skewed": lambda mod, **kw: mod.skewed_matrix(600, 4.0, 64, seed=5, **kw),
}
_CACHE: dict = {}


def tensor(a) -> torch.Tensor:
    """A CPU tensor holding a copy of a reference array."""
    return torch.as_tensor(np.array(a))


def problem(name: str):
    """(reference inputs, port inputs) for one matrix, built once per module."""
    if name not in _CACHE:
        a_ref = MATRICES[name](RS)
        a = MATRICES[name](TS, device=CPU)
        n = a.n_cols
        x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
        _CACHE[name] = (
            JSpMVInputs(R.partition_ell(a_ref, 8), x),
            SpMVInputs(T.partition_ell(a, 8, device=CPU), torch.as_tensor(x)),
            a,
        )
    return _CACHE[name]


@pytest.mark.parametrize("grain", [None, 16, 64])
@pytest.mark.parametrize("replicate_x", [True, False])
@pytest.mark.parametrize("name", list(MATRICES))
def test_spmv_engine_parity(name, replicate_x, grain):
    ref_in, port_in, a = problem(name)
    st_ref = R.MigratoryStrategy(replicate_x=replicate_x, grain=grain)
    st = T.MigratoryStrategy(replicate_x=replicate_x, grain=grain)
    y_local, rep_local = run(Request("spmv", port_in, st, LocalSubstrate(CPU)), iters=1, warmup=0)
    y_cuda, rep_cuda = run(Request("spmv", port_in, st, CudaSubstrate(CPU)), iters=1, warmup=0)
    for sub in ("local", "pallas"):
        y_ref, rep_ref = jrun(JRequest("spmv", ref_in, st_ref, sub), iters=1, warmup=0)
        for y, rep in ((y_local, rep_local), (y_cuda, rep_cuda)):
            np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
            for col in ("migrations", "remote_writes", "traffic_bytes", "bytes_moved",
                        "grain", "nodelets"):
                assert rep.to_dict()[col] == rep_ref.to_dict()[col], col
    want = TS.spmv_csr_ref(a, port_in.x).numpy()
    np.testing.assert_allclose(T.gather_result(y_cuda, a.n_rows).numpy(), want, **TOL)


@pytest.mark.parametrize("block_rows", [1, 7, 16, 64, 256, 10_000])
def test_ell_kernel_plain_matches_reference_kernel(block_rows):
    e = TS.ell_from_csr(TS.skewed_matrix(300, 4.0, 20, seed=3, device=CPU), device=CPU)
    x = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    want = np.asarray(jspmv(e.cols.numpy(), e.vals.numpy(), x, grain=block_rows, interpret=True))
    cols, vals = e.cols, e.vals
    got = spmv_ell(cols, vals, torch.as_tensor(x), block_rows=block_rows)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got.numpy(), spmv_ell_plain(cols, vals, torch.as_tensor(x)).numpy())


@pytest.mark.parametrize("block_rows", [32, 64, 200])
def test_stripe_plan_and_product_match_reference(block_rows):
    a_ref = RS.skewed_matrix(512, 4.0, 128, seed=9)
    e = TS.ell_from_csr(TS.skewed_matrix(512, 4.0, 128, seed=9, device=CPU), device=CPU)
    cols, vals = e.cols, e.vals
    ref_plan = jbuild_stripe_plan(cols.numpy(), block_rows)
    plan = build_stripe_plan(cols, block_rows)
    assert (plan.block_rows, plan.n_rows, plan.k_full) == (
        ref_plan.block_rows, ref_plan.n_rows, ref_plan.k_full)
    assert [b.k for b in plan.buckets] == [b.k for b in ref_plan.buckets]
    for b, rb in zip(plan.buckets, ref_plan.buckets):
        np.testing.assert_array_equal(b.rows, np.asarray(rb.rows))
    assert plan.waste_ratio == ref_plan.waste_ratio
    x = np.random.default_rng(1).standard_normal(512).astype(np.float32)
    want = np.asarray(RS.spmv_csr_ref(a_ref, x))
    got = spmv_ell_stripes(cols, vals, torch.as_tensor(x), block_rows=block_rows)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="stripe plan"):
        spmv_ell_stripes(cols[:-1], vals[:-1], torch.as_tensor(x), plan=plan)


@pytest.mark.parametrize("block_rows", [1, 32, 64, 200, 512])
def test_stripe_width_table_matches_reference_buckets(block_rows):
    """The plan's per-stripe width table (what the kernel reads) against the
    reference plan: stripe s reads the width of the bucket its rows are in,
    and rows x width summed over stripes is the reference's padded slots."""
    e = TS.ell_from_csr(TS.skewed_matrix(512, 4.0, 128, seed=9, device=CPU), device=CPU)
    ref_plan = jbuild_stripe_plan(e.cols.numpy(), block_rows)
    plan = build_stripe_plan(e.cols, block_rows)
    assert plan.widths.dtype == np.int32
    assert len(plan.widths) == -(-512 // ref_plan.block_rows)
    width_of_row = np.full(512, -1)
    for rb in ref_plan.buckets:
        width_of_row[np.asarray(rb.rows)] = rb.k
    block = ref_plan.block_rows
    np.testing.assert_array_equal(plan.widths, width_of_row[::block])
    for s_ in range(len(plan.widths)):  # every row of a stripe sits in one bucket
        assert (width_of_row[s_ * block:(s_ + 1) * block] == plan.widths[s_]).all()
    rows = np.minimum(block, 512 - block * np.arange(len(plan.widths)))
    assert int((rows * plan.widths).sum()) == ref_plan.padded_slots == plan.padded_slots
    assert plan.widths_on(torch.device(CPU)) is plan.widths_on(torch.device(CPU))  # copied once


def _not_left_packed(cols, vals, seed):
    """The same matrix with each row's slots permuted: padding (-1) lands
    anywhere in a row, as in planes a caller built by hand."""
    perm = torch.as_tensor(np.random.default_rng(seed).permuted(
        np.tile(np.arange(cols.shape[1]), (cols.shape[0], 1)), axis=1))
    return cols.gather(1, perm), vals.gather(1, perm)


@pytest.mark.parametrize("block_rows", [16, 64, 200])
@pytest.mark.parametrize("packed", [True, False])
def test_stripes_on_cpu_match_reference_product(packed, block_rows):
    """``spmv_ell_stripes`` on CPU tensors (its plain version, the JAX
    package's bucketed loop) against the reference's striped product, on
    left-packed planes and on the same planes with each row's slots
    permuted, within the reference's stripe tolerance."""
    e = TS.ell_from_csr(TS.skewed_matrix(512, 4.0, 128, seed=9, device=CPU), device=CPU)
    cols, vals = e.cols, e.vals
    if not packed:
        cols, vals = _not_left_packed(cols, vals, seed=block_rows)
        assert ((cols[:, :-1] < 0) & (cols[:, 1:] >= 0)).any()  # padding ahead of a valid slot
    x = np.random.default_rng(3).standard_normal(512).astype(np.float32)
    want = np.asarray(jspmv(cols.numpy(), vals.numpy(), x, grain=block_rows, variant="stripe",
                            interpret=True))
    plan = build_stripe_plan(cols, block_rows)
    before = spmv_ell_stripes.launches
    got = spmv_ell_stripes(cols, vals, torch.as_tensor(x), plan=plan)
    assert spmv_ell_stripes.launches == before  # CPU tensors: no kernel launch
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got.numpy(),
                                  spmv_stripes_plain(cols, vals, torch.as_tensor(x), plan).numpy())
    np.testing.assert_allclose(got.numpy(), spmv_ell_plain(cols, vals, torch.as_tensor(x)).numpy(),
                               **TOL)


@pytest.mark.parametrize("variant", ["ell", "stripe", "auto"])
def test_spmv_variants_match_reference_dispatcher(variant):
    e = TS.ell_from_csr(TS.skewed_matrix(512, 4.0, 128, seed=9, device=CPU), device=CPU)
    x = np.random.default_rng(2).standard_normal(512).astype(np.float32)
    want = np.asarray(jspmv(e.cols.numpy(), e.vals.numpy(), x, grain=64, variant=variant,
                            interpret=True))
    got = spmv(e.cols, e.vals, torch.as_tensor(x), grain=64, variant=variant)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_auto_keeps_uniform_rows_on_the_ell_kernel():
    u = T.partition_ell(TS.laplacian_2d(8, device=CPU), 1, device=CPU)
    assert build_stripe_plan(u.cols[0], block_rows=16).waste_ratio < STRIPE_WASTE_THRESHOLD
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(64).astype(np.float32))
    np.testing.assert_allclose(spmv(u.cols[0], u.vals[0], x, grain=16, variant="auto").numpy(),
                               spmv_ell_plain(u.cols[0], u.vals[0], x).numpy(), **TOL)
    with pytest.raises(ValueError, match="variant"):
        spmv(u.cols[0], u.vals[0], x, variant="csr5")


def test_spmv_model_helpers_match_reference():
    ref_in, port_in, a = problem("skewed")
    for rep in (True, False):
        st_ref, st = R.MigratoryStrategy(replicate_x=rep), T.MigratoryStrategy(replicate_x=rep)
        assert astuple(T.spmv_traffic(port_in.a, st)) == astuple(R.spmv_traffic(ref_in.a, st_ref))
    assert T.spmv_bytes_moved(port_in.a, a.n_cols) == R.spmv_bytes_moved(ref_in.a, a.n_cols)
    assert T.effective_bandwidth(port_in.a, a.n_cols, 0.5) == R.effective_bandwidth(
        ref_in.a, a.n_cols, 0.5)
