"""GSANA in the PyTorch port against the JAX package, on the CPU.

The same numpy-built alignment pair goes through both packages. The fused
similarity + top-k kernel's plain version is held against the reference's
oracle (``lax.top_k``) and its Pallas kernel in interpret mode: scores within
``atol=1e-6``, slot indices equal. Engine results: every vertex but 0 has
equal candidates and scores within ``atol=1e-6``.

Vertex 0 differs on purpose. The reference's ``_scatter_vertex_major``
scatters every padding slot of every bucket to vertex 0 as well, and the
last write wins, so its row 0 reads ``[0 0 0 0] / -inf``; the port scatters
only valid slots. Row 0 of the port is therefore held against the
reference's bucket-major result at vertex 0's own slot."""
from dataclasses import astuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.gsana import DEFAULT_VOCAB as REF_VOCAB
from repro.core.gsana import compute_similarity_pair as ref_similarity_pair
from repro.core.gsana import similarity_block as ref_similarity_block
from repro.engine import GSANAInputs as JGSANAInputs, Request as JRequest, run as jrun
from repro.kernels.topk_sim.kernel import topk_sim_pallas
from repro.kernels.topk_sim.ops import pack_features as ref_pack_features
from repro.kernels.topk_sim.ops import topk_sim_pairs as ref_topk_sim_pairs
from repro.kernels.topk_sim.ref import topk_sim_reference
from repro_torch.engine import (
    CudaSubstrate, GSANAInputs, LocalSubstrate, OpNotSupportedError, Request, run,
)
from repro_torch.kernels.topk_sim.kernel import topk_sim, topk_sim_plain
from repro_torch.kernels.topk_sim.ops import pack_features, topk_sim_pairs
from test_torch_gpu import tie_heavy_planes

CPU = "cpu"
ATOL = 1e-6
PROBLEMS = {"n256": (256, 4), "n512": (512, 1)}
_CACHE: dict = {}


def problem(name: str):
    """(reference inputs, port inputs) sharing one numpy-built pair."""
    if name not in _CACHE:
        n, seed = PROBLEMS[name]
        r1, r2, pi = R.generate_alignment_pair(n, seed=seed)
        p1, p2, _ = T.generate_alignment_pair(n, seed=seed, device=CPU)
        grid = R.pick_grid(n, 32)
        cap = max(R.bucketize(r1, grid).cap, R.bucketize(r2, grid).cap)
        ref = JGSANAInputs(r1, r2, R.bucketize(r1, grid, cap=cap), R.bucketize(r2, grid, cap=cap),
                           k=4, nodelets=8, ground_truth=pi)
        port = GSANAInputs(p1, p2, T.bucketize(p1, grid, cap=cap, device=CPU),
                           T.bucketize(p2, grid, cap=cap, device=CPU),
                           k=4, nodelets=8, ground_truth=pi)
        _CACHE[name] = (ref, port)
    return _CACHE[name]


def _random_planes(p, a, b, seed, t=(8, 8, 16)):
    rng = np.random.default_rng(seed)
    f = 5 + sum(t)
    fv = np.abs(rng.standard_normal((p, a, f))).astype(np.float32)
    fu = np.abs(rng.standard_normal((p, b, f))).astype(np.float32)
    mv = (rng.random((p, a)) > 0.2).astype(np.float32)
    mu = (rng.random((p, b)) > 0.2).astype(np.float32)
    mu[0] = 0.0  # one task with no valid u at all: every row is -inf
    return fv, fu, mv, mu, t


@pytest.mark.parametrize("p,a,b,k", [(3, 4, 4, 1), (2, 8, 16, 4), (5, 16, 8, 2), (4, 16, 16, 4)])
def test_topk_sim_plain_matches_reference_and_pallas(p, a, b, k):
    fv, fu, mv, mu, (t1, t2, t3) = _random_planes(p, a, b, seed=p * 100 + a)
    kw = dict(t1=t1, t2=t2, t3=t3, k=k)
    s_ref, i_ref = map(np.asarray, topk_sim_reference(fv, fu, mv, mu, **kw))
    s_pal, i_pal = map(np.asarray, topk_sim_pallas(fv, fu, mv, mu, interpret=True, **kw))
    planes = [torch.as_tensor(x) for x in (fv, fu, mv, mu)]
    for fn in (topk_sim_plain, topk_sim):
        s, i = fn(*planes, **kw)
        assert s.dtype == torch.float32 and i.dtype == torch.int32
        s, i = s.numpy(), i.numpy()
        finite = np.isfinite(s_ref)
        assert (np.isfinite(s) == finite).all()
        np.testing.assert_allclose(s[finite], s_ref[finite], rtol=0, atol=ATOL)
        np.testing.assert_array_equal(i[finite], i_ref[finite])
        # the Pallas kernel runs the same argmax-and-mask passes: equal
        # everywhere, including the slot-0 repeats of rows with no valid u
        np.testing.assert_allclose(s, s_pal, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(i, i_pal)


@pytest.mark.parametrize("p,a,b,k", [(2, 300, 300, 4), (3, 5, 4, 6)])
def test_topk_sim_plain_matches_pallas_past_shared_memory_and_k(p, a, b, k):
    """GSANA's own feature width (F = 101, vocabulary (16, 16, 64)) at
    buckets of 300 slots a side, past what the card's kernel once held in
    shared memory, and k = 6 > B = 4: the plain version (the card kernel's
    oracle, and what ``topk_sim`` runs on CPU tensors) equals the Pallas
    kernel in interpret mode, slot for slot, including the slot-0 repeats
    at -inf past the valid slots."""
    rng = np.random.default_rng(a + k)
    t1, t2, t3 = REF_VOCAB
    f = 5 + t1 + t2 + t3
    fv = rng.integers(0, 4, (p, a, f)).astype(np.float32)  # exact sums, frequent ties
    fu = rng.integers(0, 4, (p, b, f)).astype(np.float32)
    mv = (rng.random((p, a)) > 0.1).astype(np.float32)
    mu = (rng.random((p, b)) > 0.1).astype(np.float32)
    mu[0, :-1] = 0.0  # task 0: one valid u slot
    kw = dict(t1=t1, t2=t2, t3=t3, k=k)
    s_pal, i_pal = map(np.asarray, topk_sim_pallas(fv, fu, mv, mu, interpret=True, **kw))
    planes = [torch.as_tensor(x) for x in (fv, fu, mv, mu)]
    for fn in (topk_sim_plain, topk_sim):
        s, i = (x.numpy() for x in fn(*planes, **kw))
        np.testing.assert_array_equal(i, i_pal)
        np.testing.assert_allclose(s, s_pal, rtol=0, atol=ATOL)
    assert np.isneginf(s[0, :, 1:]).all() and (i[0, :, 1:] == 0).all()
    if k > b:
        assert np.isneginf(s[:, :, b:]).all()


def test_topk_sim_plain_ties_match_pallas():
    planes, (t1, t2, t3) = tie_heavy_planes()  # the planes the card's tie test uses
    kw = dict(t1=t1, t2=t2, t3=t3, k=4)
    s_pal, i_pal = map(np.asarray, topk_sim_pallas(*planes, interpret=True, **kw))
    s, i = (x.numpy() for x in topk_sim_plain(*map(torch.as_tensor, planes), **kw))
    np.testing.assert_array_equal(i, i_pal)
    np.testing.assert_allclose(s, s_pal, rtol=0, atol=ATOL)
    # a row with fewer than k valid slots repeats slot 0 at -inf
    np.testing.assert_array_equal(i[1, 0], [5, 17, 0, 0])
    assert np.isneginf(s[1, :, 2:]).all() and np.isneginf(s[2]).all()


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_pack_features_and_pair_tasks_match_reference(name):
    ref, port = problem(name)
    assert T.DEFAULT_VOCAB == REF_VOCAB
    for rv, pv in ((ref.vs1, port.vs1), (ref.vs2, port.vs2)):
        np.testing.assert_array_equal(pack_features(pv, T.DEFAULT_VOCAB).numpy(),
                                      np.asarray(ref_pack_features(rv, REF_VOCAB)))
    grid2 = ref.b2.grid * ref.b2.grid
    pb2 = np.repeat(np.arange(grid2), 9)
    pb1 = R.neighbor_buckets(ref.b2.grid).reshape(-1)
    s_ref, u_ref = ref_topk_sim_pairs(ref.vs1, ref.vs2, ref.b1, ref.b2, jnp.asarray(pb2),
                                      jnp.asarray(pb1), k=4, interpret=True)
    s, u = topk_sim_pairs(port.vs1, port.vs2, port.b1, port.b2, torch.as_tensor(pb2),
                          torch.as_tensor(pb1), k=4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(u.numpy(), np.asarray(u_ref))


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_similarity_block_matches_reference(name):
    ref, port = problem(name)
    nb = R.neighbor_buckets(ref.b2.grid)
    bid2 = ref.b2.grid + 1  # an interior bucket
    for j in range(9):
        bid1 = int(nb[bid2, j])
        want = np.asarray(ref_similarity_block(ref.vs2, ref.vs1, ref.b2.vid[bid2],
                                               ref.b1.vid[bid1]))
        got = T.similarity_block(port.vs2, port.vs1, port.b2.vid[bid2], port.b1.vid[bid1])
        np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def _vertex0_slot(b2) -> int:
    return int(np.nonzero(np.asarray(b2.vid).reshape(-1) == 0)[0][0])


CASES = [
    ("local", "pair"), ("local", "all"), ("cuda", "pair"),
]


@pytest.mark.parametrize("layout", ["blk", "hcb"])
@pytest.mark.parametrize("substrate,scheme", CASES)
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_gsana_engine_parity(name, substrate, scheme, layout):
    ref, port = problem(name)
    st_ref = R.MigratoryStrategy(layout=R.Layout(layout), scheme=R.Scheme(scheme))
    st = T.MigratoryStrategy(layout=T.Layout(layout), scheme=T.Scheme(scheme))
    (c_ref, s_ref), rep_ref = jrun(JRequest("gsana", ref, st_ref, "local"), iters=1, warmup=0)
    sub = LocalSubstrate(CPU) if substrate == "local" else CudaSubstrate(CPU)
    (cand, score), rep = run(Request("gsana", port, st, sub), iters=1, warmup=0)
    c_ref, s_ref = np.asarray(c_ref), np.asarray(s_ref)
    cand, score = cand.numpy(), score.numpy()
    assert cand.dtype == np.int32 and score.dtype == np.float32
    np.testing.assert_array_equal(cand[1:], c_ref[1:])
    np.testing.assert_allclose(score[1:], s_ref[1:], rtol=0, atol=ATOL)
    # vertex 0: the reference's own bucket-major row at vertex 0's slot
    nb = jnp.asarray(R.neighbor_buckets(ref.b2.grid))
    cb, sb = map(np.asarray, ref_similarity_pair(ref.vs1, ref.vs2, ref.b1, ref.b2, nb, 4))
    slot = _vertex0_slot(ref.b2)
    np.testing.assert_array_equal(cand[0], cb.reshape(-1, 4)[slot])
    np.testing.assert_allclose(score[0], sb.reshape(-1, 4)[slot], rtol=0, atol=ATOL)
    row, row_ref = rep.to_dict(), rep_ref.to_dict()
    assert set(row) == set(row_ref)
    for col in ("total_comparisons", "model_makespan", "model_speedup", "rw_words",
                "migrations", "remote_writes", "traffic_bytes", "bytes_moved"):
        assert row[col] == row_ref[col], col
    assert abs(row["recall_at_k"] - row_ref["recall_at_k"]) <= 1.0 / port.vs2.n


def test_reference_vertex0_fault_is_what_the_port_avoids():
    """The reference clobbers vertex 0 at n=512, seed=1; the port does not."""
    ref, port = problem("n512")
    c_ref, s_ref = map(np.asarray, R.compute_similarity(ref.vs1, ref.vs2, ref.b1, ref.b2, 4))
    assert (c_ref[0] == 0).all() and np.isneginf(s_ref[0]).all()
    cand, score = T.compute_similarity(port.vs1, port.vs2, port.b1, port.b2, 4)
    assert np.isfinite(score[0].numpy()).all()
    assert (cand[0].numpy() != 0).any()


def test_cuda_gsana_is_pair_only():
    _, port = problem("n256")
    st = T.MigratoryStrategy(scheme=T.Scheme.ALL)
    with pytest.raises(OpNotSupportedError, match="PAIR"):
        run(Request("gsana", port, st, CudaSubstrate(CPU)), iters=1, warmup=0)


@pytest.mark.parametrize("scheme", ["all", "pair"])
@pytest.mark.parametrize("layout", ["blk", "hcb"])
def test_placement_and_plan_stats_identical(layout, scheme):
    ref, port = problem("n512")
    if layout == "hcb":
        pl_ref = R.layout_hcb(ref.b1, ref.b2, 8)
        pl = T.layout_hcb(port.b1, port.b2, 8)
    else:
        pl_ref = R.layout_blk(ref.b1, ref.b2, ref.vs1.n, ref.vs2.n, 8)
        pl = T.layout_blk(port.b1, port.b2, port.vs1.n, port.vs2.n, 8)
    for f in ("bucket_owner", "vertex_owner1", "vertex_owner2"):
        np.testing.assert_array_equal(getattr(pl, f), getattr(pl_ref, f))
    ps_ref = R.plan_stats(ref.vs1, ref.vs2, ref.b1, ref.b2, pl_ref, R.Scheme(scheme), 8)
    ps = T.plan_stats(port.vs1, port.vs2, port.b1, port.b2, pl, T.Scheme(scheme), 8)
    assert (ps.total_comparisons, ps.makespan, ps.speedup_model, ps.rw_total) == (
        ps_ref.total_comparisons, ps_ref.makespan, ps_ref.speedup_model, ps_ref.rw_total)
    assert astuple(ps.traffic) == astuple(ps_ref.traffic)
    assert T.gsana_rw_bytes(port.vs1, port.vs2, port.b1, port.b2) == R.gsana_rw_bytes(
        ref.vs1, ref.vs2, ref.b1, ref.b2)


def test_effective_bw_positive():
    _, port = problem("n256")
    assert T.gsana_effective_bw(port.vs1, port.vs2, port.b1, port.b2, seconds=1.0) > 0


@pytest.mark.parametrize("seconds,word_bytes", [(1.0, 8), (5.9e-3, 8), (0.25, 4)])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_gsana_effective_bw_matches_reference(name, seconds, word_bytes):
    """Paper §5.3's RW-model bandwidth equal to the reference's on the same
    numpy-built pair, at a few times and word sizes."""
    ref, port = problem(name)
    assert T.gsana_effective_bw(port.vs1, port.vs2, port.b1, port.b2, seconds,
                                word_bytes) == R.gsana_effective_bw(
        ref.vs1, ref.vs2, ref.b1, ref.b2, seconds, word_bytes)
