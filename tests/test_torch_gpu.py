"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

These tests need a CUDA device and the CUDA toolkit (the kernels are built
with nvcc at first use). Without a card they skip; run them on a machine with
one (``--noconftest``: ``tests/conftest.py`` imports the JAX package):

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.sparse as TS
from repro_torch.core.bfs import _adj_global, bfs_local, global_rows
from repro_torch.core.gsana import pair_tasks
from repro_torch.engine import (
    BFSInputs, CudaSubstrate, GSANAInputs, LocalSubstrate, Request, SpMVInputs, run,
)
from repro_torch.kernels.bfs.kernel import bfs_expand, bfs_expand_plain
from repro_torch.kernels.bfs.ops import bfs_cuda
from repro_torch.kernels.flash_attention.kernel import (
    MAX_HEAD_DIM, flash_attention_plain, flash_attn, kernel_block_k,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.spmv.kernel import spmv_ell, spmv_ell_plain
from repro_torch.kernels.spmv.ops import spmv
from repro_torch.kernels.spmv.stripe import build_stripe_plan, spmv_ell_stripes
from repro_torch.kernels.topk_sim.kernel import topk_sim, topk_sim_plain
from repro_torch.kernels.topk_sim.ops import pair_planes

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card; decided here, at run time, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares each CUDA kernel with its plain version")
    return torch.device("cuda")


@pytest.mark.parametrize("block_rows", [1, 7, 64, 256, 1024])
def test_spmv_ell_kernel_matches_plain(cuda, block_rows):
    a = T.partition_ell(TS.laplacian_2d(48, device=cuda), 8, device=cuda)
    cols, vals = a.cols.reshape(-1, a.k), a.vals.reshape(-1, a.k)
    x = torch.randn(a.shape[1], generator=torch.Generator().manual_seed(0)).to(cuda)
    before = spmv_ell.launches
    y = spmv_ell(cols, vals, x, block_rows=block_rows)
    assert spmv_ell.launches == before + 1
    torch.testing.assert_close(y, spmv_ell_plain(cols, vals, x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["stripe", "auto"])
def test_spmv_stripe_kernel_matches_csr_reference(cuda, variant):
    a = TS.skewed_matrix(3000, 4.0, 300, seed=4, device=cuda)
    e = T.partition_ell(a, 1, device=cuda)
    x = torch.randn(3000, generator=torch.Generator().manual_seed(1)).to(cuda)
    y = spmv(e.cols[0], e.vals[0], x, grain=64, variant=variant)
    torch.testing.assert_close(y, TS.spmv_csr_ref(a, x), rtol=1e-4, atol=1e-4)


def stripe_planes(name, device):
    """ELL planes (cols, vals) for the stripe kernel: the main path's
    Laplacian, a skewed matrix with hub rows, and that matrix with its
    planes reversed along the slots (padding first, not left-packed)."""
    if name == "laplacian":
        a = T.partition_ell(TS.laplacian_2d(96, device=device), 8, device=device)
        return a.cols.reshape(-1, a.k), a.vals.reshape(-1, a.k)
    e = T.partition_ell(TS.skewed_matrix(5000, 6.0, 700, seed=8, device=device), 1, device=device)
    cols, vals = e.cols[0], e.vals[0]
    if name == "reversed":
        cols, vals = cols.flip(1).contiguous(), vals.flip(1).contiguous()
    return cols, vals


@pytest.mark.parametrize("block_rows", [1, 32, 256, 1024])
@pytest.mark.parametrize("name", ["laplacian", "skewed", "reversed"])
def test_spmv_stripes_kernel_matches_plain(cuda, name, block_rows):
    """One launch a call, each stripe read in place at its own width, equal
    to the ELL product of the whole planes within the reference's stripe
    tolerance."""
    cols, vals = stripe_planes(name, cuda)
    x = torch.randn(int(cols.max()) + 1, generator=torch.Generator().manual_seed(4)).to(cuda)
    plan = build_stripe_plan(cols, block_rows)
    before = spmv_ell_stripes.launches
    y = spmv_ell_stripes(cols, vals, x, plan=plan)
    assert spmv_ell_stripes.launches == before + 1
    torch.testing.assert_close(y, spmv_ell_plain(cols, vals, x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block_rows", [1, 3, 256, 2048])
def test_bfs_expand_kernel_bit_identical(cuda, block_rows):
    g = TS.partition_graph(TS.edges_to_csr(TS.rmat_edges(12, 8, seed=2), 1 << 12, device=cuda),
                           8, device=cuda)
    adj = _adj_global(g)
    gen = torch.Generator().manual_seed(block_rows)
    frontier = (torch.rand(adj.shape[0], generator=gen) < 0.1).to(cuda)
    before = bfs_expand.launches
    got = bfs_expand(adj, frontier, block_rows=block_rows)
    assert bfs_expand.launches == before + 1
    assert torch.equal(got, bfs_expand_plain(adj, frontier))
    parents = bfs_cuda(g, 0, block_rows=block_rows)
    assert torch.equal(parents, bfs_local(g, 0))
    assert T.validate_parents(g, 0, parents)


# (P, V_p, K): K = 66 as on the main path; odd K (row bases alternately
# 8- and 4-byte aligned) with N = 999 and 1000, not multiples of 32
BFS_PLANES = [(8, 512, 66), (3, 333, 5), (1, 1000, 7), (8, 97, 66)]


def bfs_case(p, vp, k, kind, seed):
    """Planes with -1 padding, rows of -1 only and ids >= N (to be dropped),
    and a frontier: random bool, all in, none in, or int32 with values
    other than 0 and 1."""
    n = p * vp
    rng = np.random.default_rng(seed)
    planes = rng.integers(-1, n + 4, (p, vp, k)).astype(np.int32)
    planes[:, ::5] = -1
    frontier = {
        "random": lambda: rng.random(n) < 0.3,
        "all": lambda: np.ones(n, bool),
        "none": lambda: np.zeros(n, bool),
        "int32": lambda: rng.integers(-2, 3, n).astype(np.int32),
    }[kind]()
    return torch.as_tensor(planes), torch.as_tensor(frontier)


@pytest.mark.parametrize("block_rows", [1, 3, 33, 2048])
@pytest.mark.parametrize("kind", ["random", "all", "none", "int32"])
@pytest.mark.parametrize("p,vp,k", BFS_PLANES)
def test_bfs_expand_kernel_on_planes_bit_identical(cuda, p, vp, k, kind, block_rows):
    """The kernel on (P, V_p, K) planes, on the (N, K) rows of the same
    graph, and on those rows at a base 4 bytes past 8-byte alignment, each
    equal to the plain version."""
    planes, frontier = bfs_case(p, vp, k, kind, seed=p * vp * k + block_rows)
    planes, frontier = planes.to(cuda), frontier.to(cuda)
    want = bfs_expand_plain(planes, frontier)
    rows = global_rows(planes).contiguous()
    shifted = torch.empty(rows.numel() + 1, dtype=torch.int32, device=cuda)[1:].view(rows.shape)
    shifted.copy_(rows)
    assert shifted.data_ptr() % 8 == 4
    before = bfs_expand.launches
    for adj in (planes, rows, shifted):
        assert torch.equal(bfs_expand(adj, frontier, block_rows=block_rows), want)
    assert bfs_expand.launches == before + 3


@pytest.mark.parametrize("n", [1024, 8192])
def test_topk_sim_kernel_matches_plain(cuda, n):
    vs1, vs2, _ = T.generate_alignment_pair(n, seed=3, device=cuda)
    grid = T.pick_grid(n, 32)
    b1, b2 = T.bucketize(vs1, grid, device=cuda), T.bucketize(vs2, grid, device=cuda)
    planes = pair_planes(vs1, vs2, b1, b2, *pair_tasks(grid, cuda))[:4]
    kw = dict(t1=16, t2=16, t3=64, k=4)
    before = topk_sim.launches
    s, i = topk_sim(*planes, **kw)
    assert topk_sim.launches == before + 1
    s_p, i_p = topk_sim_plain(*planes, **kw)
    assert torch.equal(i, i_p)
    torch.testing.assert_close(s, s_p, rtol=0, atol=1e-6)


def tie_heavy_planes():
    """Every feature row equal, so every valid pair ties: slots must come out
    lowest first. Task 1 has 2 valid u slots (fewer than k), task 2 none,
    task 3 more than 32 (two u rows a lane) with some v rows not valid.
    Numpy arrays (fv, fu, mv, mu) and the vocabulary; ``test_torch_gsana``
    holds the same planes against the Pallas kernel."""
    p, a, b, t = 4, 6, 40, (16, 16, 64)
    row = np.abs(np.random.default_rng(9).standard_normal(5 + sum(t))).round().astype(np.float32)
    fv, fu = np.broadcast_to(row, (p, a, row.size)).copy(), np.broadcast_to(row, (p, b, row.size)).copy()
    mv, mu = np.ones((p, a), np.float32), np.ones((p, b), np.float32)
    mu[1] = 0.0
    mu[1, [5, 17]] = 1.0
    mu[2] = 0.0
    mu[3, ::7] = 0.0
    mv[3, [0, 4]] = 0.0
    return (fv, fu, mv, mu), t


def test_topk_sim_kernel_ties_match_plain(cuda):
    planes, (t1, t2, t3) = tie_heavy_planes()
    planes = [torch.as_tensor(x, device=cuda) for x in planes]
    kw = dict(t1=t1, t2=t2, t3=t3, k=4)
    s, i = topk_sim(*planes, **kw)
    s_p, i_p = topk_sim_plain(*planes, **kw)
    assert torch.equal(i, i_p)
    assert i[1, 0].tolist() == [5, 17, 0, 0] and torch.isneginf(s[1, :, 2:]).all()
    torch.testing.assert_close(s, s_p, rtol=0, atol=1e-6)


def test_topk_sim_kernel_ties_match_plain_in_the_wide_instance(cuda):
    """The tie-heavy planes with 160 more u slots (B = 200, the streaming
    instance, in chunks of 128 slots) and k = 6: ties across a chunk edge
    keep the lowest slot first."""
    (fv, fu, mv, mu), (t1, t2, t3) = tie_heavy_planes()
    fu = np.concatenate([fu, np.repeat(fu[:, :1], 160, axis=1)], axis=1)
    mu = np.concatenate([mu, np.ones((mu.shape[0], 160), np.float32)], axis=1)
    mu[1, 40:] = 0.0
    mu[1, [130, 199]] = 1.0  # task 1: slots 5, 17, 130, 199 valid, two chunks
    planes = [torch.as_tensor(x, device=cuda) for x in (fv, fu, mv, mu)]
    kw = dict(t1=t1, t2=t2, t3=t3, k=6)
    s, i = topk_sim(*planes, **kw)
    s_p, i_p = topk_sim_plain(*planes, **kw)
    assert torch.equal(i, i_p)
    assert i[1, 0].tolist() == [5, 17, 130, 199, 0, 0]
    torch.testing.assert_close(s, s_p, rtol=0, atol=1e-6)


def gsana_like_planes(p, a, b, seed):
    """Planes at GSANA's own feature width (F = 101, vocabulary (16, 16,
    64)): small non-negative integers, so the histogram sums are exact and
    scores tie often; about a tenth of the slots are not valid, and task 0
    has no valid u slot."""
    rng = np.random.default_rng(seed)
    f = 5 + sum(T.DEFAULT_VOCAB)
    fv = rng.integers(0, 4, (p, a, f)).astype(np.float32)
    fu = rng.integers(0, 4, (p, b, f)).astype(np.float32)
    mv = (rng.random((p, a)) > 0.1).astype(np.float32)
    mu = (rng.random((p, b)) > 0.1).astype(np.float32)
    mu[0] = 0.0
    return fv, fu, mv, mu


@pytest.mark.parametrize("a,b,k", [(300, 300, 4), (1024, 1024, 4), (2048, 2048, 4),
                                   (40, 6, 9), (300, 100, 130)])
def test_topk_sim_wide_kernel_matches_plain(cuda, a, b, k):
    """Buckets past shared memory's old limit (about 266 rows at F = 101)
    and k past B: slots equal to the plain version's, scores within 1e-6."""
    planes = [torch.as_tensor(x, device=cuda) for x in gsana_like_planes(3, a, b, seed=a + b + k)]
    t1, t2, t3 = T.DEFAULT_VOCAB
    kw = dict(t1=t1, t2=t2, t3=t3, k=k)
    s, i = topk_sim(*planes, **kw)
    s_p, i_p = topk_sim_plain(*planes, **kw)
    assert torch.equal(i, i_p)
    finite = torch.isfinite(s_p)
    assert torch.equal(finite, torch.isfinite(s))
    torch.testing.assert_close(s, s_p, rtol=0, atol=1e-6)
    if k > b:
        assert torch.isneginf(s[:, :, b:]).all() and not i[:, :, b:].any()


@pytest.mark.parametrize("vocab,f", [((200, 200, 100), 510), ((700, 600, 136), 1441)])
def test_topk_sim_wide_kernel_at_wide_feature_rows(cuda, vocab, f):
    """Feature rows too wide for the streaming instance's 64 + 64 rows of
    shared memory take its 8 + 32-row form, up to MAX_SCORED_COLUMNS; F may
    hold columns past the scored ones. One column more raises."""
    from repro_torch.kernels.topk_sim.kernel import MAX_SCORED_COLUMNS

    rng = np.random.default_rng(f)
    p, a, b = 3, 70, 90
    fv = rng.integers(0, 3, (p, a, f)).astype(np.float32)
    fu = rng.integers(0, 3, (p, b, f)).astype(np.float32)
    mv = (rng.random((p, a)) > 0.1).astype(np.float32)
    mu = (rng.random((p, b)) > 0.1).astype(np.float32)
    planes = [torch.as_tensor(x, device=cuda) for x in (fv, fu, mv, mu)]
    kw = dict(t1=vocab[0], t2=vocab[1], t3=vocab[2], k=5)
    assert 5 + sum(vocab) <= MAX_SCORED_COLUMNS
    s, i = topk_sim(*planes, **kw)
    s_p, i_p = topk_sim_plain(*planes, **kw)
    assert torch.equal(i, i_p)
    torch.testing.assert_close(s, s_p, rtol=0, atol=1e-6)
    if 5 + sum(vocab) == MAX_SCORED_COLUMNS:
        wider = [torch.zeros((1, 4, f + 1), device=cuda), torch.zeros((1, 4, f + 1), device=cuda),
                 torch.ones((1, 4), device=cuda), torch.ones((1, 4), device=cuda)]
        with pytest.raises(ValueError, match="unsupported shape"):
            topk_sim(*wider, t1=vocab[0] + 1, t2=vocab[1], t3=vocab[2], k=2)


@pytest.mark.parametrize("b", [100, 500])
def test_topk_sim_kernel_matches_plain_past_64_u_slots(cuda, b):
    """B > 64 takes the kernel's wide instance (up to 32 u rows a lane).
    Tasks hold 0, a few, 33 to 64, and more than 64 valid u slots. The
    features are small signed integers: scores come out negative as well as
    positive, and tie often, and the histogram sums stay exact."""
    rng = np.random.default_rng(b)
    p, a, t = 5, 12, (8, 8, 16)
    fv = rng.integers(-3, 4, (p, a, 5 + sum(t))).astype(np.float32)
    fu = rng.integers(-3, 4, (p, b, 5 + sum(t))).astype(np.float32)
    mv = (rng.random((p, a)) > 0.2).astype(np.float32)
    mu = np.zeros((p, b), np.float32)
    for task, n_valid in enumerate((0, 3, 40, 70, b)):
        mu[task, rng.choice(b, n_valid, replace=False)] = 1.0
    planes = [torch.as_tensor(x, device=cuda) for x in (fv, fu, mv, mu)]
    kw = dict(t1=t[0], t2=t[1], t3=t[2], k=4)
    s, i = topk_sim(*planes, **kw)
    s_p, i_p = topk_sim_plain(*planes, **kw)
    assert bool((s_p[mv > 0] < 0).any()), "the case should hold negative scores"
    assert torch.equal(i, i_p)
    torch.testing.assert_close(s, s_p, rtol=0, atol=1e-6)


def test_engine_cuda_matches_local_on_the_card(cuda):
    a = TS.laplacian_2d(64, device=cuda)
    x = torch.randn(a.n_cols, generator=torch.Generator().manual_seed(2)).to(cuda)
    spmv_in = SpMVInputs(T.partition_ell(a, 8, device=cuda), x)
    g = TS.partition_graph(TS.edges_to_csr(TS.erdos_renyi_edges(12, 8), 1 << 12, device=cuda),
                           8, device=cuda)
    vs1, vs2, pi = T.generate_alignment_pair(2048, seed=1, device=cuda)
    grid = T.pick_grid(2048, 32)
    cap = max(T.bucketize(vs1, grid, device=cuda).cap, T.bucketize(vs2, grid, device=cuda).cap)
    gi = GSANAInputs(vs1, vs2, T.bucketize(vs1, grid, cap=cap, device=cuda),
                     T.bucketize(vs2, grid, cap=cap, device=cuda), ground_truth=pi)
    local, card = LocalSubstrate(cuda), CudaSubstrate(cuda)
    for rep in (True, False):
        st = T.MigratoryStrategy(replicate_x=rep)
        y_l, _ = run(Request("spmv", spmv_in, st, local))
        y_c, _ = run(Request("spmv", spmv_in, st, card))
        torch.testing.assert_close(y_c, y_l, rtol=1e-5, atol=1e-5)
    for comm in T.Comm:
        st = T.MigratoryStrategy(comm=comm)
        p_l, _ = run(Request("bfs", BFSInputs(g, 0), st, local))
        p_c, _ = run(Request("bfs", BFSInputs(g, 0), st, card))
        assert torch.equal(p_l, p_c)
    (c_l, s_l), _ = run(Request("gsana", gi, None, local))
    (c_c, s_c), rep = run(Request("gsana", gi, None, card))
    assert torch.equal(c_l, c_c)
    torch.testing.assert_close(s_c, s_l, rtol=0, atol=1e-6)
    assert rep.metrics["recall_at_k"] > 0.9


def _card_signatures(cuda) -> list:
    """The six main-path signatures at a small size on ``cuda``: SpMV S1
    on/off, BFS both comms, GSANA HCB/BLK PAIR."""
    a = TS.laplacian_2d(64, device=cuda)
    x = torch.randn(a.n_cols, generator=torch.Generator().manual_seed(2)).to(cuda)
    spmv_in = SpMVInputs(T.partition_ell(a, 8, device=cuda), x)
    g = TS.partition_graph(TS.edges_to_csr(TS.erdos_renyi_edges(12, 8), 1 << 12, device=cuda),
                           8, device=cuda)
    vs1, vs2, _ = T.generate_alignment_pair(2048, seed=1, device=cuda)
    grid = T.pick_grid(2048, 32)
    cap = max(T.bucketize(vs1, grid, device=cuda).cap, T.bucketize(vs2, grid, device=cuda).cap)
    gi = GSANAInputs(vs1, vs2, T.bucketize(vs1, grid, cap=cap, device=cuda),
                     T.bucketize(vs2, grid, cap=cap, device=cuda))
    sigs = [("spmv", spmv_in, T.MigratoryStrategy(replicate_x=r)) for r in (True, False)]
    sigs += [("bfs", BFSInputs(g, 0), T.MigratoryStrategy(comm=c)) for c in T.Comm]
    sigs += [("gsana", gi, T.MigratoryStrategy(layout=lay, scheme=T.Scheme.PAIR))
             for lay in (T.Layout.HCB, T.Layout.BLK)]
    return sigs


def test_service_pool_on_the_card_equals_run(cuda):
    """The mixed stream (SpMV S1 on/off, BFS both comms, GSANA HCB/BLK)
    served by a two-worker pool on the card, each worker on a stream of its
    own, equals sequential run bit for bit; every kernel launched through
    the service."""
    from repro_torch.engine import EngineService, PlanCache

    sigs = _card_signatures(cuda)
    sub = CudaSubstrate(cuda)
    want = [run(Request(op, inp, st, sub), iters=1, warmup=0)[0] for op, inp, st in sigs]
    counts = {k: k.launches for k in (spmv_ell, bfs_expand, topk_sim)}
    svc = EngineService(cache=PlanCache(), substrate=sub, device=cuda, workers=2,
                        qos={"bfs": 2.0}, batch_window=0.01).start()
    try:
        futures = [(i % 6, svc.submit(Request(*sigs[i % 6]))) for i in range(24)]
        got = [(i, f.result(timeout=300).result) for i, f in futures]
    finally:
        svc.stop(timeout=300)
    for i, result in got:
        if isinstance(result, tuple):
            assert all(torch.equal(r, w) for r, w in zip(result, want[i]))
        else:
            assert torch.equal(result, want[i])
    assert all(k.launches > n for k, n in counts.items())
    assert svc.stats().errors == 0 and svc.stats().workers == 2


def test_cluster_of_two_workers_on_the_card_equals_run(cuda):
    """Two worker processes, each with its own CUDA context on the card,
    serve the six signatures bit-identically to ``engine.run`` on the cuda
    substrate; the coordinator's inputs are host copies, results come back
    as CPU tensors, and both workers launched the kernels."""
    from repro_torch.cluster import ClusterSubstrate, launch_cluster
    from repro_torch.engine import substrate as substrates
    from repro_torch.engine.wire import to_device

    try:
        sigs = _card_signatures(cuda)
        sub = CudaSubstrate(cuda)
        want = [to_device(run(Request(op, inp, st, sub), iters=1, warmup=0)[0], "cpu")
                for op, inp, st in sigs]
        host = [(op, to_device(inp, "cpu"), st) for op, inp, st in sigs]
        with launch_cluster(2, service_workers=1, activate=False, wait_timeout=300) as cluster:
            futures = [(i % 6, cluster.submit(Request(*host[i % 6], CudaSubstrate("cpu"))))
                       for i in range(24)]
            got = [(i, f.result(timeout=300).result) for i, f in futures]
            rows = [cluster.coordinator.worker_stats(w) for w in (0, 1)]
        for i, result in got:
            if isinstance(result, tuple):
                assert all(torch.equal(r, w) for r, w in zip(result, want[i]))
            else:
                assert torch.equal(result, want[i])
        for row in rows:
            assert row["requests"] > 0 and sum(row["kernel_launches"].values()) > 0
    finally:
        substrates._REGISTRY.pop(ClusterSubstrate.name, None)


@pytest.fixture
def no_machine_file(tmp_path, monkeypatch):
    """The uncalibrated profile and an empty probe store, whatever this host holds."""
    from repro_torch.engine import probes
    from repro_torch.machine import reset_default_machine_cache

    monkeypatch.setenv("REPRO_TORCH_MACHINE_PATH", str(tmp_path / "absent_machine.json"))
    monkeypatch.setenv("REPRO_TORCH_PROBES_PATH", str(tmp_path / "absent_probes.json"))
    monkeypatch.setattr(probes, "_default_store", None)
    reset_default_machine_cache()
    yield
    reset_default_machine_cache()


def test_autotune_and_auto_on_the_card(cuda, no_machine_file):
    """``autotune`` with probes and ``strategy="auto"`` on the cuda
    substrate: the pick's plan is a cache hit after the probes, its kernel
    launches, and its result equals the local substrate's."""
    from repro_torch.engine import PlanCache, autotune

    a = TS.laplacian_2d(64, device=cuda)
    x = torch.randn(a.n_cols, generator=torch.Generator().manual_seed(3)).to(cuda)
    g = TS.partition_graph(TS.edges_to_csr(TS.rmat_edges(12, 8, seed=1), 1 << 12, device=cuda),
                           8, device=cuda)
    cases = {"spmv": (SpMVInputs(T.partition_ell(a, 8, device=cuda), x), spmv_ell),
             "bfs": (BFSInputs(g, 0), bfs_expand)}
    card, local = CudaSubstrate(cuda), LocalSubstrate(cuda)
    for op, (inputs, kernel) in cases.items():
        cache = PlanCache()
        tuned = autotune(op, inputs, card, probe_top_k=2, cache=cache)
        assert sum(c.probe is not None for c in tuned.candidates) == 2
        before = kernel.launches
        got, rep = run(Request(op, inputs, "auto", card), cache=cache)
        assert rep.cache_hit and kernel.launches > before
        want, _ = run(Request(op, inputs, "auto", local), cache=cache)
        if op == "spmv":
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(got, want)


SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
               "cudaMemcpy")  # the runtime calls that block the host on the card


def test_charged_syncs_equal_the_profilers_synchronizes_a_request(cuda, no_machine_file,
                                                                 tmp_path):
    """The ``sync.*`` counts (``engine.syncs_per_request``) are placed by hand
    at each site where the host waits for the card. Each traced request's
    charged count must equal the blocking runtime calls the profiler records
    under its ``engine.run``, so a site the count misses fails here."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import trace
    from repro_torch.engine import PlanCache

    a = T.partition_ell(TS.laplacian_2d(64, device=cuda), 8, device=cuda)
    x = torch.randn(a.shape[1], generator=torch.Generator().manual_seed(2)).to(cuda)
    edges = TS.erdos_renyi_edges(12, 8, seed=1)
    g = TS.partition_graph(TS.edges_to_csr(edges, 1 << 12, device=cuda), 8, device=cuda)
    kept = BFSInputs(g, int(edges[0, 0]))
    cache = PlanCache()

    def requests():  # fresh inputs miss the ops' memo, kept ones hit it (the cells' two cases)
        for sub in (LocalSubstrate(cuda), CudaSubstrate(cuda)):
            yield Request("spmv", SpMVInputs(a, x), None, sub)
            yield Request("bfs", BFSInputs(g, int(edges[0, 0])), None, sub)
            yield Request("bfs", kept, None, sub)

    for _ in range(2):  # warm: kernels built, plans cached
        for req in requests():
            run(req, iters=1, warmup=0, cache=cache)
    torch.cuda.synchronize()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for req in requests():
            run(req, iters=1, warmup=0, cache=cache)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    roots = sorted((e for e in events if e["name"] == "engine.run"), key=lambda e: float(e["ts"]))
    blocking = [float(e["ts"]) for e in events if e["name"] in SYNC_EVENTS]
    seen = [sum(float(r["ts"]) <= t <= float(r["ts"]) + float(r["dur"]) for t in blocking)
            for r in roots]
    snap = trace.snapshot()
    rids = [s["request"] for s in sorted(snap["spans"], key=lambda s: s["t0_ns"])
            if s["name"] == "engine.run"]
    charged = [sum(n for k, n in snap["requests"].get(r, {}).items() if k.startswith("sync."))
               for r in rids]
    trace.reset()
    assert len(roots) == len(rids) == 6
    assert charged == seen, (charged, seen)
    assert min(charged) >= 2


def test_calibrate_the_card(cuda, tmp_path):
    from repro_torch.machine import calibrate, load_machine

    profile = calibrate(device=cuda, quick=True)
    sub = profile.substrate("cuda")
    rates = [sub.stream_bw, sub.gather_bw, sub.scatter_bw, sub.dispatch_overhead,
             profile.peaks.flops, profile.host_parallel_capacity]
    assert all(np.isfinite(v) and v > 0 for v in rates)
    assert profile.fingerprint["backend"] == "cuda"
    assert torch.cuda.get_device_name(cuda) in profile.fingerprint["device_kinds"]
    assert load_machine(profile.save(tmp_path / "machine.json")) == profile


def test_wrappers_raise_instead_of_falling_back(cuda):
    cols = torch.zeros((4, 2), dtype=torch.int64, device=cuda)  # the kernel takes int32
    vals = torch.zeros((4, 2), device=cuda)
    with pytest.raises(TypeError, match="int32"):
        spmv_ell(cols, vals, torch.zeros(4, device=cuda))
    with pytest.raises(ValueError, match="all be on CUDA"):
        spmv_ell(cols.int(), vals, torch.zeros(4))
    planes = [torch.zeros((1, 4, 101), device=cuda), torch.zeros((1, 2, 101), device=cuda),
              torch.ones((1, 4), device=cuda), torch.ones((1, 2), device=cuda)]
    with pytest.raises(ValueError, match="unsupported shape"):
        topk_sim(*planes, t1=16, t2=16, t3=80, k=4)  # more scored columns than F
    assert np.isfinite(topk_sim(*planes, t1=16, t2=16, t3=64, k=2)[0].cpu().numpy()).all()
    s, i = topk_sim(*planes, t1=16, t2=16, t3=64, k=4)  # k > B: computes, no longer raises
    assert torch.isneginf(s[..., 2:]).all() and not i[..., 2:].any()


# (bh_q, bh_kv, sq, skv, causal, window): every mask kind, ragged lengths
FLASH_CASES = [
    (8, 4, 64, 64, True, None),      # GQA causal
    (8, 1, 96, 96, True, None),      # MQA, not a tile multiple
    (4, 4, 64, 192, True, None),     # q the tail of a longer kv (chunked prefill)
    (8, 4, 130, 130, True, 48),      # sliding window, ragged
    (2, 1, 100, 70, False, None),    # non-causal, q longer than kv
    (2, 2, 70, 40, True, None),      # causal, q longer than kv: early rows fully masked
    (2, 1, 64, 200, False, 16),      # window without the causal mask
    (8, 2, 333, 517, True, 200),     # ragged in the bf16 kernel's 128-key tiles, a window
]
DTYPE_IDS = {torch.float32: "f32", torch.bfloat16: "bf16"}
# every case in both dtypes at the configs' head dims (32: every reduced
# config; 80: zamba2-2.7b; 96: phi-3-vision-4.2b; 64, 128), in bf16 one
# llama3.2-3b layer's heads (24 q, 8 kv, D 128) over 1024 tokens, and bf16
# head dims that take the CUDA-core kernel: 72 and 20 (not multiples of 16
# or of 8) and 200 (past the tensor-core kernel's 128)
FLASH_PARAMS = [
    pytest.param(case, d, dtype, id=f"{'-'.join(map(str, case))}-{d}-{DTYPE_IDS[dtype]}")
    for case, d, dtype in [(c, d, t) for t in DTYPE_IDS for d in (32, 64, 80, 96, 128)
                           for c in FLASH_CASES]
    + [((24, 8, 1024, 1024, True, None), 128, torch.bfloat16),
       ((8, 4, 130, 130, True, 48), 72, torch.bfloat16),
       ((8, 2, 333, 517, True, 200), 20, torch.bfloat16),
       ((8, 4, 64, 192, True, None), 200, torch.bfloat16),
       ((2, 1, 100, 70, False, None), 256, torch.float32)]
]
# float32: sums in another order than the plain version. bf16: the output
# rounds to bf16 (one ulp is 2**-8 relative) and p rounds to bf16 before PV,
# so a value near a rounding boundary may land one ulp apart
FLASH_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}


@pytest.mark.parametrize("case,d,dtype", FLASH_PARAMS)
def test_flash_attn_kernel_matches_plain(cuda, case, d, dtype):
    bhq, bhkv, sq, skv, causal, window = case
    gen = torch.Generator().manual_seed(sq * 1000 + skv + d)
    q, k, v = (torch.randn((n, s, d), generator=gen).to(cuda, dtype)
               for n, s in ((bhq, sq), (bhkv, skv), (bhkv, skv)))
    before = flash_attn.launches
    got = flash_attn(q, k, v, causal=causal, window=window)
    assert flash_attn.launches == before + 1
    # each kernel's k tile: online softmax rounds p at its edges
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 block_k=kernel_block_k(dtype, d))
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])
    if causal and sq > skv:  # rows that see no key output 0
        assert not got[:, : sq - skv].any()


# the flash instances the LM families launch when served at full width,
# bf16: (B·Hq, B·Hkv, Sq, Skv, causal, D). whisper-small's encoder (1500
# frames: ragged in 128-key tiles), its cross-attention at prefill (a
# 224-token prompt) and at decode (one q row over every frame), zamba2-2.7b's
# shared block (D 80) and phi-3-vision-4.2b (D 96, 576 patches + 1472 tokens)
FAMILY_INSTANCES = [
    pytest.param((48, 48, 1500, 1500, False, 64), id="whisper-encoder"),
    pytest.param((48, 48, 224, 1500, False, 64), id="whisper-cross-prefill"),
    pytest.param((48, 48, 1, 1500, False, 64), id="whisper-cross-decode"),
    pytest.param((128, 128, 2048, 2048, True, 80), id="zamba2-shared-block"),
    pytest.param((128, 128, 2048, 2048, True, 96), id="phi-3-vision"),
]


@pytest.mark.parametrize("case", FAMILY_INSTANCES)
def test_flash_attn_at_the_families_instances(cuda, case):
    bhq, bhkv, sq, skv, causal, d = case
    gen = torch.Generator().manual_seed(sq + d)
    q, k, v = (torch.randn((n, s, d), generator=gen).to(cuda, torch.bfloat16)
               for n, s in ((bhq, sq), (bhkv, skv), (bhkv, skv)))
    got = flash_attn(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal, block_k=kernel_block_k(torch.bfloat16, d))
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[torch.bfloat16])
    if not causal:  # a row's output reads only its own q row: one row alone is the same row
        one = flash_attn(q[:, -1:].contiguous(), k, v, causal=False)
        torch.testing.assert_close(one.float(), got[:, -1:].float(), **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b", "whisper-small", "phi-3-vision-4.2b"])
def test_family_prefill_and_decode_step_on_the_card_match_the_cpu(cuda, arch):
    """The reduced float32 config of each family, the same weights on the
    card and on the CPU, flash attention where the family has attention:
    a prefill and one decode step. float32 without TF32; cuBLAS and the
    flash kernel sum in other orders than the CPU."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models import Ctx, api

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(reduced_config(arch), attn_impl="flash")
    cpu_model = api.init_params(cfg, seed=0, device="cpu")
    prompts = torch.as_tensor(np.random.default_rng(1).integers(1, cfg.vocab_size, (2, 40)))
    stub = {k: torch.as_tensor(a) for k, a in stub_inputs(cfg, 2, 2).items()}
    out = {}
    for dev in ("cpu", cuda):
        model = api.init_params(cfg, seed=1, device=dev)
        model.load_state_dict(cpu_model.state_dict())
        batch = {k: t.to(dev) for k, t in stub.items()}
        before = flash_attn.launches
        logits, state = api.prefill(Ctx(cfg), model, prompts.to(dev), 48 + (cfg.num_patches or 0), batch)
        step, _ = api.decode_step(Ctx(cfg), model, prompts[:, -1:].to(dev), state)
        out[str(dev)] = (logits.cpu(), step.cpu(), flash_attn.launches - before)
    (lc, sc, n_cpu), (lg, sg, n_card) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sg, sc, rtol=1e-4, atol=1e-4)
    assert n_cpu == 0 and n_card == {"ssm": 0, "hybrid": 2, "encdec": 6 + 2, "vlm": 2}[cfg.family]


def test_flash_attention_op_on_the_card(cuda):
    gen = torch.Generator().manual_seed(5)
    q = torch.randn((2, 24, 200, 128), generator=gen).to(cuda, torch.bfloat16)
    k, v = (torch.randn((2, 8, 200, 128), generator=gen).to(cuda, torch.bfloat16) for _ in "kv")
    got = flash_attention(q, k, v)
    want = flash_attention(q, k, v, use_kernel=False)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[torch.bfloat16])


def test_flash_attn_raises_instead_of_falling_back(cuda):
    q = torch.zeros((4, 8, MAX_HEAD_DIM + 8), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attn(q, q, q)
    q = torch.zeros((4, 8, 128), device=cuda)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        flash_attn(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attn(q.transpose(0, 1), q.transpose(0, 1), q.transpose(0, 1))
    with pytest.raises(ValueError, match="multiple"):
        flash_attn(q, q[:3], q[:3])
    with pytest.raises(ValueError, match="all be on CUDA"):
        flash_attn(q, q.cpu(), q.cpu())


def _moe_dispatch_inputs(device, nodelets=8, seed=5) -> "object":
    from repro_torch.engine import MoEDispatchInputs

    rng = np.random.default_rng(seed)
    t, d, e, f = 128, 32, 16, 24
    arrays = {"x": rng.standard_normal((t, d)), "router": rng.standard_normal((d, e)),
              "w_gate": 0.2 * rng.standard_normal((e, d, f)),
              "w_up": 0.2 * rng.standard_normal((e, d, f)),
              "w_down": 0.2 * rng.standard_normal((e, f, d))}
    return MoEDispatchInputs(nodelets=nodelets, experts_per_token=2, **{
        k: torch.as_tensor(v.astype(np.float32), device=device) for k, v in arrays.items()})


@pytest.mark.parametrize("comm,nodelets", [("migrate", 8), ("remote_write", 8), ("migrate", 1)])
def test_moe_dispatch_on_the_card_matches_the_cpu(cuda, comm, nodelets):
    """moe_dispatch on LocalSubstrate("cuda") against the CPU port (within
    1e-5), and the cuda substrate refuses the op instead of running it
    elsewhere."""
    from repro_torch.core import Comm, MigratoryStrategy
    from repro_torch.engine import OpNotSupportedError, PlanCache

    st = MigratoryStrategy(comm=Comm(comm))
    on_card = _moe_dispatch_inputs(cuda, nodelets)
    on_cpu = _moe_dispatch_inputs("cpu", nodelets)
    y_card, rep_card = run(Request("moe_dispatch", on_card, st, LocalSubstrate(cuda)),
                           iters=1, warmup=0, cache=PlanCache())
    y_cpu, rep_cpu = run(Request("moe_dispatch", on_cpu, st, LocalSubstrate("cpu")),
                         iters=1, warmup=0, cache=PlanCache())
    assert y_card.is_cuda
    torch.testing.assert_close(y_card.cpu(), y_cpu, rtol=1e-5, atol=1e-5)
    assert rep_card.metrics["dropped_slots"] == rep_cpu.metrics["dropped_slots"]
    assert rep_card.traffic == rep_cpu.traffic
    with pytest.raises(OpNotSupportedError):
        run(Request("moe_dispatch", on_card, st, CudaSubstrate(cuda)), cache=PlanCache())


@pytest.mark.parametrize("comm,nodelets", [("migrate", 4), ("remote_write", 4), ("migrate", 1)])
def test_decode_server_on_the_card_equals_the_oracle(cuda, comm, nodelets):
    """DecodeServer through the EngineService worker loop at W = 2 (each
    worker on a stream of its own) serves the oracle's tokens, token for
    token."""
    from repro_torch.configs import get_config
    from repro_torch.core import Comm, MigratoryStrategy
    from repro_torch.engine import DecodeServer, EngineService, PlanCache
    from repro_torch.models.transformer import moe_decode_params

    cfg = get_config("serve-moe")
    params = moe_decode_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist() for n in rng.integers(2, 6, 6)]
    mk = dict(capacity=4, max_len=16, nodelets=nodelets,
              strategy=MigratoryStrategy(comm=Comm(comm)), substrate=LocalSubstrate(cuda),
              device=cuda)

    def drive(server):
        for i, prompt in enumerate(prompts):
            server.add(prompt, max_new_tokens=4)
            if i % 2:
                server.step()
        return dict(server.run_until_drained())

    oracle = drive(DecodeServer(cfg, params, oracle=True, **mk))
    svc = EngineService(cache=PlanCache(), substrate=LocalSubstrate(cuda), device=cuda,
                        workers=2).start()
    try:
        served = drive(DecodeServer(cfg, params, service=svc, **mk))
    finally:
        svc.stop()
    assert served == oracle


def _mesh_parity(dev, mesh) -> None:
    """The main path's ops and moe_dispatch at small sizes on ``mesh``
    (partitioned for its width), each equal to the local substrate's."""
    from repro_torch.core import Comm, MigratoryStrategy
    from repro_torch.engine import MeshSubstrate, PlanCache

    p = mesh.p
    sub, local = MeshSubstrate(dev, mesh), LocalSubstrate(dev)
    a = T.partition_ell(TS.laplacian_2d(48, device=dev), p, device=dev)
    x = torch.randn(a.shape[1], generator=torch.Generator().manual_seed(0)).to(dev)
    g = TS.partition_graph(TS.edges_to_csr(TS.erdos_renyi_edges(12, 8, seed=1), 1 << 12,
                                           device=dev), p, device=dev)
    vs1, vs2, _ = T.generate_alignment_pair(1024, seed=2, device=dev)
    grid = T.pick_grid(1024, 32)
    cap = max(T.bucketize(vs1, grid, device=dev).cap, T.bucketize(vs2, grid, device=dev).cap)
    gi = GSANAInputs(vs1, vs2, T.bucketize(vs1, grid, cap=cap, device=dev),
                     T.bucketize(vs2, grid, cap=cap, device=dev))
    cases = [("spmv", SpMVInputs(a, x), MigratoryStrategy()),
             ("spmv", SpMVInputs(a, x), MigratoryStrategy(replicate_x=False)),
             ("bfs", BFSInputs(g, 3), MigratoryStrategy(comm=Comm.REMOTE_WRITE)),
             ("bfs", BFSInputs(g, 3), MigratoryStrategy(comm=Comm.MIGRATE)),
             ("gsana", gi, MigratoryStrategy()),
             ("moe_dispatch", _moe_dispatch_inputs(dev, p), MigratoryStrategy(comm=Comm.MIGRATE)),
             ("moe_dispatch", _moe_dispatch_inputs(dev, p),
              MigratoryStrategy(comm=Comm.REMOTE_WRITE))]
    for op, inputs, st in cases:
        got, _ = run(Request(op, inputs, st, sub), iters=1, warmup=0, cache=PlanCache())
        want, _ = run(Request(op, inputs, st, local), iters=1, warmup=0, cache=PlanCache())
        for gt, w in zip(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)):
            assert gt.device == w.device and torch.equal(gt, w), (op, st)


def test_mesh_of_eight_ranks_on_one_card_equals_local(cuda):
    """Eight gloo ranks share the card (fewer than eight cards), every
    collective staged through the host; results equal the local substrate's."""
    from repro_torch.launch.mesh import COLLECTIVES, NodeletMesh

    mesh = NodeletMesh(8, cuda, timeout=120)
    try:
        assert mesh.backend == "gloo" and mesh.staged == COLLECTIVES
        _mesh_parity(mesh.device, mesh)
    finally:
        mesh.close()
    assert not any(mesh.alive())


def test_nccl_mesh_across_cards_equals_local(cuda):
    """One rank a card over nccl (at least two cards), nothing staged:
    shards move to each rank's card and results back to the caller's."""
    from repro_torch.launch.mesh import NodeletMesh

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards or more: one nccl rank a card")
    mesh = NodeletMesh(min(n, 4), cuda, timeout=120)
    try:
        assert mesh.backend == "nccl" and mesh.staged == ()
        assert [d.index for d in mesh.rank_devices] == list(range(mesh.p))
        _mesh_parity(mesh.device, mesh)
    finally:
        mesh.close()
    assert not any(mesh.alive())


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Five train steps of the reduced float32 LM on the card and on the CPU
    from the same weights and batches: the losses agree (TF32 is off) to
    rounding. The card sums in other orders, and the embedding's backward
    (an accumulating index put) adds with float atomics in no fixed order,
    so the grads are not bitwise repeatable there."""
    from repro_torch.configs import reduced_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import Ctx, api
    from repro_torch.optim import AdamWConfig

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = reduced_config("llama3.2-3b")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4))
    cpu_model = api.init_params(cfg, seed=0, device="cpu")
    losses = {}
    for dev in ("cpu", cuda):
        model = api.init_params(cfg, seed=0, device=dev)
        model.load_state_dict(cpu_model.state_dict())
        state, losses[str(dev)] = api.init_opt(cfg, model, opt_cfg), []
        for step in range(5):
            _, state, metrics = api.train_step(Ctx(cfg), model, state, data.torch_batch(step, dev), opt_cfg)
            losses[str(dev)].append(float(metrics["loss"]))
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=1e-4)


def test_remat_grads_equal_plain_grads_on_the_card(cuda, monkeypatch):
    """A 2-layer float32 stack: the grads of loss_fn under remat, with the
    q-chunked attention (a small score budget: 2 tiles) and the chunked CE,
    equal those of the plain path (no remat, dense attention, full-logits
    cross-entropy), each parameter's relative Frobenius error within 1e-5."""
    import dataclasses

    import torch.nn.functional as F

    import repro_torch.models.layers as layers
    from repro_torch.configs import reduced_config
    from repro_torch.models import Ctx, api
    from repro_torch.models.transformer import backbone

    cfg = dataclasses.replace(reduced_config("llama3.2-3b"), remat=True)
    model = api.init_params(cfg, seed=0, device=cuda)
    weights = list(model.parameters())
    tokens = torch.as_tensor(np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 257)), device=cuda)
    monkeypatch.setattr(layers, "_SCORE_BYTE_BUDGET", 1 << 18)
    g_remat = torch.autograd.grad(api.loss_fn(Ctx(cfg), model, {"tokens": tokens}), weights)
    monkeypatch.setattr(layers, "_SCORE_BYTE_BUDGET", 1 << 62)
    x = backbone(Ctx(dataclasses.replace(cfg, remat=False)), model, tokens[:, :-1])
    plain = F.cross_entropy((x @ model.lm_head).flatten(0, 1), tokens[:, 1:].flatten())
    for a, b in zip(g_remat, torch.autograd.grad(plain, weights)):
        assert float((a - b).norm() / b.norm()) <= 1e-5


def test_bf16_checkpoint_round_trip_from_the_card(cuda, tmp_path):
    """bf16 weights and float32 moments saved from the card come back bit
    for bit, onto the card."""
    from repro_torch.checkpoint import store
    from repro_torch.configs import reduced_config
    from repro_torch.models import api
    from repro_torch.optim import AdamWConfig

    cfg = reduced_config("llama3.2-3b", "bfloat16")
    model = api.init_params(cfg, seed=0, device=cuda)
    state = api.init_opt(cfg, model, AdamWConfig())
    for t in state.mu.values():
        t.normal_()
    store.save(tmp_path, 1, (model, state))
    fresh = api.init_params(cfg, seed=1, device=cuda)
    fresh_state = api.init_opt(cfg, fresh, AdamWConfig())
    store.restore(tmp_path, 1, (fresh, fresh_state))
    for a, b in zip(model.state_dict().values(), fresh.state_dict().values()):
        assert b.device.type == "cuda" and b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    for n, t in state.mu.items():
        assert torch.equal(t, fresh_state.mu[n])


# -- the LM's (data, model) mesh -------------------------------------------------------------


def _lm_mesh_needs(cards: int) -> None:
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} cards: one nccl rank a card (one card runs chip_smoke.py's "
                    "mesh phase instead)")


def _card_line() -> str:
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown card"


@pytest.mark.parametrize("hq,hkv,b", [(12, 4, 2), (8, 8, 2), (6, 6, 1), (2, 1, 4)])
def test_lm_mesh_flash_at_a_rank_s_head_counts(cuda, hq, hkv, b):
    """flash_attn at the head counts a rank gets: llama3.2-3b on a model
    axis of 2 (12 q, 4 kv), moonshot-v1-16b-a3b (8, 8), the padded-head
    path's MHA heads with zero K/V in the padding, the reduced config's
    GQA on a model axis of 2 (2 q heads reading 1 kv head)."""
    gen = torch.Generator().manual_seed(hq)
    q, k, v = (torch.randn((b * h, 512, 128), generator=gen).to(cuda, torch.bfloat16)
               for h in (hq, hkv, hkv))
    if hq == hkv == 6:
        q[-b:], k[-b:], v[-b:] = 0, 0, 0
    before = flash_attn.launches
    got = flash_attn(q, k, v, causal=True)
    assert flash_attn.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=True, block_k=kernel_block_k(torch.bfloat16, 128))
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2, atol=1e-2)


def test_lm_mesh_reduced_on_the_card_matches_the_cpu(cuda):
    """The reduced float32 llama on a 2 x 2 mesh of rank processes on the
    card (gloo with the collectives staged through the host, or nccl with
    four cards), flash attention at prefill: prefill, two decode steps, the
    loss and every gradient equal the unsharded model's on the CPU (TF32
    off; float32 sums in other orders)."""
    import dataclasses

    from repro_torch.configs import ShapeSpec, reduced_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (
        build_decode_programs, build_prefill_programs, build_train_programs,
    )
    from repro_torch.models import Ctx, api

    cfg = dataclasses.replace(reduced_config("llama3.2-3b"), attn_impl="flash")
    # the ranks draw with the card's generator: the CPU model takes those weights
    model = api.init_params(cfg, seed=0, device=cuda).to("cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 35)))
    ctx = Ctx(cfg)
    want, caches = api.prefill(ctx, model, toks[:, :32], 34)
    want_dec = []
    for i in range(2):
        logits, caches = api.decode_step(ctx, model, toks[:, 32 + i:33 + i], caches)
        want_dec.append(logits)
    tcfg = dataclasses.replace(cfg, attn_impl="reference")
    with torch.enable_grad():
        loss = api.loss_fn(Ctx(tcfg), model, {"tokens": toks[:, :33]})
        grads = dict(zip([n for n, _ in model.named_parameters()],
                         torch.autograd.grad(loss, list(model.parameters()))))
    mesh = make_mesh((2, 2), ("data", "model"), device=cuda, timeout=300)
    try:
        pre = build_prefill_programs(cfg, mesh, ShapeSpec("p", "prefill", 34, 4))
        dec = build_decode_programs(cfg, mesh, ShapeSpec("d", "decode", 34, 4))
        pre.init(seed=0)
        tol = dict(rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(pre.step({"tokens": toks[:, :32].to(cuda)}).cpu(), want, **tol)
        assert all(st["flash_launches"] == cfg.num_layers for st in pre.last_stats)
        for i in range(2):
            torch.testing.assert_close(dec.step(toks[:, 32 + i:33 + i].to(cuda)).cpu(),
                                       want_dec[i], **tol)
        train = build_train_programs(tcfg, mesh, ShapeSpec("t", "train", 32, 4))
        train.init(seed=0)
        got_loss, got = train.loss_and_grads({"tokens": toks[:, :33].to(cuda)})
        torch.testing.assert_close(got_loss.cpu(), loss.detach(), **tol)
        for name, g in grads.items():
            scale = float(g.abs().max()) or 1.0
            torch.testing.assert_close(got[name].cpu(), g, rtol=0, atol=1e-4 * scale, msg=name)
    finally:
        mesh.close()
    assert mesh.exit_codes == [0] * 4


def _mesh_memory_gib(progs) -> list:
    return [round(st.get("peak_bytes", 0) / 2**30, 2) for st in progs.last_stats]


def test_lm_mesh_llama_full_width_on_four_cards(cuda):
    """llama3.2-3b at full width on a 2 x 2 mesh, one nccl rank a card: a
    4 x 2048 prefill with flash attention, 8 decode steps fed the unsharded
    model's greedy tokens and one train step (reference attention, remat),
    held to the unsharded model on card 0 (logits 0.5, loss 0.01). Prints
    the times and each card's peak memory."""
    import dataclasses
    import time

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (
        build_decode_programs, build_prefill_programs, build_train_programs,
    )
    from repro_torch.models import Ctx, api
    from repro_torch.optim import AdamWConfig

    _lm_mesh_needs(4)
    cfg = dataclasses.replace(get_config("llama3.2-3b"), attn_impl="flash")
    tcfg = dataclasses.replace(cfg, attn_impl="reference")
    rng = np.random.default_rng(1)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 2048))).to(cuda)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 2049))).to(cuda)}
    model = api.init_params(cfg, seed=0, device=cuda)
    ctx = Ctx(cfg)
    want, caches = api.prefill(ctx, model, prompts, 2056)
    tokens, want_dec = [want.argmax(-1)], []
    for _ in range(8):
        logits, caches = api.decode_step(ctx, model, tokens[-1], caches)
        want_dec.append(logits.float())
        tokens.append(logits.argmax(-1))
    with torch.no_grad():
        want_loss = float(api.loss_fn(Ctx(tcfg), model, batch))
    del model, caches
    torch.cuda.empty_cache()
    mesh = make_mesh((2, 2), ("data", "model"), device=cuda, timeout=600)
    try:
        assert mesh.backend == "nccl"
        shape = ShapeSpec("p", "prefill", 2056, 4)
        pre = build_prefill_programs(cfg, mesh, shape)
        dec = build_decode_programs(cfg, mesh, dataclasses.replace(shape, kind="decode"))
        pre.init(seed=0)
        pre.step({"tokens": prompts})
        t0 = time.perf_counter()
        got = pre.step({"tokens": prompts})
        prefill_ms = (time.perf_counter() - t0) * 1e3
        assert float((got.float() - want.float()).abs().max()) <= 0.5
        errs, ms = [], []
        for i in range(8):
            t0 = time.perf_counter()
            logits = dec.step(tokens[i])
            ms.append((time.perf_counter() - t0) * 1e3)
            errs.append(float((logits.float() - want_dec[i]).abs().max()))
        assert max(errs) <= 0.5, errs
        serve_mem = _mesh_memory_gib(dec)
        pre.release()
        train = build_train_programs(tcfg, mesh, ShapeSpec("t", "train", 2048, 4),
                                     AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=4))
        train.init(seed=0)
        t0 = time.perf_counter()
        metrics = train.step(batch)
        step_ms = (time.perf_counter() - t0) * 1e3
        assert abs(metrics["loss"] - want_loss) <= 0.01, (metrics, want_loss)
        print(f"\nlm_mesh four cards llama3.2-3b ({_card_line()}): launch to ready "
              f"{mesh.ready_seconds:.2f} s; prefill {prefill_ms:.1f} ms (max |logit diff| "
              f"{float((got.float() - want.float()).abs().max()):.4f}); decode ms {ms} (max "
              f"|diff| {max(errs):.4f}); train step {step_ms:.1f} ms, loss {metrics['loss']:.6f} "
              f"vs {want_loss:.6f}; peak GiB a card serving {serve_mem}, training "
              f"{_mesh_memory_gib(train)}; collectives {train.collectives()}")
    finally:
        mesh.close()
    assert mesh.exit_codes == [0] * 4


@pytest.mark.parametrize("arch,layers,seq", [("rwkv6-3b", 4, 2048), ("zamba2-2.7b", 6, 2048),
                                           ("whisper-small", 12, 224)])
def test_lm_mesh_families_float32_full_width_match_the_unsharded_model(cuda, arch, layers, seq):
    """The ssm, hybrid and encdec families on a 2 x 2 mesh of rank processes
    on the card (gloo, staged; nccl with four cards), float32 at full width
    and cut depth (TF32 off), flash attention at prefill: prefill at B 4,
    two decode steps and the loss equal the unsharded model's on the card
    (float32 sums in other orders), so the bf16 mesh's logit differences in
    ``chip_smoke.py`` are rounding. Prints each difference."""
    import dataclasses

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.launch.steps import (
        build_decode_programs, build_prefill_programs, build_train_programs,
    )
    from repro_torch.models import Ctx, api

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, dtype="float32",
                              attn_impl="flash")
    tcfg = dataclasses.replace(cfg, attn_impl="reference")
    rng = np.random.default_rng(1)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, seq))).to(cuda)
    extra = {k: torch.as_tensor(v).to(cuda) for k, v in stub_inputs(cfg, 4, 2).items()}
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 257))).to(cuda),
             **{k: torch.as_tensor(v).to(cuda) for k, v in stub_inputs(cfg, 4, 3).items()}}
    model = api.init_params(cfg, seed=0, device=cuda)
    want, state = api.prefill(Ctx(cfg), model, prompts, seq + 2, batch=extra)
    tokens, want_dec = [want.argmax(-1)], []
    for _ in range(2):
        logits, state = api.decode_step(Ctx(cfg), model, tokens[-1], state)
        want_dec.append(logits)
        tokens.append(logits.argmax(-1))
    with torch.no_grad():
        want_loss = api.loss_fn(Ctx(tcfg), model, batch)
    del model, state
    torch.cuda.empty_cache()
    tol = dict(rtol=1e-4, atol=1e-4)
    mesh = make_mesh((2, 2), ("data", "model"), device=cuda, timeout=600)
    try:
        pre = build_prefill_programs(cfg, mesh, ShapeSpec("p", "prefill", seq + 2, 4))
        dec = build_decode_programs(cfg, mesh, ShapeSpec("d", "decode", seq + 2, 4))
        pre.init(seed=0)
        got = [pre.step({"tokens": prompts, **extra})]
        got += [dec.step(tokens[i]) for i in range(2)]
        train = build_train_programs(tcfg, mesh, ShapeSpec("t", "train", 256, 4), key="train")
        train.init(seed=0)
        loss, _ = train.loss_and_grads(batch)
        diffs = [float((g - w).abs().max()) for g, w in zip(got, [want, *want_dec])]
        print(f"\nlm_mesh float32 {arch} ({layers} layers, S {seq}; {_card_line()}): max |logit| "
              f"{float(want.abs().max()):.4f}, max |diff| prefill and decode {diffs}; loss "
              f"{float(loss):.7f} vs {float(want_loss):.7f}")
        for g, w in zip(got, [want, *want_dec]):
            torch.testing.assert_close(g, w, **tol)
        torch.testing.assert_close(loss.cpu(), want_loss.cpu(), **tol)
    finally:
        mesh.close()
    assert mesh.exit_codes == [0] * 4


def _family_on_four_cards(cuda, arch: str, prompt: int, positions: int) -> None:
    """``arch`` at full width and depth on a 2 x 2 mesh, one nccl rank a
    card: a prefill of 4 rows of ``prompt`` tokens (after the stub frames or
    patches) with flash attention, 2 decode steps fed the unsharded model's
    greedy tokens and one train step over ``positions`` a row (reference
    attention, remat, the arch's microbatches), held to the unsharded model
    on card 0 (logits 0.5, loss 0.01). Prints the times, each card's peak
    memory and the collectives."""
    import dataclasses
    import time

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.launch.steps import (
        MICROBATCHES, build_decode_programs, build_prefill_programs, build_train_programs,
    )
    from repro_torch.models import Ctx, api
    from repro_torch.optim import AdamWConfig

    _lm_mesh_needs(4)
    cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
    tcfg = dataclasses.replace(cfg, attn_impl="reference")
    patches = cfg.num_patches if cfg.family == "vlm" else 0
    flash = {"ssm": 0, "hybrid": cfg.num_layers // (cfg.shared_attn_period or cfg.num_layers),
             "encdec": cfg.encoder_layers + 2 * cfg.num_layers}.get(cfg.family, cfg.num_layers)
    rng = np.random.default_rng(1)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, prompt))).to(cuda)
    extra = {k: torch.as_tensor(v).to(cuda) for k, v in stub_inputs(cfg, 4, 2).items()}
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (4, positions - patches + 1))).to(cuda),
        **{k: torch.as_tensor(v).to(cuda) for k, v in stub_inputs(cfg, 4, 3).items()}}
    max_len = patches + prompt + 2
    model = api.init_params(cfg, seed=0, device=cuda)
    ctx = Ctx(cfg)
    want, state = api.prefill(ctx, model, prompts, max_len, batch=extra)
    tokens, want_dec = [want.argmax(-1)], []
    for _ in range(2):
        logits, state = api.decode_step(ctx, model, tokens[-1], state)
        want_dec.append(logits.float())
        tokens.append(logits.argmax(-1))
    with torch.no_grad():
        want_loss = float(api.loss_fn(Ctx(tcfg), model, batch))
    del model, state
    torch.cuda.empty_cache()
    mesh = make_mesh((2, 2), ("data", "model"), device=cuda, timeout=600)
    try:
        assert mesh.backend == "nccl"
        shape = ShapeSpec("p", "prefill", max_len, 4)
        pre = build_prefill_programs(cfg, mesh, shape)
        dec = build_decode_programs(cfg, mesh, dataclasses.replace(shape, kind="decode"))
        pre.init(seed=0)
        t0 = time.perf_counter()
        got = pre.step({"tokens": prompts, **extra})
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_err = float((got.float() - want.float()).abs().max())
        assert prefill_err <= 0.5
        assert all(st["flash_launches"] == flash for st in pre.last_stats)
        errs, ms = [], []
        for i in range(2):
            t0 = time.perf_counter()
            logits = dec.step(tokens[i])
            ms.append((time.perf_counter() - t0) * 1e3)
            errs.append(float((logits.float() - want_dec[i]).abs().max()))
        assert max(errs) <= 0.5, errs
        serve_mem = _mesh_memory_gib(dec)
        pre.release()
        train = build_train_programs(tcfg, mesh, ShapeSpec("t", "train", positions, 4),
                                     AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=4))
        assert train.microbatches == MICROBATCHES.get(arch, 1)
        train.init(seed=0)
        t0 = time.perf_counter()
        metrics = train.step(batch)
        step_ms = (time.perf_counter() - t0) * 1e3
        assert abs(metrics["loss"] - want_loss) <= 0.01, (metrics, want_loss)
        print(f"\nlm_mesh four cards {arch} ({_card_line()}): launch to ready "
              f"{mesh.ready_seconds:.2f} s; prefill {prefill_ms:.1f} ms (first call, max |logit "
              f"diff| {prefill_err:.4f}); decode ms {ms} (max |diff| {max(errs):.4f}); train step "
              f"{step_ms:.1f} ms, loss {metrics['loss']:.6f} vs {want_loss:.6f}; peak GiB a card "
              f"serving {serve_mem}, training {_mesh_memory_gib(train)}; collectives "
              f"{train.collectives()}")
    finally:
        mesh.close()
    assert mesh.exit_codes == [0] * 4


def test_lm_mesh_zamba2_full_width_and_depth_on_four_cards(cuda):
    """zamba2-2.7b at full width and depth (54 Mamba-2 layers, the shared
    attention block at 9 points) on a 2 x 2 mesh, one nccl rank a card: a
    4 x 2048 prefill with flash attention (9 launches a rank), 2 decode
    steps fed the unsharded model's greedy tokens and one train step at 4 x
    2048 (reference attention, remat, 2 microbatches), held to the unsharded
    model on card 0 (logits 0.5, loss 0.01). Prints the times and each
    card's peak memory."""
    _family_on_four_cards(cuda, "zamba2-2.7b", 2048, 2048)


@pytest.mark.parametrize("arch,prompt,positions", [
    ("rwkv6-3b", 2048, 2048), ("whisper-small", 224, 448), ("phi-3-vision-4.2b", 1472, 2048)])
def test_lm_mesh_families_full_width_and_depth_on_four_cards(cuda, arch, prompt, positions):
    """rwkv6-3b (4 x 2048), whisper-small (224 tokens over its 1500 frames;
    training at its decoder's 448 positions) and phi-3-vision-4.2b (576 stub
    patches, then 1472 tokens) at full width and depth on four cards, as
    zamba2-2.7b's test runs it."""
    _family_on_four_cards(cuda, arch, prompt, positions)


def test_lm_mesh_moonshot_full_depth_ep_push_on_four_cards(cuda):
    """moonshot-v1-16b-a3b at full width and full depth (48 layers, 56.1 GB
    of bf16 weights, about 14 GB a card) on a 2 x 2 mesh, one nccl rank a
    card, an ep_push prefill at 4 x 2048: at capacity factor 11 (at least
    experts / top-k, so every expert's buffer holds every token) no slot
    drops and the logits hold to the unsharded prefill on card 0 (0.5);
    then at the config's 1.25, its drop share. Prints the times and each
    card's peak memory."""
    import dataclasses
    import time

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_prefill_programs
    from repro_torch.models import Ctx, api

    _lm_mesh_needs(4)
    base = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), attn_impl="flash",
                               moe_dispatch="ep_push")
    nodrop = dataclasses.replace(base, capacity_factor=11.0)
    prompts = torch.as_tensor(np.random.default_rng(1).integers(0, base.vocab_size,
                                                                (4, 2048))).to(cuda)
    model = api.init_params(nodrop, seed=0, device=cuda)
    want = api.prefill(Ctx(nodrop), model, prompts, 2048)[0].float()
    del model
    torch.cuda.empty_cache()
    mesh = make_mesh((2, 2), ("data", "model"), device=cuda, timeout=900)
    try:
        assert mesh.backend == "nccl"
        shape = ShapeSpec("p", "prefill", 2048, 4)
        pre = build_prefill_programs(nodrop, mesh, shape, key="moonshot")
        t0 = time.perf_counter()
        pre.init(seed=0)
        init_s = time.perf_counter() - t0
        pre.step({"tokens": prompts})
        t0 = time.perf_counter()
        got = pre.step({"tokens": prompts})
        ms = (time.perf_counter() - t0) * 1e3
        drops = pre.drops()
        err = float((got.float() - want).abs().max())
        assert drops["kept"] == drops["routed"] > 0, drops
        assert err <= 0.5, err
        mem = _mesh_memory_gib(pre)
        coll = pre.collectives()
        at125 = build_prefill_programs(base, mesh, shape, key="moonshot")
        t0 = time.perf_counter()
        at125.step({"tokens": prompts})
        ms125 = (time.perf_counter() - t0) * 1e3
        d = at125.drops()
        print(f"\nlm_mesh four cards moonshot-v1-16b-a3b 48 layers ep_push ({_card_line()}): "
              f"launch to ready {mesh.ready_seconds:.2f} s, init {init_s:.1f} s; prefill at "
              f"factor 11 {ms:.1f} ms (max |logit diff| {err:.4f}, no drops), at 1.25 "
              f"{ms125:.1f} ms (drop share {1 - d['kept'] / d['routed']:.5f}); peak GiB a card "
              f"{mem}; collectives {coll}")
    finally:
        mesh.close()
    assert mesh.exit_codes == [0] * 4
