"""The port's nodelet mesh (``repro_torch.launch.mesh``) and the ``mesh``
substrate's SpMV, BFS and GSANA, on gloo rank processes on the CPU.

Inputs are the JAX package's parity inputs (``tests/test_engine.py``'s
``PARITY_SCRIPT``: ``laplacian_2d(16)``, ``erdos_renyi_edges(9, 8, seed=1)``
root 3, ``generate_alignment_pair(384, seed=11)`` on ``pick_grid(384, 32)``)
carried over by ``convert.from_numpy``, partitioned for a 4-rank mesh (one
module mesh) and, in one case, for 8 ranks. The mesh is held bit-identical
to the port's ``local`` substrate (SpMV and BFS under all four
``(replicate_x, comm)`` strategies, GSANA under ALL and PAIR), and to the
reference's ``local`` route within the port's stated tolerances; traffic
and bytes moved equal across the substrates. Then the service, the
collectives' alpha-beta fits, and the failure contract: a killed rank
raises in the caller within the timeout, ``close()`` leaves no process, a
failed backend init raises, and no CUDA mesh starts without a card.

Every test has a time limit of its own (:data:`TEST_LIMIT_S`, an alarm),
and every mesh call one (the mesh's ``timeout``)."""
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import repro.core as R
import repro.engine as J
import repro.sparse as RS
import repro_torch.core as T
from repro_torch.convert import from_numpy, numpy_fields
from repro_torch.core.gsana_data import Buckets, VertexSet
from repro_torch.core.spmv import PartitionedELL, spmv
from repro_torch.core.bfs import bfs
from repro_torch.engine import (
    BFSInputs, EngineService, GSANAInputs, LocalSubstrate, MeshSubstrate, PlanCache, Request,
    SpMVInputs, run, substrate_for_mesh,
)
from repro_torch.launch.mesh import (
    MeshError, NodeletMesh, close_meshes, make_nodelet_mesh,
)
from repro_torch.machine.microbench import (
    COLLECTIVE_KINDS, COLLECTIVE_SIZES, calibrate, measure_collectives,
)
from repro_torch.sparse.graph import PartitionedGraph

CPU = "cpu"
P = 4
MESH_TIMEOUT_S = 30.0
TEST_LIMIT_S = 90
SPMV_TOL = dict(rtol=1e-5, atol=1e-5)
GSANA_ATOL = 1e-6
STRATEGIES = [(rep, comm) for rep in (True, False)
              for comm in (T.Comm.MIGRATE, T.Comm.REMOTE_WRITE)]


@pytest.fixture(autouse=True)
def _time_limit():
    """Each test fails with TimeoutError after TEST_LIMIT_S seconds."""

    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {TEST_LIMIT_S} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


@pytest.fixture(autouse=True)
def _no_machine_file(tmp_path, monkeypatch):
    from repro_torch.machine import reset_default_machine_cache

    monkeypatch.setenv("REPRO_TORCH_MACHINE_PATH", str(tmp_path / "absent.json"))
    reset_default_machine_cache()
    yield
    reset_default_machine_cache()


@pytest.fixture(scope="module")
def mesh():
    """The module's 4-rank gloo mesh (what ``MeshSubstrate(CPU)`` resolves
    for 4-nodelet inputs); every mesh this module started is closed after."""
    m = make_nodelet_mesh(P, CPU, timeout=MESH_TIMEOUT_S)
    yield m
    close_meshes()


def _port(cls, ref_obj):
    return from_numpy(cls, numpy_fields(ref_obj), device=CPU)


def _spmv_pair(p: int):
    a = R.partition_ell(RS.laplacian_2d(16), p)
    x = np.random.default_rng(0).standard_normal(256).astype(np.float32)
    return J.SpMVInputs(a, x), SpMVInputs(_port(PartitionedELL, a), torch.from_numpy(x.copy()))


def _bfs_pair(p: int):
    g = RS.partition_graph(RS.edges_to_csr(RS.erdos_renyi_edges(9, 8, seed=1), 512), p)
    return J.BFSInputs(g, 3), BFSInputs(_port(PartitionedGraph, g), 3)


@pytest.fixture(scope="module")
def gsana_pair():
    r1, r2, _ = R.generate_alignment_pair(384, seed=11)
    grid = R.pick_grid(384, 32)
    cap = max(R.bucketize(r1, grid).cap, R.bucketize(r2, grid).cap)
    b1, b2 = R.bucketize(r1, grid, cap=cap), R.bucketize(r2, grid, cap=cap)
    return (J.GSANAInputs(r1, r2, b1, b2),
            GSANAInputs(_port(VertexSet, r1), _port(VertexSet, r2), _port(Buckets, b1),
                        _port(Buckets, b2), nodelets=P))


def _strategy(pkg, rep, comm, **kw):
    if pkg is R:
        return R.MigratoryStrategy(replicate_x=rep, comm=R.Comm(comm.value), **kw)
    return T.MigratoryStrategy(replicate_x=rep, comm=comm, **kw)


def _run(op, inputs, st, sub):
    return run(Request(op, inputs, st, sub), iters=1, warmup=0, cache=PlanCache())


# -- the mesh itself ---------------------------------------------------------------


def test_mesh_is_gloo_ranks_with_nothing_staged_on_the_cpu(mesh):
    assert (mesh.p, mesh.backend, mesh.staged, mesh.device) == (P, "gloo", (), torch.device(CPU))
    assert all(mesh.alive()) and len(set(mesh.pids)) == P and os.getpid() not in mesh.pids
    info = mesh.memory()
    assert [i["rank"] for i in info] == list(range(P)) and [i["pid"] for i in info] == mesh.pids
    assert "backend gloo" in mesh.describe() and "nccl when" in mesh.describe()
    assert make_nodelet_mesh(P, CPU) is mesh  # one a (p, device, backend)
    assert mesh.last_call["coll_calls"] == 0 and mesh.ready_seconds > 0


def test_mesh_substrate_resolves_and_fingerprints(mesh):
    sub = MeshSubstrate(CPU)
    assert sub.mesh_for(P) is mesh and sub.placement_policy == "affinity"
    assert sub.placement_slots() == 1 and sub.placement_variant(1, 4) is sub
    explicit = substrate_for_mesh(mesh)
    assert explicit.mesh is mesh and explicit.cache_fingerprint() == ("mesh", CPU, P, "gloo",
                                                                      "explicit")
    assert sub.cache_fingerprint() == ("mesh", CPU, None)  # the width is in the args
    assert isinstance(substrate_for_mesh(None, CPU), LocalSubstrate)


# -- SpMV, BFS, GSANA: mesh == local, and the reference --------------------------------


@pytest.mark.parametrize("rep,comm", STRATEGIES)
def test_spmv_mesh_bit_identical_to_local_and_close_to_reference(mesh, rep, comm):
    ref_in, port_in = _spmv_pair(P)
    st = _strategy(T, rep, comm)
    y_local, r_local = _run("spmv", port_in, st, LocalSubstrate(CPU))
    y_mesh, r_mesh = _run("spmv", port_in, st, MeshSubstrate(CPU))
    assert torch.equal(y_mesh, y_local)
    assert (r_mesh.traffic, r_mesh.bytes_moved) == (r_local.traffic, r_local.bytes_moved)
    assert r_mesh.substrate == "mesh" and mesh.last_call is not None
    y_ref, r_ref = J.run(J.Request("spmv", ref_in, _strategy(R, rep, comm), "local"))
    np.testing.assert_allclose(y_mesh.numpy(), np.asarray(y_ref), **SPMV_TOL)
    assert r_mesh.traffic.migrations == r_ref.traffic.migrations
    assert r_mesh.bytes_moved == r_ref.bytes_moved
    if not rep:
        assert mesh.last_call["coll_calls"] == 1  # the all_gather of x


@pytest.mark.parametrize("rep,comm", STRATEGIES)
def test_bfs_mesh_bit_identical_to_local_and_reference(mesh, rep, comm):
    ref_in, port_in = _bfs_pair(P)
    st = _strategy(T, rep, comm)
    p_local, r_local = _run("bfs", port_in, st, LocalSubstrate(CPU))
    p_mesh, r_mesh = _run("bfs", port_in, st, MeshSubstrate(CPU))
    assert torch.equal(p_mesh, p_local)
    assert (r_mesh.traffic, r_mesh.bytes_moved) == (r_local.traffic, r_local.bytes_moved)
    p_ref, r_ref = J.run(J.Request("bfs", ref_in, _strategy(R, rep, comm), "local"))
    np.testing.assert_array_equal(p_mesh.numpy(), np.asarray(p_ref))
    assert r_mesh.traffic == type(r_mesh.traffic)(**r_ref.traffic.__dict__)
    assert T.validate_parents(port_in.g, 3, p_mesh)
    # a round: (all_gather of parents,) partial exchange, the alive all_reduce
    per_round = 2 if comm == T.Comm.REMOTE_WRITE else 3
    assert mesh.last_call["coll_calls"] % per_round == 0


@pytest.mark.parametrize("scheme", [T.Scheme.ALL, T.Scheme.PAIR])
def test_gsana_mesh_equal_to_local_and_reference(mesh, gsana_pair, scheme):
    ref_in, port_in = gsana_pair
    st = T.MigratoryStrategy(scheme=scheme)
    (c_local, s_local), r_local = _run("gsana", port_in, st, LocalSubstrate(CPU))
    (c_mesh, s_mesh), r_mesh = _run("gsana", port_in, st, MeshSubstrate(CPU, mesh))
    assert torch.equal(c_mesh, c_local) and torch.equal(s_mesh, s_local)
    assert r_mesh.traffic == r_local.traffic and r_mesh.bytes_moved == r_local.bytes_moved
    assert r_mesh.metrics == r_local.metrics
    (c_ref, s_ref), _ = J.run(J.Request("gsana", ref_in, R.MigratoryStrategy(
        scheme=R.Scheme(scheme.value)), "local"))
    # vertex 0 is the reference's fault (ROADMAP §3): every other row is held
    np.testing.assert_allclose(s_mesh.numpy()[1:], np.asarray(s_ref)[1:], rtol=0, atol=GSANA_ATOL)
    finite = np.isfinite(np.asarray(s_ref)[1:])
    np.testing.assert_array_equal(c_mesh.numpy()[1:][finite], np.asarray(c_ref)[1:][finite])


def test_eight_rank_mesh_from_the_input_partition(mesh):
    """P = 8 inputs resolve an 8-rank mesh of their own (the module mesh
    stays as it is); SpMV and BFS equal the local substrate."""
    _, spmv_in = _spmv_pair(8)
    _, bfs_in = _bfs_pair(8)
    sub = MeshSubstrate(CPU)
    for st in (T.MigratoryStrategy(), T.MigratoryStrategy(replicate_x=False, comm=T.Comm.MIGRATE)):
        assert torch.equal(_run("spmv", spmv_in, st, sub)[0],
                           _run("spmv", spmv_in, st, LocalSubstrate(CPU))[0])
        assert torch.equal(_run("bfs", bfs_in, st, sub)[0],
                           _run("bfs", bfs_in, st, LocalSubstrate(CPU))[0])
    eight = sub.mesh_for(8)
    assert eight.p == 8 and eight is not mesh and all(eight.alive()) and all(mesh.alive())


def test_dispatch_shims_take_a_mesh(mesh):
    _, spmv_in = _spmv_pair(P)
    _, bfs_in = _bfs_pair(P)
    st = T.MigratoryStrategy()
    assert torch.equal(spmv(spmv_in.a, spmv_in.x, st, mesh=mesh),
                       spmv(spmv_in.a, spmv_in.x, st))
    assert torch.equal(bfs(bfs_in.g, 3, st, mesh=mesh), bfs(bfs_in.g, 3, st))


def test_service_on_the_mesh_returns_run_results(mesh, gsana_pair):
    """``EngineService(substrate="mesh")`` serves every op's requests with
    ``run``'s results; affinity placement, so nothing is stolen."""
    _, spmv_in = _spmv_pair(P)
    _, bfs_in = _bfs_pair(P)
    reqs = [("spmv", spmv_in, T.MigratoryStrategy()),
            ("bfs", bfs_in, T.MigratoryStrategy(comm=T.Comm.REMOTE_WRITE)),
            ("gsana", gsana_pair[1], T.MigratoryStrategy())]
    svc = EngineService(substrate="mesh", device=CPU, workers=2, cache=PlanCache()).start()
    try:
        futures = [svc.submit(Request(op, i, st)) for op, i, st in reqs * 2]
        got = [f.result(timeout=60) for f in futures]
    finally:
        svc.stop()
    for (op, inputs, st), resp in zip(reqs * 2, got):
        want, _ = _run(op, inputs, st, LocalSubstrate(CPU))
        assert resp.report.substrate == "mesh"
        if isinstance(want, tuple):
            assert all(torch.equal(g, w) for g, w in zip(resp.result, want))
        else:
            assert torch.equal(resp.result, want)
    assert svc.stats().steals == 0


def test_calls_from_more_threads_than_cores_are_serialised(mesh):
    """Threads calling one mesh at once, at a shortened switch interval:
    every result is the local substrate's (one call's messages never
    interleave with another's)."""
    _, spmv_in = _spmv_pair(P)
    sts = [T.MigratoryStrategy(), T.MigratoryStrategy(replicate_x=False)]
    want = [_run("spmv", spmv_in, st, LocalSubstrate(CPU))[0] for st in sts]
    n_threads = 2 * (os.cpu_count() or 4)
    got: dict = {}

    def work(i):
        got[i] = [_run("spmv", spmv_in, sts[(i + j) % 2], MeshSubstrate(CPU))[0] for j in range(3)]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and sorted(got) == list(range(n_threads))
    for i, ys in got.items():
        for j, y in enumerate(ys):
            assert torch.equal(y, want[(i + j) % 2])


# -- collectives -------------------------------------------------------------------


def test_measure_collectives_on_a_two_rank_mesh():
    two = make_nodelet_mesh(2, CPU, timeout=MESH_TIMEOUT_S)
    fits = measure_collectives(COLLECTIVE_SIZES["cpu"]["quick"], mesh=two, iters=20)
    assert sorted(fits) == sorted(COLLECTIVE_KINDS)
    for kind, ab in fits.items():
        assert ab.alpha > 0 and ab.beta > 0, (kind, ab)
    assert measure_collectives((1 << 12,), device=CPU) == {}  # no mesh: one device, nothing
    profile = calibrate(device=CPU, quick=True, mesh=two)
    mesh_profile = profile.substrate("mesh")
    assert mesh_profile.source == "measured" and sorted(mesh_profile.collectives) == sorted(fits)
    assert all(mesh_profile.collective(k).alpha > 0 for k in COLLECTIVE_KINDS)
    assert mesh_profile.dispatch_overhead >= profile.substrate("local").dispatch_overhead


# -- failure -----------------------------------------------------------------------


def test_killed_rank_raises_within_the_timeout_and_close_leaves_no_process():
    m = NodeletMesh(2, CPU, timeout=MESH_TIMEOUT_S)
    _, spmv_in = _spmv_pair(2)
    sub = MeshSubstrate(CPU, m)
    st = T.MigratoryStrategy()
    _run("spmv", spmv_in, st, sub)
    os.kill(m.pids[1], signal.SIGKILL)
    t0 = time.perf_counter()
    with pytest.raises(MeshError, match="rank 1"):
        _run("spmv", spmv_in, st, sub)
    assert time.perf_counter() - t0 < MESH_TIMEOUT_S
    assert m.closed and not any(m.alive())
    with pytest.raises(MeshError, match="closed"):
        m.run(_noop_is_never_sent)


def _noop_is_never_sent(rank, world, group):  # pragma: no cover - a closed mesh sends nothing
    return rank


def test_a_failed_backend_init_raises_and_leaves_no_process(monkeypatch):
    import repro_torch.launch.mesh as mesh_mod

    # a backend this torch was not built with: every rank's init_process_group fails
    monkeypatch.setattr(mesh_mod, "backend_for", lambda p, device, cards=None: "mpi")
    before = {p.pid for p in mp.active_children()}
    with pytest.raises(MeshError, match="rank"):
        NodeletMesh(2, CPU, timeout=MESH_TIMEOUT_S)
    assert {p.pid for p in mp.active_children()} <= before


def test_no_cuda_mesh_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_nodelet_mesh(2, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshSubstrate("cuda")
