"""The port's autotuner against the JAX package's, on the CPU.

The same numpy-built inputs go through the reference's ``rank_strategies``
(substrate ``local``) and the port's (on ``LocalSubstrate("cpu")``): the
ranked tables are equal row for row — strategy order, traffic bytes,
balance penalty and every detail column but ``substrate_memory``, which
describes each package's own kernels. The paper's picks hold, every
candidate's modeled traffic equals what the engine reports for it,
``strategy="auto"`` runs the pick, and probes warm the plan cache.

No machine file is read: an autouse fixture points both packages' paths
at files that do not exist, so a calibration left on this host changes no
ranking here.
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro.engine as RE
import repro.sparse as RS
import repro_torch.core as T
import repro_torch.sparse as TS
from repro_torch.core import Comm, Layout, Scheme, cost_model_for, strategy_grid
from repro_torch.engine import (
    CUDA_BLOCK_CANDIDATES, BFSInputs, CudaSubstrate, GSANAInputs, LocalSubstrate, PlanCache,
    ProbeStore, Request, SpMVInputs, autotune, build_plan, candidate_grid, choose_strategy,
    rank_strategies, run,
)

CPU = "cpu"
SCENARIOS = [
    ("spmv", "laplacian"), ("spmv", "skewed"), ("bfs", "er"), ("bfs", "rmat"),
    ("gsana", "n128"), ("gsana", "n192"),
]


@pytest.fixture(autouse=True)
def _no_machine_files(tmp_path, monkeypatch):
    """Neither package reads a machine or probe file left on this host."""
    from repro.machine import reset_default_machine_cache as reset_ref
    from repro_torch.engine import probes
    from repro_torch.machine import reset_default_machine_cache

    monkeypatch.setenv("REPRO_TORCH_MACHINE_PATH", str(tmp_path / "absent_machine.json"))
    monkeypatch.setenv("REPRO_TORCH_PROBES_PATH", str(tmp_path / "absent_probes.json"))
    monkeypatch.setenv("REPRO_MACHINE_PATH", str(tmp_path / "absent_ref_machine.json"))
    monkeypatch.setattr(probes, "_default_store", None)
    reset_default_machine_cache()
    reset_ref()
    yield
    reset_default_machine_cache()
    reset_ref()


def spmv_inputs(case: str):
    """(reference inputs, port inputs) of one SpMV scenario."""
    build = (lambda mod, **kw: mod.laplacian_2d(10, **kw)) if case == "laplacian" else (
        lambda mod, **kw: mod.skewed_matrix(400, 6, 48, seed=1, **kw))
    a_ref, a = build(RS), build(TS, device=CPU)
    k = int(np.diff(np.asarray(a_ref.indptr)).max())
    x = np.random.default_rng(0).standard_normal(a.n_cols).astype(np.float32)
    return (RE.SpMVInputs(R.partition_ell(a_ref, 8, k=k), x),
            SpMVInputs(T.partition_ell(a, 8, k=k, device=CPU), torch.as_tensor(x)))


def bfs_inputs(case: str):
    gen = (RS.erdos_renyi_edges if case == "er" else RS.rmat_edges)(8, 6, seed=7)
    return (RE.BFSInputs(RS.partition_graph(RS.edges_to_csr(gen, 256), 8), 0),
            BFSInputs(TS.partition_graph(TS.edges_to_csr(gen, 256, device=CPU), 8, device=CPU),
                      0))


def gsana_inputs(n: int):
    def build(core, **kw):
        vs1, vs2, pi = core.generate_alignment_pair(n, seed=3, **kw)
        grid = core.pick_grid(n, 32)
        cap = max(core.bucketize(vs1, grid, **kw).cap, core.bucketize(vs2, grid, **kw).cap)
        return vs1, vs2, core.bucketize(vs1, grid, cap=cap, **kw), \
            core.bucketize(vs2, grid, cap=cap, **kw), pi

    *ref, pi = build(R)
    *port, _ = build(T, device=CPU)
    return RE.GSANAInputs(*ref, ground_truth=pi), GSANAInputs(*port, ground_truth=pi)


def inputs_for(op: str, case: str):
    if op == "spmv":
        return spmv_inputs(case)
    if op == "bfs":
        return bfs_inputs(case)
    return gsana_inputs(128 if case == "n128" else 192)


def row_of(estimate) -> tuple:
    """What a ranked row holds, ``substrate_memory`` aside."""
    detail = {k: v for k, v in estimate.detail.items() if k != "substrate_memory"}
    return (estimate.strategy.cache_key(), estimate.traffic_bytes, estimate.balance_penalty,
            detail, estimate.predicted_seconds)


@pytest.mark.parametrize("op,case", SCENARIOS)
def test_ranked_table_equals_reference(op, case):
    ref_in, port_in = inputs_for(op, case)
    want = [row_of(e) for e in RE.rank_strategies(op, ref_in, substrate="local")]
    got = [row_of(e) for e in rank_strategies(op, port_in, substrate=LocalSubstrate(CPU))]
    assert got == want
    # the autotuner's table carries the same rows, rank 1 chosen
    table = autotune(op, port_in, LocalSubstrate(CPU)).table()
    assert [r["rank"] for r in table] == list(range(1, len(want) + 1))
    assert table[0]["chosen"] and table[0]["substrate"] == "local"
    assert [(r["traffic_bytes"], r["balance_penalty"]) for r in table] == [w[1:3] for w in want]


@pytest.mark.parametrize("op,case", SCENARIOS)
def test_every_candidate_traffic_equals_the_measured_report(op, case):
    """Every grid point's modeled traffic is what the engine reports for it
    on the local substrate, so the pick reaches the sweep's minimum."""
    _, port_in = inputs_for(op, case)
    sub, cache = LocalSubstrate(CPU), PlanCache()
    model = cost_model_for(op, port_in)
    measured = {}
    for st in candidate_grid(op, sub):
        _, rep = run(Request(op, port_in, st, sub), iters=1, warmup=0, cache=cache)
        assert model(st).traffic_bytes == rep.traffic.total_bytes, st
        measured[st] = rep.traffic.total_bytes
    assert measured[choose_strategy(op, port_in, sub)] == min(measured.values())


def test_spmv_picks_replication():
    """Paper §5.1: replicating x eliminates migrations on both shapes."""
    for case in ("laplacian", "skewed"):
        assert choose_strategy("spmv", spmv_inputs(case)[1], LocalSubstrate(CPU)).replicate_x


def test_bfs_picks_remote_write():
    """Paper §5.2: small write packets beat migrate's context ping-pong."""
    for case in ("er", "rmat"):
        st = choose_strategy("bfs", bfs_inputs(case)[1], LocalSubstrate(CPU))
        assert st.comm == Comm.REMOTE_WRITE


def test_gsana_picks_hcb():
    """Paper §5.3: Hilbert placement co-locates buckets with their
    neighborhoods; among traffic ties the lower modeled makespan wins."""
    sub = LocalSubstrate(CPU)
    for n in (128, 192):
        inputs = gsana_inputs(n)[1]
        st = choose_strategy("gsana", inputs, sub)
        assert st.layout == Layout.HCB
        model = cost_model_for("gsana", inputs)
        chosen = model(st)
        ties = [e for e in (model(c) for c in candidate_grid("gsana", sub))
                if e.traffic_bytes == chosen.traffic_bytes]
        assert chosen.balance_penalty == min(e.balance_penalty for e in ties)


def test_rank_strategies_sorted_and_consistent():
    inputs, sub = spmv_inputs("laplacian")[1], LocalSubstrate(CPU)
    ranked = rank_strategies("spmv", inputs, substrate=sub)
    keys = [e.rank_key() for e in ranked]
    assert keys == sorted(keys)
    assert ranked[0].strategy == choose_strategy("spmv", inputs, sub)
    with pytest.raises(ValueError, match="no cost model"):
        cost_model_for("attention", None)


@pytest.mark.parametrize("op,case", [("spmv", "skewed"), ("bfs", "rmat"), ("gsana", "n128")])
@pytest.mark.parametrize("substrate", ["local", "cuda"])
def test_auto_runs_the_pick(op, case, substrate):
    """``"auto"`` returns what the strategy it picks returns, on both
    substrates (``cuda`` on CPU tensors runs each kernel's plain version)."""
    _, port_in = inputs_for(op, case)
    sub = LocalSubstrate(CPU) if substrate == "local" else CudaSubstrate(CPU)
    pick = choose_strategy(op, port_in, sub)
    got, rep = run(Request(op, port_in, "auto", sub), iters=1, warmup=0, cache=PlanCache())
    want, rep_explicit = run(Request(op, port_in, pick, sub), iters=1, warmup=0, cache=PlanCache())
    assert rep.strategy == rep_explicit.strategy
    assert rep.traffic == rep_explicit.traffic
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    if op == "gsana":  # the only scheme the cuda kernel runs is also the pick
        assert pick.scheme == Scheme.PAIR


def test_autotune_probes_warm_the_cache():
    """Probing the top-k runs their plans, so the production run of the
    winner — and ``"auto"``, the model's pick — is a cache hit."""
    inputs, sub = bfs_inputs("er")[1], LocalSubstrate(CPU)
    cache = PlanCache()
    tuned = autotune("bfs", inputs, sub, probe_top_k=2, cache=cache)
    probed = [c for c in tuned.candidates if c.probe is not None]
    assert len(probed) == 2
    assert all(not c.probe.cache_hit for c in probed)
    _, rep = run(Request("bfs", inputs, tuned.best, sub), cache=cache)
    assert rep.cache_hit
    _, rep = run(Request("bfs", inputs, "auto", sub), cache=cache)
    assert rep.cache_hit
    table = tuned.table()
    assert len(table) == len(candidate_grid("bfs", sub))
    assert sum(row["chosen"] for row in table) >= 1
    assert all("probe_seconds" in row for row in table if row["rank"] == 1)


def test_cuda_grid_sweeps_the_kernels_grains():
    sub = CudaSubstrate(CPU)
    for op in ("spmv", "bfs"):
        assert candidate_grid(op, sub) == strategy_grid(grains=CUDA_BLOCK_CANDIDATES)
    assert candidate_grid("gsana", sub) == strategy_grid()
    assert candidate_grid("bfs", LocalSubstrate(CPU)) == strategy_grid()


def test_cuda_probes_dedup_by_the_kernels_bytes(tmp_path):
    """On ``cuda`` the kernels' declared bytes do not depend on the grain:
    SpMV candidates get a probe each wherever traffic or balance differs;
    BFS grains tie in every term of the signature, so one probe covers each
    comm. A probe store serves a second session without running anything."""
    sub = CudaSubstrate(CPU)
    spmv_in, bfs_in = spmv_inputs("laplacian")[1], bfs_inputs("er")[1]
    for st in candidate_grid("spmv", sub):
        mem = cost_model_for("spmv", spmv_in)(st).detail["substrate_memory"]["cuda"]
        assert mem["access"] == "stream"
    tuned = autotune("spmv", spmv_in, sub, probe_top_k=3, iters=1, warmup=0, cache=PlanCache())
    probed = [c.estimate for c in tuned.candidates if c.probe is not None]
    assert len({(e.traffic_bytes, e.balance_penalty) for e in probed}) == len(probed) == 3
    store = ProbeStore(tmp_path / "probes.json")
    tuned = autotune("bfs", bfs_in, sub, probe_top_k=3, iters=1, warmup=0, cache=PlanCache(),
                     probe_store=store)
    probed = [c.estimate.strategy for c in tuned.candidates if c.probe is not None]
    assert sorted(st.comm.value for st in probed) == ["migrate", "remote_write"]
    assert store.recorded == 2
    again = autotune("bfs", bfs_in, sub, probe_top_k=3, cache=PlanCache(),
                     probe_store=ProbeStore(tmp_path / "probes.json"))
    persisted = [c for c in again.candidates if c.probe is not None]
    assert len(persisted) == 2 and all(c.probe_persisted for c in persisted)
    plan = build_plan("bfs", bfs_in, persisted[0].estimate.strategy, sub)
    assert ProbeStore(tmp_path / "probes.json").get(plan.key) == persisted[0].probe.seconds


def test_auto_without_a_card_raises_for_named_substrates(monkeypatch):
    """A substrate named by string is built on the card: without one, the
    ranking raises instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inputs = spmv_inputs("laplacian")[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune("spmv", inputs, "cuda")
