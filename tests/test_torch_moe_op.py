"""The port's ``moe_dispatch`` op against the JAX package's, on inputs built
from the same numpy arrays: the non-mesh tests of the JAX package's
``tests/test_moe_op.py`` on the port, then, for every strategy of
``moe_dispatch_grid()`` in each scenario, with identity and with SwiGLU
experts, the output (within ``1e-5``), the dispatch mode, routed and dropped
slots and the traffic (exactly) against the reference's run; the
autotuner's pick against the reference's; and the service's answers
bit-identical to the port's oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as JC
import repro.engine as J
from repro_torch.core import Comm, MigratoryStrategy
from repro_torch.engine import (
    CudaSubstrate, EngineService, LocalSubstrate, MoEDispatchInputs, MoEDispatchOp,
    OpNotSupportedError, PlanCache, Request, candidate_grid, choose_strategy,
    moe_dispatch_grid, moe_dispatch_reference, moe_dispatch_traffic, run,
)
from repro_torch.engine.moe_op import _routing_replay
from repro_torch.models.moe import dispatch_from_strategy

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)

# (tokens, d_model, experts, nodelets): two ep-capable scenarios with
# different batch/expert/mesh shapes + one tp-fallback scenario, as the
# JAX package's tests/test_moe_op.py
SCENARIOS = [
    ("t128_e16_p8", (128, 32, 16, 8)),
    ("t256_e8_p4", (256, 24, 8, 4)),
    ("t120_e6_p4_tp", (120, 16, 6, 4)),
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


def _arrays(T: int, D: int, E: int, seed: int = 7, experts: bool = False) -> dict:
    """The JAX package's test inputs (x, router standard normal), plus
    SwiGLU expert weights at their init scale when ``experts``."""
    rng = np.random.default_rng(seed)
    out = {"x": rng.standard_normal((T, D)).astype(np.float32),
           "router": rng.standard_normal((D, E)).astype(np.float32)}
    if experts:
        F = 12
        for name, shape in (("w_gate", (E, D, F)), ("w_up", (E, D, F)), ("w_down", (E, F, D))):
            out[name] = (0.2 * rng.standard_normal(shape)).astype(np.float32)
    return out


def _both(T, D, E, P, seed=7, experts=False):
    """(reference inputs, port inputs) from the same numpy arrays."""
    a = _arrays(T, D, E, seed, experts)
    ref = J.MoEDispatchInputs(nodelets=P, **{k: jnp.asarray(v) for k, v in a.items()})
    port = MoEDispatchInputs(nodelets=P, **{k: torch.from_numpy(v) for k, v in a.items()})
    return ref, port


def _inputs(T, D, E, P, seed=7):
    return _both(T, D, E, P, seed)[1]


def _ref_strategy(st: MigratoryStrategy):
    return JC.MigratoryStrategy(
        comm=JC.Comm(st.comm.value), replicate_x=st.replicate_x, layout=JC.Layout(st.layout.value),
        scheme=JC.Scheme(st.scheme.value), grain=st.grain,
    )


# -- the JAX package's non-mesh tests (tests/test_moe_op.py), on the port ----------


@pytest.mark.parametrize("name,shape", SCENARIOS)
def test_choose_strategy_matches_exhaustive_measured_sweep(name, shape):
    """The analytic pick reaches the least *measured* traffic over an
    exhaustive engine sweep of the moe candidate grid, and its dispatch
    mode is the sweep winner's."""
    inputs = _inputs(*shape)
    sub = LocalSubstrate(CPU)
    chosen = choose_strategy("moe_dispatch", inputs, sub)
    cache = PlanCache()
    measured = {st: run(Request("moe_dispatch", inputs, st, sub), iters=1, warmup=0, cache=cache)[1]
                for st in candidate_grid("moe_dispatch")}
    min_traffic = min(r.traffic.total_bytes for r in measured.values())
    assert chosen in measured
    assert measured[chosen].traffic.total_bytes == min_traffic
    chosen_mode = dispatch_from_strategy(chosen, num_experts=inputs.num_experts,
                                         data_axis=inputs.nodelets)
    best = {r.metrics["dispatch_mode"] for r in measured.values()
            if r.traffic.total_bytes == min_traffic}
    assert chosen_mode in best


def test_push_beats_pull_when_divisible():
    inputs = _inputs(128, 32, 16, 8)
    st = choose_strategy("moe_dispatch", inputs, LocalSubstrate(CPU))
    assert st.comm == Comm.REMOTE_WRITE
    assert dispatch_from_strategy(st, num_experts=16, data_axis=8) == "ep_push"


def test_mode_mapping_and_metrics():
    inputs = _inputs(128, 32, 16, 8)
    sub = LocalSubstrate(CPU)
    for comm, want in ((Comm.MIGRATE, "ep_pull"), (Comm.REMOTE_WRITE, "ep_push")):
        st = MigratoryStrategy(comm=comm)
        _, rep = run(Request("moe_dispatch", inputs, st, sub), cache=PlanCache())
        assert rep.metrics["dispatch_mode"] == want
        assert rep.metrics["dispatch_mode"] == dispatch_from_strategy(st, num_experts=16, data_axis=8)
        assert rep.traffic.total_bytes > 0
    _, rep = run(Request("moe_dispatch", _inputs(120, 16, 6, 4), MigratoryStrategy(), sub),
                 cache=PlanCache())
    assert rep.metrics["dispatch_mode"] == "tp"
    assert rep.traffic.total_bytes == 0
    assert 0.0 <= rep.metrics["drop_fraction"] < 1.0


def test_served_through_service_bit_identical_to_oracle():
    """The service's answers (worker loop with "auto", and batch mode) equal
    the port's oracle under the autotuner's pick, bit for bit."""
    inputs = _inputs(128, 32, 16, 8)
    sub = LocalSubstrate(CPU)
    direct = moe_dispatch_reference(inputs, choose_strategy("moe_dispatch", inputs, sub))
    svc = EngineService(cache=PlanCache(), substrate=sub, device=CPU, workers=2).start()
    try:
        futures = [svc.submit(Request("moe_dispatch", inputs, "auto")) for _ in range(4)]
        responses = [f.result(timeout=120) for f in futures]
    finally:
        svc.stop()
    for resp in responses:
        assert resp.report.op == "moe_dispatch"
        assert torch.equal(resp.result, direct)
    batch = EngineService(cache=PlanCache(), substrate=sub, device=CPU)
    batch.submit(Request("moe_dispatch", inputs, "auto"))
    (resp,) = batch.drain()
    assert torch.equal(resp.result, direct)


def test_moe_dispatch_unsupported_on_cuda_and_bad_shapes():
    inputs = _inputs(128, 32, 16, 8)
    with pytest.raises(OpNotSupportedError, match="moe_dispatch"):
        run(Request("moe_dispatch", inputs, None, CudaSubstrate(CPU)))
    with pytest.raises(ValueError, match="nodelets"):
        MoEDispatchOp().plan(_inputs(130, 32, 16, 8), MigratoryStrategy(), LocalSubstrate(CPU))
    w = torch.zeros((16, 32, 12))
    with pytest.raises(ValueError, match="all-or-none"):
        run(Request("moe_dispatch", MoEDispatchInputs(inputs.x, inputs.router, w_gate=w),
                    None, LocalSubstrate(CPU)), iters=1, warmup=0, cache=PlanCache())


def test_plan_cache_reuses_moe_executor():
    inputs = _inputs(128, 32, 16, 8)
    cache, sub = PlanCache(), LocalSubstrate(CPU)
    _, r1 = run(Request("moe_dispatch", inputs, MigratoryStrategy(), sub), cache=cache)
    _, r2 = run(Request("moe_dispatch", inputs, MigratoryStrategy(), sub), cache=cache)
    assert not r1.cache_hit and r2.cache_hit
    _, r3 = run(Request("moe_dispatch", inputs, MigratoryStrategy(comm=Comm.MIGRATE), sub),
                cache=cache)
    assert not r3.cache_hit
    assert len(cache) == 2


# -- parity with the JAX package ---------------------------------------------------


@pytest.mark.parametrize("experts", [False, True], ids=["identity", "swiglu"])
@pytest.mark.parametrize("name,shape", SCENARIOS)
def test_every_strategy_matches_reference(name, shape, experts):
    ref_in, port_in = _both(*shape, experts=experts)
    sub = LocalSubstrate(CPU)
    # identical routing first: every later count rests on it
    assert _routing_replay(port_in) == J.moe_op._routing_replay(ref_in)
    for st in moe_dispatch_grid():
        jst = _ref_strategy(st)
        want, wrep = J.run(J.Request("moe_dispatch", ref_in, jst, "local"),
                           iters=1, warmup=0, cache=J.PlanCache())
        got, rep = run(Request("moe_dispatch", port_in, st, sub), iters=1, warmup=0,
                       cache=PlanCache())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=str(st))
        for key in ("dispatch_mode", "routed_slots", "dropped_slots", "expert_ffn", "experts",
                    "nodelets"):
            assert rep.metrics[key] == wrep.metrics[key], key
        assert rep.metrics["drop_fraction"] == pytest.approx(wrep.metrics["drop_fraction"], abs=0)
        assert (rep.traffic.migrations, rep.traffic.remote_writes, rep.traffic.collective_bytes) \
            == (wrep.traffic.migrations, wrep.traffic.remote_writes, wrep.traffic.collective_bytes)
        assert rep.bytes_moved == wrep.bytes_moved
        traffic = moe_dispatch_traffic(port_in, st, _routing_replay(port_in))
        assert traffic.total_bytes == rep.traffic.total_bytes
        assert torch.equal(got, moe_dispatch_reference(port_in, st))


@pytest.mark.parametrize("name,shape", SCENARIOS)
def test_choose_strategy_picks_what_the_reference_picks(name, shape):
    ref_in, port_in = _both(*shape)
    got = choose_strategy("moe_dispatch", port_in, LocalSubstrate(CPU))
    want = J.choose_strategy("moe_dispatch", ref_in)
    assert got.cache_key() == _ref_strategy(got).cache_key()
    assert _ref_strategy(got) == want


def test_drop_heavy_capacity_matches_reference():
    """capacity_factor 0.25: most slots dropped, in every mode exactly the
    reference's count, the outputs within 1e-5."""
    a = _arrays(128, 32, 16, seed=3, experts=True)
    ref_in = J.MoEDispatchInputs(nodelets=8, capacity_factor=0.25,
                                 **{k: jnp.asarray(v) for k, v in a.items()})
    port_in = MoEDispatchInputs(nodelets=8, capacity_factor=0.25,
                                **{k: torch.from_numpy(v) for k, v in a.items()})
    for st in moe_dispatch_grid():
        want, wrep = J.run(J.Request("moe_dispatch", ref_in, _ref_strategy(st), "local"),
                           iters=1, warmup=0, cache=J.PlanCache())
        got, rep = run(Request("moe_dispatch", port_in, st, LocalSubstrate(CPU)),
                       iters=1, warmup=0, cache=PlanCache())
        assert rep.metrics["dropped_slots"] == wrep.metrics["dropped_slots"] > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
