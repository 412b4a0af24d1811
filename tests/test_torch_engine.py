"""The port's engine surface: the RunReport row schema against the JAX
package's, the plan cache, the Request-only entry, the registry, the device
policy of substrates and kernel wrappers."""
import numpy as np
import pytest
import torch

import repro.core as R
import repro.sparse as RS
import repro_torch.core as T
import repro_torch.core.cost as cost
import repro_torch.sparse as TS
from repro.engine import Request as JRequest, SpMVInputs as JSpMVInputs, run as jrun
from repro_torch.engine import (
    CudaSubstrate, ExecutionPlan, KernelRegistry, LocalSubstrate, OpNotSupportedError, OpSpec,
    PlanCache, Request, SpMVInputs, SpMVOp, args_signature, build_plan, capabilities, compile_plan,
    default_registry, execute, get_substrate, list_substrates, plan_key, register_op, run,
)
from repro_torch.kernels.runtime import on_card

CPU = "cpu"


@pytest.fixture(autouse=True)
def _no_machine_file(tmp_path, monkeypatch):
    """No calibrated machine file: report rows keep the uncalibrated schema
    whatever file this host holds."""
    from repro_torch.machine import reset_default_machine_cache

    monkeypatch.setenv("REPRO_TORCH_MACHINE_PATH", str(tmp_path / "absent.json"))
    reset_default_machine_cache()
    yield
    reset_default_machine_cache()


@pytest.fixture(scope="module")
def spmv_pair():
    a_ref, a = RS.laplacian_2d(12), TS.laplacian_2d(12, device=CPU)
    x = np.random.default_rng(0).standard_normal(144).astype(np.float32)
    return (JSpMVInputs(R.partition_ell(a_ref, 8), x),
            SpMVInputs(T.partition_ell(a, 8, device=CPU), torch.as_tensor(x)))


@pytest.mark.parametrize("substrate", ["local", "cuda"])
def test_report_row_schema_matches_reference(spmv_pair, substrate):
    ref_in, port_in = spmv_pair
    _, rep_ref = jrun(JRequest("spmv", ref_in, R.MigratoryStrategy(), "local"))
    sub = LocalSubstrate(CPU) if substrate == "local" else CudaSubstrate(CPU)
    _, rep = run(Request("spmv", port_in, None, sub), cache=PlanCache())
    row, row_ref = rep.to_dict(), rep_ref.to_dict()
    assert list(row) == list(row_ref)
    assert row["substrate"] == substrate
    assert rep.predicted_seconds is None and "predicted_seconds" not in row
    for col in ("op", "strategy_comm", "strategy_replicate_x", "strategy_layout",
                "strategy_scheme", "strategy_grain", "migrations", "remote_writes",
                "collective_bytes", "traffic_bytes", "bytes_moved"):
        assert row[col] == row_ref[col], col
    assert isinstance(rep.to_json(), str)


def test_plan_cache_hit_after_first_call(spmv_pair):
    _, port_in = spmv_pair
    cache = PlanCache()
    sub = CudaSubstrate(CPU)
    _, cold = run(Request("spmv", port_in, None, sub), cache=cache)
    _, warm = run(Request(SpMVOp(), port_in, None, sub), cache=cache)
    assert not cold.cache_hit and cold.compile_seconds > 0
    assert warm.cache_hit and warm.compile_seconds == 0.0
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 1 and len(cache) == 1
    # another strategy or substrate is another executor
    run(Request("spmv", port_in, T.MigratoryStrategy(grain=16), sub), cache=cache)
    run(Request("spmv", port_in, None, LocalSubstrate(CPU)), cache=cache)
    assert len(cache) == 3
    cache.clear()
    assert len(cache) == 0 and cache.stats()["hits"] == 0


def test_execute_cold_mode_times_the_first_call(spmv_pair):
    _, port_in = spmv_pair
    cache = PlanCache()
    plan = build_plan("spmv", port_in, None, LocalSubstrate(CPU))
    _, seconds, first = execute(compile_plan(plan, cache), iters=1, warmup=0, cache=cache)
    assert seconds == first > 0
    assert cache.is_warm(plan.key)
    keyless = ExecutionPlan(op="spmv", strategy=plan.strategy, substrate="local",
                            inputs=port_in, executor=plan.executor, args=plan.args)
    assert not compile_plan(keyless, cache).cache_hit and cache.stats()["uncacheable"] == 1


def test_plan_key_pins_shape_strategy_and_substrate(spmv_pair):
    _, port_in = spmv_pair
    sub = LocalSubstrate(CPU)
    st = T.MigratoryStrategy()
    x2 = port_in.x + 1.0  # other values, same shape
    assert plan_key("spmv", sub, st, (port_in.a, port_in.x)) == plan_key(
        "spmv", sub, st, (port_in.a, x2))
    other = T.partition_ell(TS.laplacian_2d(8, device=CPU), 8, device=CPU)
    assert args_signature((port_in.a,)) != args_signature((other,))
    assert plan_key("spmv", sub, st, ()) != plan_key("spmv", CudaSubstrate(CPU), st, ())
    assert plan_key("spmv", sub, st, ()) != plan_key(
        "spmv", sub, T.MigratoryStrategy(replicate_x=False), ())


def test_run_takes_only_a_request(spmv_pair):
    _, port_in = spmv_pair
    with pytest.raises(TypeError, match="positional"):
        run("spmv", port_in)  # type: ignore[call-arg]
    with pytest.raises(TypeError, match="takes a Request"):
        run(SpMVOp())  # type: ignore[arg-type]
    with pytest.raises(ValueError, match="unknown strategy 'fastest'"):
        run(Request("spmv", port_in, "fastest", LocalSubstrate(CPU)))
    with pytest.raises(ValueError, match="unknown op"):
        run(Request("nope", port_in, None, LocalSubstrate(CPU)))
    with pytest.raises(ValueError, match="unknown substrate"):
        get_substrate("pallas")


def test_registry_and_capabilities(monkeypatch):
    assert list_substrates() == ["cuda", "local", "mesh"]
    table = capabilities()
    assert table == {
        **{op: {"cuda": True, "local": True, "mesh": True} for op in ("bfs", "gsana", "spmv")},
        **{op: {"cuda": False, "local": True, "mesh": True}
           for op in ("moe_decode", "moe_dispatch")}}
    with pytest.raises(OpNotSupportedError, match="moe_dispatch"):
        default_registry().resolve_kernel("moe_dispatch", "cuda")
    with pytest.raises(ValueError, match="already registered"):
        register_op(OpSpec(name="spmv", factory=SpMVOp))
    # a spec's cost model reaches cost_model_for (a private registry and
    # table, so the process-wide ones keep only the built-in ops)
    monkeypatch.setattr(cost, "COST_MODELS", dict(cost.COST_MODELS))
    KernelRegistry().register_op(
        OpSpec(name="spmv2", factory=SpMVOp, cost_model=lambda i: ("model", i)))
    assert cost.cost_model_for("spmv2", 7) == ("model", 7)
    assert CudaSubstrate(CPU).supports("gsana") and not CudaSubstrate(CPU).supports("moe")


def test_substrates_and_wrappers_follow_the_tensors_device(spmv_pair, monkeypatch):
    _, port_in = spmv_pair
    # inputs on another device than the substrate's are refused at plan time
    meta_in = SpMVInputs(T.PartitionedELL(port_in.a.cols.to("meta"), port_in.a.vals.to("meta"),
                                          port_in.a.shape), port_in.x.to("meta"))
    with pytest.raises(ValueError, match="got an input on meta"):
        build_plan("spmv", meta_in, None, LocalSubstrate(CPU))
    # the backend policy: all CPU -> plain, mixed or foreign devices -> raise
    assert on_card(port_in.x, port_in.a.cols) is False
    with pytest.raises(ValueError, match="all be on CUDA or all on the CPU"):
        on_card(port_in.x, port_in.x.to("meta"))
    # a substrate left on its default device needs a card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (LocalSubstrate, CudaSubstrate, lambda: get_substrate("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(Request("spmv", port_in))  # substrate None = "local" on the card
