"""The port's EngineService in batch mode, against the JAX package's.

The same submission sequence over the six main-path signatures (SpMV S1
on/off, BFS remote_write/migrate, GSANA HCB/BLK PAIR), built from the same
numpy arrays, goes through the reference's service (``local``) and the
port's (``local`` and ``cuda``, both on the CPU, where ``cuda`` runs each
kernel's plain version): the results agree (BFS parents equal, SpMV within
``rtol=atol=1e-5``, GSANA scores within ``1e-6`` and candidates equal where
not tied), and the counters agree (compiles, cache hits, dedup hits and
coalesced, rejected, timed out). Batched results are bit-identical to
sequential ``run`` of the port.
"""
import functools
import time

import pytest
import torch

import repro.engine as J
import repro_torch.core as T
from repro_torch.engine import (
    AdmissionError, CudaSubstrate, EngineService, LocalSubstrate, PlanCache, Request,
    ServiceTimeout, run,
)
from torch_serving_inputs import (
    CPU, assert_equal_results, assert_matches_reference, signatures, spmv_pair,
)

SUBSTRATES = {"local": lambda: LocalSubstrate(CPU), "cuda": lambda: CudaSubstrate(CPU)}
# the submission sequence: every signature, then repeats in another order
SEQUENCE = [0, 1, 2, 3, 4, 5, 0, 2, 4, 1, 3, 5]
COUNTERS = ("requests", "batches", "drains", "compiles", "cache_hits", "dedup_hits",
            "dedup_coalesced", "rejected", "timed_out", "errors", "cancelled")


def _sequence(make_service, request_cls, pkg, dedup):
    """Run SEQUENCE through a depth-bounded rejecting service, one
    rejected submission past the bound, then a second drain of one repeat.
    Returns (first drain's responses, the counters)."""
    sigs = signatures(pkg)
    svc = make_service(dedup=dedup, max_queue_depth=len(SEQUENCE), admission="reject")
    for i in SEQUENCE:
        svc.submit(request_cls(*sigs[i]))
    with pytest.raises(Exception, match="queue full"):
        svc.submit(request_cls(*sigs[0]))
    responses = svc.drain()
    svc.submit(request_cls(*sigs[0]))
    svc.drain()
    stats = svc.stats()
    return responses, {name: getattr(stats, name) for name in COUNTERS}


@functools.cache
def _reference_sequence(dedup: bool):
    return _sequence(J.EngineService, J.Request, "ref", dedup)


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("substrate", list(SUBSTRATES))
def test_batch_sequence_matches_reference(substrate, dedup):
    sub = SUBSTRATES[substrate]()
    ref_responses, ref_counts = _reference_sequence(dedup)
    responses, counts = _sequence(
        lambda **kw: EngineService(substrate=sub, device=CPU, **kw),
        lambda op, inputs, st: Request(op, inputs, st), "port", dedup,
    )
    assert counts == ref_counts
    assert [r.ticket for r in responses] == [r.ticket for r in ref_responses]
    sigs = signatures("port")
    for i, resp, ref in zip(SEQUENCE, responses, ref_responses):
        assert resp.report.substrate == substrate
        assert_matches_reference(sigs[i][0], resp.result, ref.result)


@pytest.mark.parametrize("substrate", list(SUBSTRATES))
def test_batch_timeout_counts_match_reference(substrate):
    """A request whose deadline passed before drain() is shed with
    ServiceTimeout in both packages, and counted once."""
    op, inputs, st = signatures("ref")[0]
    ref = J.EngineService()
    ref.submit(J.Request(op, inputs, st, timeout=0.0))
    time.sleep(0.01)
    with pytest.raises(J.ServiceTimeout):
        ref.drain()
    op, inputs, st = signatures("port")[0]
    svc = EngineService(substrate=SUBSTRATES[substrate](), device=CPU)
    svc.submit(Request(op, inputs, st, timeout=0.0))
    time.sleep(0.01)
    with pytest.raises(ServiceTimeout):
        svc.drain()
    assert svc.stats().timed_out == ref.stats().timed_out == 1
    assert svc.stats().errors == ref.stats().errors == 0


@pytest.mark.parametrize("substrate", list(SUBSTRATES))
def test_batched_results_bit_identical_to_sequential(substrate):
    sub = SUBSTRATES[substrate]()
    sigs = signatures("port")
    svc = EngineService(substrate=sub, device=CPU)
    tickets = [svc.submit(Request(op, inputs, st)) for op, inputs, st in sigs]
    responses = svc.drain()
    assert [r.ticket for r in responses] == tickets
    for (op, inputs, st), resp in zip(sigs, responses):
        want, _ = run(Request(op, inputs, st, sub), iters=1, warmup=0, cache=PlanCache())
        assert_equal_results(resp.result, want)


def test_same_key_batch_compiles_once():
    svc = EngineService(substrate=LocalSubstrate(CPU), device=CPU)
    inputs = spmv_pair()[1]
    for _ in range(4):
        svc.submit(Request("spmv", inputs))
    svc.submit(Request("spmv", spmv_pair(24, 1)[1]))  # a second signature
    responses = svc.drain()
    stats = svc.stats()
    assert len(responses) == 5
    assert stats.compiles == 2 and stats.cache_hits == 3 and stats.batches == 2
    assert stats.amortization == pytest.approx(2.5)
    assert [r.report.cache_hit for r in responses[:4]] == [False, True, True, True]


def test_second_drain_serves_from_warm_cache():
    svc = EngineService(substrate=CudaSubstrate(CPU), device=CPU)
    svc.submit(Request("spmv", spmv_pair()[1]))
    svc.drain()
    svc.submit(Request("spmv", spmv_pair()[1]))
    (resp,) = svc.drain()
    assert resp.report.cache_hit and svc.stats().drains == 2


def test_empty_drain_and_queue_len():
    svc = EngineService(device=CPU)
    assert svc.drain() == []
    svc.submit(Request("spmv", spmv_pair()[1], substrate=LocalSubstrate(CPU)))
    assert len(svc) == 1
    svc.drain()
    assert len(svc) == 0


def test_autotune_mode_picks_model_optimal(monkeypatch, tmp_path):
    from repro_torch.machine import reset_default_machine_cache

    monkeypatch.setenv("REPRO_TORCH_MACHINE_PATH", str(tmp_path / "absent.json"))
    reset_default_machine_cache()
    try:
        svc = EngineService(substrate=LocalSubstrate(CPU), device=CPU, autotune=True)
        svc.submit(Request("spmv", spmv_pair()[1]))  # no strategy -> "auto"
        (resp,) = svc.drain()
    finally:
        reset_default_machine_cache()
    assert resp.report.strategy["replicate_x"] is True
    assert resp.report.traffic.migrations == 0


def test_shared_cache_pools_compiles():
    shared, sub = PlanCache(), CudaSubstrate(CPU)
    run(Request("spmv", spmv_pair()[1], None, sub), iters=1, warmup=0, cache=shared)
    svc = EngineService(cache=shared, substrate=sub, device=CPU)
    svc.submit(Request("spmv", spmv_pair()[1]))
    (resp,) = svc.drain()
    assert resp.report.cache_hit  # first called outside the service, reused inside


def test_substrate_names_resolve_on_the_service_device():
    svc = EngineService(substrate="cuda", device=CPU)
    assert isinstance(svc.default_substrate, CudaSubstrate)
    assert svc.default_substrate.device.type == "cpu"
    svc.submit(Request("spmv", spmv_pair()[1], substrate="local"))
    svc.submit(Request("spmv", spmv_pair()[1]))
    local, cuda = svc.drain()
    assert (local.report.substrate, cuda.report.substrate) == ("local", "cuda")
    with pytest.raises(ValueError, match="unknown substrate"):
        EngineService(substrate="pallas", device=CPU)


def test_a_service_on_the_card_needs_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineService()  # the default device is the card


def test_throughput_report_schema_matches_reference():
    svc = EngineService(substrate=LocalSubstrate(CPU), device=CPU)
    svc.submit(Request("spmv", spmv_pair()[1]))
    svc.drain()
    ref = J.EngineService()
    ref.submit(J.Request("spmv", spmv_pair()[0]))
    ref.drain()
    report, ref_report = svc.throughput_report(), ref.throughput_report()
    assert list(report) == list(ref_report)
    assert list(report["cache"]) == list(ref_report["cache"])
    assert report["requests"] == 1 and report["cache"]["entries"] == 1


def test_drain_mode_wall_equals_busy():
    svc = EngineService(substrate=LocalSubstrate(CPU), device=CPU)
    svc.submit(Request("spmv", spmv_pair()[1]))
    svc.submit(Request("spmv", spmv_pair()[1]))
    svc.drain()
    stats = svc.stats()
    assert stats.wall_seconds > 0
    assert stats.busy_seconds == pytest.approx(stats.wall_seconds)
    assert stats.overlap_seconds == 0.0 and stats.overlap_ratio == 0.0


def test_submit_takes_only_a_request():
    svc = EngineService(device=CPU)
    with pytest.raises(TypeError, match="takes a Request"):
        svc.submit("spmv")  # type: ignore[arg-type]
    with pytest.raises(TypeError):
        svc.submit(Request("spmv", spmv_pair()[1]), spmv_pair()[1])  # type: ignore[call-arg]
    with pytest.raises(AdmissionError, match="start"):
        bounded = EngineService(device=CPU, max_queue_depth=1)
        bounded.submit(Request("spmv", spmv_pair()[1], T.MigratoryStrategy()))
        bounded.submit(Request("spmv", spmv_pair()[1]))
