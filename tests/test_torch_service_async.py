"""The port's EngineService in worker-loop mode, on the CPU (``local`` and
``cuda``, whose kernels run their plain versions here): parity under
concurrent submission, admission control, QoS scheduling, lifecycle,
dedup and in-flight coalescing, deadlines, and the wall/busy/overlap and
latency stats schema — as the JAX package's service behaves.

Every wait has a timeout and the service's threads are daemons, so a hang
fails one test instead of the run.
"""
import threading

import numpy as np
import pytest
import torch

import repro.engine as J
from repro_torch.engine import (
    AdmissionError, CudaSubstrate, EngineService, LocalSubstrate, PlanCache, Request,
    ServiceFuture, ServiceRequest, ServiceStopped, SpMVInputs, run,
)
from repro_torch.engine.service import _WorkItem, _content_hash
from torch_serving_inputs import (
    CPU, assert_equal_results, assert_matches_reference, bfs_pair, signatures, spmv_pair,
)

SUBSTRATES = {"local": lambda: LocalSubstrate(CPU), "cuda": lambda: CudaSubstrate(CPU)}
WAIT = 60  # seconds any single wait in this file may take


@pytest.fixture(params=list(SUBSTRATES))
def sub(request):
    return SUBSTRATES[request.param]()


def _service(sub, **kw) -> EngineService:
    return EngineService(substrate=sub, device=CPU, cache=PlanCache(), **kw)


def _mixed(i: int):
    return ("bfs", bfs_pair()[1]) if i % 3 == 2 else ("spmv", spmv_pair()[1])


def _sequential(sub) -> list:
    cache = PlanCache()
    return [run(Request(op, inputs, st, sub), iters=1, warmup=0, cache=cache)[0]
            for op, inputs, st in signatures("port")]


def test_concurrent_mixed_submissions_bit_identical(sub):
    """Four threads submitting the six signatures in scrambled order get
    results bit-identical to sequential run, one compile per plan key."""
    sigs = signatures("port")
    order = [i % len(sigs) for i in range(24)]
    svc = _service(sub).start()
    futures: dict[int, ServiceFuture] = {}

    def submitter(chunk):
        for idx in chunk:
            futures[idx] = svc.submit(Request(*sigs[order[idx]]))

    threads = [threading.Thread(target=submitter, args=(range(t, len(order), 4),))
               for t in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        responses = {idx: fut.result(timeout=WAIT) for idx, fut in futures.items()}
    finally:
        svc.stop(timeout=WAIT)
    want = _sequential(sub)
    for idx, resp in responses.items():
        assert_equal_results(resp.result, want[order[idx]])
    stats = svc.stats()
    assert stats.requests == len(order)
    assert stats.compiles == len(sigs) and stats.cache_hits == len(order) - len(sigs)
    assert stats.errors == stats.rejected == 0


def test_worker_results_match_reference_service():
    """The reference's worker loop and the port's serve the same stream to
    the same answers (BFS equal, SpMV within 1e-5, GSANA within 1e-6)."""
    order = [0, 2, 4, 1, 3, 5]
    ref = J.EngineService(batch_window=0.01).start()
    try:
        ref_resp = [ref.submit(J.Request(*signatures("ref")[i])) for i in order]
        ref_results = [f.result(timeout=WAIT).result for f in ref_resp]
    finally:
        ref.stop(timeout=WAIT)
    svc = _service(CudaSubstrate(CPU), batch_window=0.01).start()
    try:
        futs = [svc.submit(Request(*signatures("port")[i])) for i in order]
        results = [f.result(timeout=WAIT).result for f in futs]
    finally:
        svc.stop(timeout=WAIT)
    for i, got, want in zip(order, results, ref_results):
        assert_matches_reference(signatures("port")[i][0], got, want)
    assert svc.stats().compiles == ref.stats().compiles == len(order)


def test_futures_resolve_and_len_drops(sub):
    svc = _service(sub).start()
    try:
        fut = svc.submit(Request("spmv", spmv_pair()[1]))
        assert isinstance(fut, ServiceFuture)
        resp = fut.result(timeout=WAIT)
        assert fut.done() and fut.exception() is None and resp.ticket == fut.ticket
        svc.flush(timeout=WAIT)
        assert len(svc) == 0
    finally:
        svc.stop(timeout=WAIT)


def test_admission_reject_bounded_queue():
    svc = _service(LocalSubstrate(CPU), max_queue_depth=2, admission="reject")
    svc.submit(Request("spmv", spmv_pair()[1]))
    svc.submit(Request("spmv", spmv_pair()[1]))
    with pytest.raises(AdmissionError, match="reject"):
        svc.submit(Request("spmv", spmv_pair()[1]))
    assert svc.stats().rejected == 1 and svc.stats().queue_depth_hwm == 2
    assert len(svc.drain()) == 2


def test_admission_block_without_worker_raises():
    svc = _service(LocalSubstrate(CPU), max_queue_depth=1, admission="block")
    svc.submit(Request("spmv", spmv_pair()[1]))
    with pytest.raises(AdmissionError, match="start"):
        svc.submit(Request("spmv", spmv_pair()[1]))
    svc.drain()


def test_admission_block_backpressure_serves_everything(sub):
    svc = _service(sub, max_queue_depth=1, admission="block").start()
    try:
        futures = [svc.submit(Request("spmv", spmv_pair()[1])) for _ in range(6)]
        assert len([f.result(timeout=WAIT) for f in futures]) == 6
    finally:
        svc.stop(timeout=WAIT)
    assert svc.stats().rejected == 0 and svc.stats().queue_depth_hwm == 1


def test_admission_reject_burst_answers_every_admitted_request(sub):
    """A burst of 16 into a depth-2 rejecting queue: some bounce, every
    admitted request is answered."""
    svc = _service(sub, max_queue_depth=2, admission="reject", batch_window=0.05).start()
    admitted, rejected = [], 0
    try:
        for i in range(16):
            try:
                admitted.append(svc.submit(Request(*_mixed(i))))
            except AdmissionError:
                rejected += 1
        for f in admitted:
            f.result(timeout=WAIT)
    finally:
        svc.stop(timeout=WAIT)
    assert rejected > 0 and rejected == svc.stats().rejected
    assert svc.stats().requests == len(admitted) == 16 - rejected


def test_stop_drains_pending_work(sub):
    svc = _service(sub, batch_window=0.2).start()
    futures = [svc.submit(Request(*_mixed(i))) for i in range(9)]
    svc.stop(timeout=WAIT)  # drain=True: returns once the queue is served
    assert all(f.done() and f.exception() is None for f in futures)
    assert svc.stats().requests == 9
    with pytest.raises(ServiceStopped):
        svc.submit(Request("spmv", spmv_pair()[1]))


def test_stop_nodrain_cancels_queued(sub):
    svc = _service(sub, batch_window=0.5).start()  # the scheduler sleeps first
    futures = [svc.submit(Request("spmv", spmv_pair()[1])) for _ in range(6)]
    svc.stop(drain=False, timeout=WAIT)
    assert all(f.done() for f in futures)
    cancelled = [f for f in futures if isinstance(f.exception(), ServiceStopped)]
    assert len(cancelled) == svc.stats().cancelled >= 1
    with pytest.raises(ServiceStopped):
        cancelled[0].result(timeout=1)


def test_restart_after_stop(sub):
    svc = _service(sub).start()
    svc.submit(Request("spmv", spmv_pair()[1])).result(timeout=WAIT)
    svc.stop(timeout=WAIT)
    svc.start()
    try:
        assert svc.submit(Request("spmv", spmv_pair()[1])).result(timeout=WAIT).report.cache_hit
    finally:
        svc.stop(timeout=WAIT)


def test_drain_is_batch_mode_only_and_start_needs_no_pending():
    svc = _service(LocalSubstrate(CPU)).start()
    with pytest.raises(RuntimeError, match="batch-mode"):
        svc.drain()
    with pytest.raises(RuntimeError, match="already started"):
        svc.start()
    svc.stop(timeout=WAIT)
    batch = _service(LocalSubstrate(CPU))
    batch.submit(Request("spmv", spmv_pair()[1]))
    with pytest.raises(RuntimeError, match="drain"):
        batch.start()
    batch.drain()


def test_bad_knobs_fail_at_construction():
    with pytest.raises(ValueError):
        EngineService(device=CPU, qos={"bfs": "high"})
    with pytest.raises(ValueError, match="admission"):
        EngineService(device=CPU, admission="drop")


def test_qos_orders_groups():
    """Higher QoS weight schedules a later-submitted group first; arrival
    order breaks ties — the same plan as the reference's scheduler."""
    orders = []
    for svc, mk_req, pkg, sub in (
        (J.EngineService(qos={"bfs": 2.0}), J.ServiceRequest, "ref", "local"),
        (_service(LocalSubstrate(CPU), qos={"bfs": 2.0}), ServiceRequest, "port",
         LocalSubstrate(CPU)),
    ):
        sigs = signatures(pkg)
        futs = J.ServiceFuture if pkg == "ref" else ServiceFuture
        items = [
            (J.service._WorkItem if pkg == "ref" else _WorkItem)(
                mk_req(t, sigs[i][0], sigs[i][1], sigs[i][2], sub), futs(t))
            for t, i in enumerate([0, 2, 0])
        ]
        groups = svc._plan_groups(items)
        orders.append([(g[0].op.name, [it.request.ticket for it in g]) for g in groups])
    assert orders[0] == orders[1] == [("bfs", [1]), ("spmv", [0, 2])]


def test_worker_stats_wall_busy_overlap_schema(sub):
    svc = _service(sub, batch_window=0.05).start()
    try:
        for f in [svc.submit(Request(*_mixed(i))) for i in range(8)]:
            f.result(timeout=WAIT)
    finally:
        svc.stop(timeout=WAIT)
    stats = svc.stats()
    assert stats.wall_seconds > 0 and 0 < stats.busy_seconds <= stats.wall_seconds + 1e-6
    assert stats.overlap_seconds >= 0.0 and stats.overlap_ratio >= 0.0
    assert list(stats.to_dict()) == list(J.ServiceStats().to_dict())


def test_request_error_resolves_future_not_pipeline(sub):
    svc = _service(sub).start()
    try:
        bad = svc.submit(Request("no-such-op", spmv_pair()[1]))
        good = svc.submit(Request("spmv", spmv_pair()[1]))
        with pytest.raises(ValueError, match="unknown op"):
            bad.result(timeout=WAIT)
        assert good.result(timeout=WAIT).report.op == "spmv"
    finally:
        svc.stop(timeout=WAIT)
    assert svc.stats().errors == 1


def test_executor_failure_reaches_its_future(sub, monkeypatch):
    """A kernel that raises inside a worker fails that request's future
    (with the kernel's exception) and nothing else."""
    from repro_torch.engine import default_registry

    real = default_registry().resolve_kernel("bfs", sub.kind)

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    svc = _service(sub).start()
    try:
        monkeypatch.setattr(sub, "kernel", lambda name: (broken if name == "bfs" else
                                                         type(sub).kernel(sub, name)))
        bad = svc.submit(Request("bfs", bfs_pair()[1]))
        good = svc.submit(Request("spmv", spmv_pair()[1]))
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            bad.result(timeout=WAIT)
        assert good.result(timeout=WAIT).result is not None
    finally:
        svc.stop(timeout=WAIT)
    assert svc.stats().errors == 1 and real is default_registry().resolve_kernel("bfs", sub.kind)


def test_latency_percentile_schema_and_ordering(sub):
    svc = _service(sub, batch_window=0.02).start()
    try:
        for f in [svc.submit(Request(*_mixed(i))) for i in range(8)]:
            f.result(timeout=WAIT)
    finally:
        svc.stop(timeout=WAIT)
    stats = svc.stats()
    assert 0.0 <= stats.queue_wait_p50 <= stats.queue_wait_p95 <= stats.queue_wait_p99
    assert 0.0 < stats.service_p50 <= stats.service_p95 <= stats.service_p99
    assert stats.queue_wait_p50 > 0.0  # the batch window makes every request wait


def test_percentiles_measured_in_batch_mode_too():
    svc = _service(LocalSubstrate(CPU))
    svc.submit(Request("spmv", spmv_pair()[1]))
    svc.submit(Request("spmv", spmv_pair()[1]))
    svc.drain()
    assert svc.stats().service_p50 > 0.0 and svc.stats().queue_wait_p50 >= 0.0


def test_dedup_serves_worker_repeats_without_reexecution(sub):
    want, _ = run(Request("spmv", spmv_pair()[1], None, sub), iters=1, warmup=0,
                  cache=PlanCache())
    svc = _service(sub, dedup=True).start()
    try:
        first = svc.submit(Request("spmv", spmv_pair()[1])).result(timeout=WAIT)
        repeats = [svc.submit(Request("spmv", spmv_pair()[1])) for _ in range(5)]
        other = svc.submit(Request("bfs", bfs_pair()[1]))
        responses = [f.result(timeout=WAIT) for f in repeats]
        other.result(timeout=WAIT)
    finally:
        svc.stop(timeout=WAIT)
    stats = svc.stats()
    assert stats.dedup_hits == 5 and stats.requests == 7
    for resp in [first, *responses]:
        assert_equal_results(resp.result, want)
    assert len({r.ticket for r in [first, *responses]}) == 6


def test_dedup_in_batch_drain_and_strategy_distinguishes(sub):
    import repro_torch.core as T

    svc = _service(sub, dedup=True)
    for _ in range(3):
        svc.submit(Request("spmv", spmv_pair()[1]))
    svc.submit(Request("spmv", spmv_pair()[1], T.MigratoryStrategy(replicate_x=False)))
    assert len(svc.drain()) == 4
    assert svc.stats().dedup_hits == 2
    svc.submit(Request("spmv", spmv_pair()[1]))
    svc.drain()
    assert svc.stats().dedup_hits == 3  # across drains too


def test_dedup_disabled_by_default():
    svc = _service(LocalSubstrate(CPU))
    for _ in range(3):
        svc.submit(Request("spmv", spmv_pair()[1]))
    svc.drain()
    assert svc.stats().dedup_hits == 0


def test_inflight_coalescing_attaches_waiters(sub):
    """Concurrent identical requests coalesce onto the pending primary:
    one execution, distinct tickets, one shared report."""
    want, _ = run(Request("spmv", spmv_pair()[1], None, sub), iters=1, warmup=0,
                  cache=PlanCache())
    svc = _service(sub, dedup=True, batch_window=0.25).start()
    try:
        primary = svc.submit(Request("spmv", spmv_pair()[1]))
        dups = [svc.submit(Request("spmv", spmv_pair()[1])) for _ in range(7)]
        assert not primary.done()  # still inside the batch window
        responses = [f.result(timeout=WAIT) for f in [primary, *dups]]
    finally:
        svc.stop(timeout=WAIT)
    stats = svc.stats()
    assert stats.dedup_coalesced == stats.dedup_hits == 7 and stats.requests == 8
    assert stats.compiles + stats.cache_hits == 1
    for resp in responses:
        assert_equal_results(resp.result, want)
    assert len({r.ticket for r in responses}) == 8
    assert all(r.report is responses[0].report for r in responses[1:])


def test_coalesced_waiters_fail_with_their_primary(sub):
    svc = _service(sub, dedup=True, batch_window=0.25).start()
    try:
        primary = svc.submit(Request("spmv", "not-spmv-inputs"))
        dups = [svc.submit(Request("spmv", "not-spmv-inputs")) for _ in range(3)]
        excs = [f.exception(timeout=WAIT) for f in [primary, *dups]]
    finally:
        svc.stop(timeout=WAIT)
    assert all(e is not None and type(e) is type(excs[0]) for e in excs)
    assert svc.stats().errors == 4


@pytest.mark.parametrize("delay", [0.0, 0.02, 0.08])
def test_stop_nodrain_terminates_every_future(delay):
    """stop(drain=False) racing mid-flight groups across the pool leaves
    every submitted future resolved, errored or cancelled."""
    svc = _service(CudaSubstrate(CPU), workers=4, dedup=True, batch_window=0.05).start()
    futures = [svc.submit(Request(*_mixed(i))) for i in range(24)]
    if delay:
        threading.Event().wait(delay)
    svc.stop(drain=False, timeout=WAIT)
    assert all(f.done() for f in futures)
    served = sum(1 for f in futures if f.exception() is None)
    cancelled = sum(1 for f in futures if isinstance(f.exception(), ServiceStopped))
    assert served + cancelled == len(futures)
    assert svc.stats().cancelled >= cancelled
    assert len(svc) == 0


def test_dedup_hash_distinguishes_large_tensor_values():
    """Two inputs differing in one interior element never collide (the hash
    reads every byte, not a repr)."""
    a = spmv_pair(24, 1)[1]
    x2 = a.x.clone()
    x2[300] += 5.0
    b = SpMVInputs(a.a, x2)
    sub = LocalSubstrate(CPU)
    ha, hb = (_content_hash("spmv", v, None, sub) for v in (a, b))
    assert ha != hb and ha == _content_hash("spmv", a, None, sub)
    # equal bytes whatever the tensor's memory layout
    c = SpMVInputs(a.a, torch.from_numpy(a.x.numpy().copy()))
    assert _content_hash("spmv", c, None, sub) == ha
    svc = _service(sub, dedup=True)
    svc.submit(Request("spmv", a))
    svc.submit(Request("spmv", b))
    ra, rb = svc.drain()
    assert svc.stats().dedup_hits == 0
    assert not np.array_equal(ra.result.numpy(), rb.result.numpy())


@pytest.mark.parametrize("mode", ["batch", "async"])
def test_launch_serve_ops_modes_on_the_cpu(mode, monkeypatch, tmp_path, capsys):
    """``launch/serve.py --ops`` / ``--ops-async --ops-workers 2 --device cpu``:
    every request served, the report printed as JSON last."""
    import json

    from repro_torch.launch import serve
    from repro_torch.machine import reset_default_machine_cache

    monkeypatch.setenv("REPRO_TORCH_MACHINE_PATH", str(tmp_path / "absent.json"))
    reset_default_machine_cache()
    try:
        args = ["--ops", "--ops-requests", "12", "--device", "cpu"] if mode == "batch" else [
            "--ops-async", "--ops-workers", "2", "--ops-requests", "12", "--ops-rate", "1000",
            "--device", "cpu"]
        serve.main(args)
    finally:
        reset_default_machine_cache()
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["requests"] == 12 and report["errors"] == 0
    assert report["compiles"] == 3 and report["workers"] == (1 if mode == "batch" else 2)
