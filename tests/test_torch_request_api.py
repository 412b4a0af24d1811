"""The port's ``Request``: one dataclass drives ``engine.run`` and
``EngineService.submit`` (batch and worker modes alike), with the JAX
package's serving fields — per-request ``qos`` overriding the service's
per-op weights, per-request ``timeout`` shedding expired work with a typed
``ServiceTimeout`` — and the SLO accounting, on ``local`` and ``cuda`` (the
kernels' plain versions) on the CPU. The port's ``run`` and ``submit`` take
only a Request: the reference's deprecated kwargs form is not ported.
"""
import threading
import time

import pytest

import repro.engine as J
from repro_torch.engine import (
    CudaSubstrate, EngineService, LocalSubstrate, PlanCache, Request, ServiceTimeout, run,
)
from torch_serving_inputs import CPU, assert_equal_results, signatures, spmv_pair

SUBSTRATES = {"local": lambda: LocalSubstrate(CPU), "cuda": lambda: CudaSubstrate(CPU)}


@pytest.fixture(params=list(SUBSTRATES))
def sub(request):
    return SUBSTRATES[request.param]()


def _spmv():
    return spmv_pair()[1]


def test_request_validates_qos_and_timeout_like_reference():
    Request("spmv", _spmv(), qos=2.0, timeout=1.0)
    for kwargs, match in (({"qos": 0.0}, "qos"), ({"qos": -1.0}, "qos"),
                          ({"timeout": -0.5}, "timeout")):
        with pytest.raises(ValueError, match=match):
            Request("spmv", _spmv(), **kwargs)
        with pytest.raises(ValueError, match=match):
            J.Request("spmv", spmv_pair()[0], **kwargs)
    assert [f for f in Request.__dataclass_fields__] == [f for f in J.Request.__dataclass_fields__]


def test_run_ignores_the_serving_fields(sub):
    y0, rep0 = run(Request("spmv", _spmv(), None, sub), iters=1, warmup=0, cache=PlanCache())
    y1, rep1 = run(Request("spmv", _spmv(), None, sub, qos=5.0, timeout=0.0),
                   iters=1, warmup=0, cache=PlanCache())
    assert_equal_results(y1, y0)
    assert rep1.traffic == rep0.traffic


def test_submit_request_worker_loop_equals_run(sub):
    svc = EngineService(substrate=sub, device=CPU, cache=PlanCache()).start()
    try:
        resp = svc.submit(Request("spmv", _spmv())).result(timeout=60)
    finally:
        svc.stop(timeout=60)
    want, _ = run(Request("spmv", _spmv(), None, sub), iters=1, warmup=0, cache=PlanCache())
    assert_equal_results(resp.result, want)


def test_per_request_qos_splits_scheduling_groups(sub):
    """Identical requests share one batch; a boosted duplicate forms its own
    group, and the results stay identical."""
    same = EngineService(substrate=sub, device=CPU)
    same.submit(Request("spmv", _spmv()))
    same.submit(Request("spmv", _spmv()))
    r_same = same.drain()
    assert same.stats().batches == 1

    split = EngineService(substrate=sub, device=CPU)
    split.submit(Request("spmv", _spmv()))
    split.submit(Request("spmv", _spmv(), qos=100.0))
    r_split = split.drain()
    assert split.stats().batches == 2
    for a, b in ((r_same[0], r_same[1]), (r_split[0], r_split[1])):
        assert_equal_results(a.result, b.result)


def test_per_request_qos_orders_before_the_op_table(sub):
    """A per-request weight outranks the service's per-op weight."""
    svc = EngineService(substrate=sub, device=CPU, qos={"bfs": 2.0})
    sigs = signatures("port")
    svc.submit(Request(*sigs[2]))  # bfs, weight 2 from the table
    svc.submit(Request(*sigs[0], qos=3.0))  # spmv, weight 3 of its own
    svc.submit(Request(*sigs[1]))  # spmv, weight 1
    from repro_torch.engine.service import ServiceFuture, _WorkItem

    items = [_WorkItem(req, ServiceFuture(req.ticket)) for req in svc._pending]
    order = [(g[0].op.name, svc._effective_qos(g[0])) for g in svc._plan_groups(items)]
    assert order == [("spmv", 3.0), ("bfs", 2.0), ("spmv", 1.0)]
    svc.drain()


def test_per_request_timeout_sheds_expired_work(sub):
    """A request whose deadline passed before it ran is rejected with
    ServiceTimeout and counted in stats.timed_out; the service keeps
    serving."""
    svc = EngineService(substrate=sub, device=CPU, cache=PlanCache(), batch_window=0.3).start()
    try:
        fut = svc.submit(Request("spmv", _spmv(), timeout=0.01))
        time.sleep(0.1)  # the deadline lapses inside the batch window
        with pytest.raises(ServiceTimeout):
            fut.result(timeout=60)
        ok = svc.submit(Request("spmv", _spmv())).result(timeout=60)
        assert ok.result is not None
    finally:
        svc.stop(timeout=60)
    assert svc.stats().timed_out == 1 and svc.stats().errors == 0


def test_timeout_behind_a_long_request_is_shed(sub):
    """A ``timeout=0`` request queued behind a running one never runs."""
    sigs = signatures("port")
    svc = EngineService(substrate=sub, device=CPU, cache=PlanCache()).start()
    try:
        slow = svc.submit(Request(*sigs[4]))
        late = svc.submit(Request(*sigs[0], timeout=0.0))
        slow.result(timeout=60)
        with pytest.raises(ServiceTimeout, match="deadline"):
            late.result(timeout=60)
    finally:
        svc.stop(timeout=60)
    assert svc.stats().timed_out == 1


def test_slo_stats_accounting(sub):
    """A generous target shows full attainment, an impossible one zero, and
    the end-to-end percentiles are populated."""
    svc = EngineService(substrate=sub, device=CPU, cache=PlanCache(), slo_target_seconds=600.0)
    svc.start()
    try:
        for f in [svc.submit(Request("spmv", _spmv())) for _ in range(4)]:
            f.result(timeout=60)
    finally:
        svc.stop(timeout=60)
    stats = svc.stats()
    assert stats.slo_target_seconds == 600.0
    assert (stats.slo_checked, stats.slo_violations, stats.slo_attainment) == (4, 0, 1.0)
    assert stats.total_p99 >= stats.total_p50 > 0.0
    assert stats.total_p99 >= stats.service_p50
    row = stats.to_dict()
    for key in ("slo_checked", "slo_violations", "slo_attainment", "total_p50", "total_p95",
                "total_p99", "timed_out"):
        assert key in row

    tight = EngineService(substrate=sub, device=CPU, cache=PlanCache(), slo_target_seconds=1e-12)
    tight.start()
    try:
        tight.submit(Request("spmv", _spmv())).result(timeout=60)
    finally:
        tight.stop(timeout=60)
    tstats = tight.stats()
    assert (tstats.slo_checked, tstats.slo_violations, tstats.slo_attainment) == (1, 1, 0.0)
    with pytest.raises(ValueError, match="slo_target_seconds"):
        EngineService(device=CPU, slo_target_seconds=0.0)


def test_no_slo_target_means_no_slo_accounting(sub):
    svc = EngineService(substrate=sub, device=CPU)
    svc.submit(Request("spmv", _spmv()))
    svc.drain()
    stats = svc.stats()
    assert stats.slo_target_seconds is None and stats.slo_checked == 0
    assert stats.slo_attainment is None


def test_requests_submitted_from_many_threads_equal_run(sub):
    """The same Request objects from four submitter threads: every future
    equals sequential run."""
    sigs = signatures("port")
    svc = EngineService(substrate=sub, device=CPU, cache=PlanCache(), workers=2).start()
    futures: dict = {}

    def submitter(indices):
        for i in indices:
            futures[i] = svc.submit(Request(*sigs[i % len(sigs)]))

    threads = [threading.Thread(target=submitter, args=(range(t, 12, 4),)) for t in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        got = {i: f.result(timeout=60).result for i, f in futures.items()}
    finally:
        svc.stop(timeout=60)
    for i, result in got.items():
        want, _ = run(Request(*sigs[i % len(sigs)], sub), iters=1, warmup=0, cache=PlanCache())
        assert_equal_results(result, want)
