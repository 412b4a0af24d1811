"""The port's execution plane: a pool of N executor workers fed by one
scheduler/compile stage, with placement, work stealing and per-worker QoS
order, on the CPU (``local`` and ``cuda``, whose kernels run their plain
versions here).

Pinned here: at W in {1, 2, 4} the mixed stream of the six main-path
signatures, with one dominant plan key so idle workers must steal, is
bit-identical to sequential ``run``; each worker starts its own groups in
non-increasing QoS order; the per-worker stats columns; placement pins and
``workers="auto"``; and the launch counters under contention.
"""
import sys
import threading

import pytest

import repro.engine as J
from repro_torch.engine import (
    CudaSubstrate, EngineService, LocalSubstrate, PlanCache, Request, placement_table, run,
)
from repro_torch.engine.substrate import CUDA_STREAM_SLOTS
from repro_torch.trace import count_launch
from torch_serving_inputs import CPU, assert_equal_results, bfs_pair, signatures, spmv_pair

SUBSTRATES = {"local": lambda: LocalSubstrate(CPU), "cuda": lambda: CudaSubstrate(CPU)}
WAIT = 60


def _service(sub, **kw) -> EngineService:
    return EngineService(substrate=sub, device=CPU, cache=PlanCache(), **kw)


@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("substrate", list(SUBSTRATES))
def test_pool_stress_bit_identical_parity(substrate, workers):
    """Mixed ops, skewed group sizes (signature 0 dominates), three
    submitter threads, open-loop arrivals with BFS at QoS 2 — bit-identical
    to sequential run at every pool width."""
    sub = SUBSTRATES[substrate]()
    sigs = signatures("port")
    order = [0] * 12 + [i % len(sigs) for i in range(12)]
    svc = _service(sub, workers=workers, qos={"bfs": 2.0}, batch_window=0.01).start()
    futures: dict = {}

    def submitter(chunk):
        for idx in chunk:
            futures[idx] = svc.submit(Request(*sigs[order[idx]]))

    threads = [threading.Thread(target=submitter, args=(range(t, len(order), 3),))
               for t in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        responses = {idx: f.result(timeout=WAIT) for idx, f in futures.items()}
    finally:
        svc.stop(timeout=WAIT)
    cache = PlanCache()
    want = [run(Request(op, inputs, st, sub), iters=1, warmup=0, cache=cache)[0]
            for op, inputs, st in sigs]
    for idx, resp in responses.items():
        assert_equal_results(resp.result, want[order[idx]])
    stats = svc.stats()
    assert stats.requests == len(order) and stats.errors == stats.rejected == 0
    assert stats.workers == workers and stats.compiles == len(sigs)
    assert sum(stats.worker_requests) + stats.compiles == len(order)
    assert sum(stats.worker_steals) == stats.steals


def test_pool_spreads_load_and_steals():
    """One dominant group on a spread-policy substrate: more than one worker
    serves, and the idle ones stole work."""
    svc = _service(CudaSubstrate(CPU), workers=4).start()
    try:
        svc.submit(Request("spmv", spmv_pair()[1])).result(timeout=WAIT)
        svc.submit(Request("bfs", bfs_pair()[1])).result(timeout=WAIT)
        svc.flush(timeout=WAIT)
        futures = [svc.submit(Request("spmv", spmv_pair()[1])) for _ in range(40)]
        futures += [svc.submit(Request("bfs", bfs_pair()[1])) for _ in range(4)]
        for f in futures:
            f.result(timeout=WAIT)
    finally:
        svc.stop(timeout=WAIT)
    stats = svc.stats()
    assert stats.workers == 4 and stats.steals >= 1
    assert sum(1 for r in stats.worker_requests if r > 0) >= 2
    assert sum(stats.worker_steals) == stats.steals


def test_per_worker_qos_ordering():
    """Within each worker, groups of its own queue start in non-increasing
    QoS order (ordering, not preemption; stolen groups are exempt)."""
    svc = _service(LocalSubstrate(CPU), workers=2, qos={"bfs": 2.0}, batch_window=0.15).start()
    try:
        svc.submit(Request("spmv", spmv_pair()[1])).result(timeout=WAIT)
        svc.submit(Request("bfs", bfs_pair()[1])).result(timeout=WAIT)
        svc.flush(timeout=WAIT)
        start = len(svc._exec_trace)
        futures = [svc.submit(Request("spmv", spmv_pair()[1])) for _ in range(6)]
        futures += [svc.submit(Request("bfs", bfs_pair()[1])) for _ in range(6)]
        for f in futures:
            f.result(timeout=WAIT)
    finally:
        svc.stop(timeout=WAIT)
    by_worker: dict[int, list[float]] = {}
    for worker, _, qos, stolen in list(svc._exec_trace)[start:]:
        if not stolen:
            by_worker.setdefault(worker, []).append(qos)
    assert by_worker
    for worker, own in by_worker.items():
        assert own == sorted(own, reverse=True), (worker, own)


def test_pool_stats_schema_and_occupancy():
    svc = _service(CudaSubstrate(CPU), workers=2, batch_window=0.02).start()
    try:
        for f in [svc.submit(Request("bfs", bfs_pair()[1]) if i % 2 else
                             Request("spmv", spmv_pair()[1])) for i in range(10)]:
            f.result(timeout=WAIT)
    finally:
        svc.stop(timeout=WAIT)
    stats = svc.stats()
    assert stats.queue_depth_hwm >= 1 and stats.workers == 2
    for column in (stats.worker_busy_seconds, stats.worker_requests, stats.worker_steals,
                   stats.worker_occupancy):
        assert len(column) == 2
    assert all(0.0 <= occ <= 1.0 + 1e-6 for occ in stats.worker_occupancy)
    assert stats.occupancy_hwm == max(stats.worker_occupancy)
    assert stats.resize_signal() in ("grow", "hold", "shrink")


def test_resize_signal_thresholds_match_reference():
    for occ, wall in (([0.9, 0.8], 1.0), ([0.1, 0.2], 1.0), ([0.5], 1.0), ([], 1.0),
                      ([0.9], 0.0)):
        from repro_torch.engine import ServiceStats

        ours = ServiceStats(worker_occupancy=occ, wall_seconds=wall).resize_signal()
        ref = J.ServiceStats(worker_occupancy=occ, wall_seconds=wall).resize_signal()
        assert ours == ref


def test_placement_pins_plan_key_to_compiling_slot():
    cache = PlanCache()
    svc = EngineService(substrate=LocalSubstrate(CPU), device=CPU, cache=cache, workers=4).start()
    try:
        for _ in range(4):
            svc.submit(Request("spmv", spmv_pair()[1])).result(timeout=WAIT)
    finally:
        svc.stop(timeout=WAIT)
    assert cache.stats()["pinned"] == 1
    key = next(iter(cache._entries))
    assert 0 <= cache.slot_of(key) < 4 and cache.is_warm(key)
    cache.pin_key(("alias",), 3)
    cache.pin_key(("alias",), 1)  # first pin wins
    assert cache.slot_of(("alias",)) == 3 and cache.slot_of(None) is None


def test_workers_auto_sizes_from_substrate():
    svc = EngineService(substrate=LocalSubstrate(CPU), device=CPU, workers="auto")
    n = svc._resolve_workers()
    assert 1 <= n <= 8 and n == min(8, LocalSubstrate(CPU).placement_slots())
    with pytest.raises(ValueError, match="workers"):
        EngineService(device=CPU, workers=0)
    with pytest.raises(ValueError, match="workers"):
        EngineService(device=CPU, workers="many")


def test_placement_table_shape():
    table = placement_table(CPU)
    assert sorted(table) == ["cuda", "local", "mesh"]
    for name, row in table.items():
        # the mesh pins a plan-key group to its slot (its ranks hold no
        # second channel to steal into); one window on the CPU
        policy = "affinity" if name == "mesh" else "spread"
        assert row["kind"] == name and row["policy"] == policy and row["slots"] >= 1
    assert table["mesh"]["slots"] == 1
    assert CUDA_STREAM_SLOTS >= 1


def test_placement_variants_are_self():
    for make in SUBSTRATES.values():
        sub = make()
        assert sub.placement_variant(1, 4) is sub and sub.placement_policy == "spread"


def test_launch_count_is_exact_under_contention():
    """``count_launch`` is what every kernel wrapper calls: eight threads
    adding at a shortened switch interval lose no count."""
    class Wrapper:
        launches = 0

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count_launch(Wrapper) for _ in range(5000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert Wrapper.launches == 8 * 5000


def test_stats_stay_consistent_under_contention():
    """Many submitters and a four-worker pool at a shortened switch
    interval: every request is counted once, in one worker's column or as
    a compile."""
    sigs = signatures("port")[:4]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    svc = _service(LocalSubstrate(CPU), workers=4).start()
    futures = []
    lock = threading.Lock()

    def submitter(t):
        for i in range(12):
            fut = svc.submit(Request(*sigs[(t + i) % len(sigs)]))
            with lock:
                futures.append(fut)

    try:
        threads = [threading.Thread(target=submitter, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        for f in futures:
            f.result(timeout=WAIT)
    finally:
        svc.stop(timeout=WAIT)
        sys.setswitchinterval(interval)
    stats = svc.stats()
    assert len(futures) == stats.requests == 96
    assert stats.compiles + stats.cache_hits == 96 and stats.compiles == len(sigs)
    assert sum(stats.worker_requests) + stats.compiles == 96
    assert len(svc) == 0
