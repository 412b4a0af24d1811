"""The port's spans and counters (``repro_torch.trace``): off they record
nothing; on, spans nest under one request id on the engine path and the
serving plane, show in ``torch.profiler`` as ``cpu_op`` events only, and the
sync and memo counts charged to a request are exact."""
import json
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as T
import repro_torch.sparse as TS
from repro_torch import trace
from repro_torch.engine import (
    BFSInputs, CudaSubstrate, EngineService, LocalSubstrate, PlanCache, Request, SpMVInputs, run,
)
from repro_torch.sparse.gen import edges_to_csr, erdos_renyi_edges
from repro_torch.sparse.graph import partition_graph

CPU = "cpu"
WAIT = 30.0
ENGINE_SPANS = ("engine.plan", "engine.lookup", "engine.execute", "engine.account")


@pytest.fixture(autouse=True)
def _clean_store(tmp_path, monkeypatch):
    """An empty store, tracing off, and no calibrated machine file (which
    would add the cost model's work to the account span)."""
    from repro_torch.machine import reset_default_machine_cache

    monkeypatch.setenv("REPRO_TORCH_MACHINE_PATH", str(tmp_path / "absent.json"))
    reset_default_machine_cache()
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()
    reset_default_machine_cache()


@pytest.fixture(scope="module")
def spmv_inputs():
    a = T.partition_ell(TS.laplacian_2d(8, device=CPU), 8, device=CPU)
    return a, torch.randn(64, generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def bfs_inputs():
    edges = erdos_renyi_edges(7, 4, seed=3)
    g = partition_graph(edges_to_csr(edges, 128, device=CPU), 8, device=CPU)
    return BFSInputs(g, int(edges[0, 0]))


def _request(op, spmv_inputs, bfs_inputs, sub):
    if op == "spmv":
        a, x = spmv_inputs
        return Request("spmv", SpMVInputs(a, x), None, sub)  # a fresh SpMVInputs each call
    return Request("bfs", bfs_inputs, None, sub)


def _by_request(spans):
    out = {}
    for s in spans:
        out.setdefault(s["request"], []).append(s)
    return out


def test_off_span_is_one_shared_object_and_records_nothing(spmv_inputs, bfs_inputs):
    assert trace.span("a") is trace.span("b") is trace.request("c")
    cache = PlanCache()
    for op in ("spmv", "bfs"):
        run(_request(op, spmv_inputs, bfs_inputs, LocalSubstrate(CPU)), iters=1, warmup=0,
            cache=cache)
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["requests"] == {}


@pytest.mark.parametrize("op", ["spmv", "bfs"])
def test_spans_nest_under_one_request_id(op, spmv_inputs, bfs_inputs):
    cache = PlanCache()
    trace.enable()
    for _ in range(2):
        run(_request(op, spmv_inputs, bfs_inputs, LocalSubstrate(CPU)), iters=1, warmup=0,
            cache=cache)
    requests = _by_request(trace.snapshot()["spans"])
    assert len(requests) == 2 and None not in requests
    for spans in requests.values():
        by_id = {s["id"]: s for s in spans}
        (root,) = [s for s in spans if s["parent"] is None]
        assert root["name"] == "engine.run"
        top = [s["name"] for s in sorted(spans, key=lambda s: s["t0_ns"]) if s["parent"] == root["id"]]
        assert top == list(ENGINE_SPANS)
        for s in spans:
            assert root["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= root["t1_ns"]
            if s["parent"] is not None:
                parent = by_id[s["parent"]]
                assert parent["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= parent["t1_ns"]
        rounds = [s for s in spans if s["name"] == "bfs.round"]
        if op == "bfs":
            execute = next(s for s in spans if s["name"] == "engine.execute")
            assert rounds and all(by_id[s["parent"]] is execute for s in rounds)
        else:
            assert not rounds
        for s in spans:
            if s["name"] == "engine.derive":
                assert by_id[s["parent"]]["name"] == "engine.account"
    ids = sorted(requests)
    assert ids[0] != ids[1]


def test_spans_show_in_the_profiler_as_cpu_ops_only(spmv_inputs, bfs_inputs, tmp_path):
    cache = PlanCache()
    for op in ("spmv", "bfs"):  # warm: no first-call work inside the profile
        run(_request(op, spmv_inputs, bfs_inputs, LocalSubstrate(CPU)), iters=1, warmup=0,
            cache=cache)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.span("a") is not trace.span("a")  # on while the profiler runs
        for op in ("spmv", "bfs"):
            run(_request(op, spmv_inputs, bfs_inputs, LocalSubstrate(CPU)), iters=1, warmup=0,
                cache=cache)
    assert trace.span("a") is trace.span("b")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {"engine.run", "bfs.round", "engine.derive", *ENGINE_SPANS}
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("name") in names and e.get("ph") == "X"]
    assert events and {e["cat"] for e in events} == {"cpu_op"}
    store = sorted(trace.snapshot()["spans"], key=lambda s: s["t0_ns"])
    events.sort(key=lambda e: float(e["ts"]))
    assert [e["name"] for e in events] == [s["name"] for s in store]
    for e, s in zip(events, store):
        assert abs(float(e["dur"]) - (s["t1_ns"] - s["t0_ns"]) / 1e3) < 50.0, (e, s)


def test_counts_from_eight_threads_add_up_exactly():
    class Wrapper:
        launches = 0

    trace.enable()
    per_thread = 5000

    def work(i):
        with trace.request("worker", rid=("t", i)):
            for _ in range(per_thread):
                trace.count("sync.x")
                trace.count_launch(Wrapper)
        for _ in range(per_thread):
            trace.count("sync.x", 2)  # outside the request: kept nowhere

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert trace.snapshot()["requests"] == {("t", i): {"sync.x": per_thread} for i in range(8)}
    assert Wrapper.launches == 8 * per_thread


@pytest.mark.parametrize("substrate", ["local", "cuda"])
def test_a_spmv_request_charges_its_syncs_and_misses_the_memo(spmv_inputs, substrate):
    sub = LocalSubstrate(CPU) if substrate == "local" else CudaSubstrate(CPU)
    cache = PlanCache()
    a, x = spmv_inputs
    run(Request("spmv", SpMVInputs(a, x), None, sub), iters=1, warmup=0, cache=cache)
    trace.enable()
    run(Request("spmv", SpMVInputs(a, x), None, sub), iters=1, warmup=0, cache=cache)
    (charged,) = trace.snapshot()["requests"].values()
    assert charged == {"sync.spmv_nnz": 1, "sync.block": 1,
                       "memo.miss.spmv_traffic": 1, "memo.miss.spmv_bytes": 1}


@pytest.mark.parametrize("substrate", ["local", "cuda"])
def test_a_warm_bfs_request_hits_the_memo_and_charges_a_sync_a_round_test(bfs_inputs, substrate):
    sub = LocalSubstrate(CPU) if substrate == "local" else CudaSubstrate(CPU)
    cache = PlanCache()
    req = Request("bfs", bfs_inputs, None, sub)
    _, first = run(req, iters=1, warmup=0, cache=cache)
    trace.enable()
    _, report = run(req, iters=1, warmup=0, cache=cache)
    snap = trace.snapshot()
    (rid, charged), = snap["requests"].items()
    tests = [s for s in snap["spans"] if s["name"] == "bfs.round" and s["request"] == rid]
    # a round test a level, and one more that finds the frontier empty
    assert len(tests) == report.metrics["rounds"] + 1
    assert charged == {"sync.bfs_root": 2, "sync.bfs_frontier": len(tests), "sync.block": 1,
                       "sync.bfs_reached": 1, "memo.hit.bfs_replay": 1}
    assert not [s for s in snap["spans"] if s["name"] == "engine.derive"]
    assert report.metrics["reached"] == first.metrics["reached"]


def test_a_cold_bfs_request_charges_the_replays_host_copy(bfs_inputs):
    trace.enable()
    fresh = BFSInputs(bfs_inputs.g, bfs_inputs.root)  # the memo is keyed by the inputs object
    run(Request("bfs", fresh, None, LocalSubstrate(CPU)), iters=1, warmup=0, cache=PlanCache())
    (charged,) = trace.snapshot()["requests"].values()
    assert charged["memo.miss.bfs_replay"] == 1 and charged["sync.bfs_replay"] == 1
    assert "memo.hit.bfs_replay" not in charged


def test_the_serving_plane_spans_share_the_ticket(spmv_inputs, bfs_inputs):
    svc = EngineService(substrate=LocalSubstrate(CPU), device=CPU, cache=PlanCache(),
                        workers=2).start()
    try:
        trace.enable()
        futures = [svc.submit(_request(op, spmv_inputs, bfs_inputs, None))
                   for op in ("spmv", "bfs", "spmv", "bfs")]
        for f in futures:
            f.result(timeout=WAIT)
        trace.disable()
    finally:
        svc.stop()
    requests = _by_request(trace.snapshot()["spans"])
    for f in futures:
        spans = requests[("ticket", f.ticket)]
        names = {s["name"] for s in spans}
        assert {"service.execute", "service.handoff", "engine.lookup", "engine.execute",
                "engine.account"} <= names
        by_name = {s["name"]: s for s in spans}
        assert by_name["service.execute"]["t1_ns"] <= by_name["service.handoff"]["t0_ns"]
        assert by_name["engine.execute"]["parent"] == by_name["service.execute"]["id"]
        assert by_name["service.execute"]["parent"] is None
        assert by_name["service.handoff"]["parent"] is None
    snap = trace.snapshot()["requests"]
    assert all(snap[("ticket", f.ticket)]["sync.block"] == 1 for f in futures)


def test_a_count_outside_a_traced_request_keeps_nothing():
    trace.count("sync.x")  # off
    trace.enable()
    trace.count("sync.x")  # on, but no request open on this thread
    with trace.span("outside"):
        trace.count("sync.x")
    with trace.request("r", rid="r"):
        trace.count("sync.x", 3)
    assert trace.snapshot()["requests"] == {"r": {"sync.x": 3}}
    trace.reset()
    assert trace.snapshot() == {"spans": [], "requests": {}}
