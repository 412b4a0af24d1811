"""The readers of the program's spans and counters (``repro_torch.trace``) on
tiny CPU runs, the store filled by ``trace.enable()`` in place of a profiler:
what each reads on the engine path, nothing on the serving plane, and nothing, not
an error, from a program without the store."""
import sys

import pytest

from bench import harness
from bench.tests.tiny import OPEN, run_tiny

ENGINE = ("engine.plan_ms", "engine.account_ms", "engine.syncs_per_request",
          "engine.memo_hit_share")


@pytest.fixture
def store():
    from repro_torch import trace

    trace.disable()
    trace.reset()
    trace.enable()
    yield trace
    trace.disable()
    trace.reset()


def _read(run, names):
    return {n: harness.metric_reader(n)(run) for n in names}


def _window_requests(trace, run):
    return [s["request"] for s in trace.snapshot()["spans"]
            if s["name"] == "engine.run" and s["t0_ns"] >= run.t_start * 1e9]


def test_the_spmv_cell_reads_two_syncs_and_no_memo_hit(store):
    run, numbers, correct = run_tiny("spmv-lap2d-4096.seq")
    assert correct, numbers
    got = _read(run, ENGINE)
    assert got["engine.plan_ms"] > 0 and got["engine.account_ms"] > 0
    assert got["engine.syncs_per_request"] == 2.0  # the non-zero count, the block
    assert got["engine.memo_hit_share"] == 0.0  # a fresh SpMVInputs a request
    assert len(_window_requests(store, run)) == len(run.samples)


def test_the_bfs_cell_reads_a_sync_a_round_test_and_only_memo_hits(store):
    run, numbers, correct = run_tiny("bfs-er-s21.seq")
    assert correct, numbers
    got = _read(run, ENGINE)
    rids = _window_requests(store, run)
    rounds = [sum(s["name"] == "bfs.round" and s["request"] == r for s in store.snapshot()["spans"])
              for r in rids]
    # the root's two stores, the frontier tests, the block and the reached count
    assert got["engine.syncs_per_request"] == pytest.approx(sum(n + 4 for n in rounds) / len(rids))
    assert got["engine.memo_hit_share"] == 100.0
    assert 0 < got["engine.plan_ms"] and 0 < got["engine.account_ms"]


def test_the_serving_plane_reads_no_engine_metric(store):
    run, numbers, correct = run_tiny("bfs-er-s21.seq", mix=OPEN)
    assert correct, numbers
    assert all(v is None for v in _read(run, ENGINE).values())


def test_a_program_without_the_store_reads_nothing(store, monkeypatch):
    import repro_torch

    runs = [run_tiny("spmv-lap2d-4096.seq")[0], run_tiny("spmv-lap2d-4096.seq", mix=OPEN)[0]]
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    for run in runs:
        assert all(v is None for v in _read(run, ENGINE).values())
