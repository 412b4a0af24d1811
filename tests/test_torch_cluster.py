"""The port's cluster plane (``repro_torch.cluster``): multi-process serving,
the ``cluster`` substrate, failover, the launcher.

Counterparts of the reference's ``tests/test_cluster.py`` (the same names
where the behaviour is the same), with worker subprocesses on the CPU
(``device="cpu"``: the ``cuda`` substrate there runs each kernel's plain
version):

- a 2-worker cluster serves the six main-path signatures (SpMV S1 on and
  off, BFS remote_write and migrate, GSANA HCB and BLK, PAIR) and a
  ``moe_dispatch`` request (on ``local``: ``cuda`` has no kernel for it)
  **bit-identically** to in-process ``engine.run``, distributed across both
  processes, and each of the six is held against the JAX package's
  ``engine.run`` on the same numpy-built inputs;
- ``EngineService(substrate="cluster")`` drives the executor pool over
  process-spanning placement slots, same parity;
- SIGKILLing one worker mid-load terminates every future with bit-identical
  results, visible in the stats and the topology fingerprint;
- a worker that cannot have its device fails the launch with its message.

Named counterparts elsewhere: the supervisor's restart budget
(``test_process_supervisor_restart_budget``) is
``tests/test_torch_train_runtime.py::test_process_supervisor_matches_reference``;
the resize signal's thresholds (``test_resize_signal_grow_on_saturated_pool``,
``..._shrink_on_idle_pool``, ``..._hold_between_thresholds_and_on_empty``)
are ``tests/test_torch_service_pool.py::test_resize_signal_thresholds_match_reference``;
its custom thresholds and ``to_dict`` row are held here.

Importing ``repro_torch.cluster`` registers the ``cluster`` substrate
process-wide; other files' tests read the registry's contents, so this
file holds the registration only while its own tests run.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.engine as J
import repro_torch.cluster as C
import repro_torch.core as T
import repro_torch.sparse as TS
from repro_torch.engine import (
    CudaSubstrate, EngineService, LocalSubstrate, MoEDispatchInputs, PlanCache, Request,
    ServiceStats, SpMVInputs, get_substrate, run,
)
from repro_torch.engine import substrate as substrates
from torch_serving_inputs import (
    CPU, assert_equal_results, assert_matches_reference, bfs_pair, signatures,
)

ROOT = Path(__file__).resolve().parents[1]
WAIT = 120  # seconds any one wait may take before it fails its test

substrates._REGISTRY.pop(C.ClusterSubstrate.name, None)


@pytest.fixture(scope="module", autouse=True)
def cluster_substrate_registered():
    # the worker processes inherit the environment: one intra-op thread each
    # instead of one a core, so they do not starve other files' tests that
    # run beside them under pytest-xdist
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        substrates.register_substrate(C.ClusterSubstrate)
        yield
        substrates._REGISTRY.pop(C.ClusterSubstrate.name, None)


def _moe_inputs(seed: int = 0) -> MoEDispatchInputs:
    rng = np.random.default_rng(seed)
    return MoEDispatchInputs(
        x=torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)),
        router=torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)),
        nodelets=2,
    )


def _mixed_requests(n: int) -> list:
    """The six main-path signatures in turn on the ``cuda`` substrate, every
    fourth request a ``moe_dispatch`` on ``local``."""
    sigs = signatures("port")
    moe = _moe_inputs()
    requests = []
    for i in range(n):
        if i % 4 == 3:
            requests.append(Request("moe_dispatch", moe, None, LocalSubstrate(CPU)))
        else:
            requests.append(Request(*sigs[i % len(sigs)], CudaSubstrate(CPU)))
    return requests


def _oracle(request):
    return run(request, iters=1, warmup=0, cache=PlanCache())[0]


# -- live 2-worker cluster (module-scoped: one launch pays for all) -----------


@pytest.fixture(scope="module")
def cluster():
    with C.launch_cluster(n_workers=2, service_workers=1, device=CPU, wait_timeout=WAIT) as c:
        yield c


def test_submit_parity_and_distribution(cluster):
    requests = _mixed_requests(12)
    futures = [cluster.submit(r) for r in requests]
    responses = [f.result(timeout=WAIT) for f in futures]
    for request, response in zip(requests, responses):
        assert_equal_results(response.result, _oracle(request))
        assert response.report is not None and response.report.op == request.op
    stats = cluster.stats()
    served = {w["worker_id"]: w["served"] for w in stats["workers"]}
    assert sum(served.values()) >= len(requests)
    assert sum(1 for n in served.values() if n > 0) == 2, served
    assert stats["n_healthy"] == 2
    assert stats["retries"] == 0 and stats["failovers"] == 0


@pytest.mark.parametrize("i", range(6), ids=["spmv-s1", "spmv-striped", "bfs-remote_write",
                                             "bfs-migrate", "gsana-hcb", "gsana-blk"])
def test_slice_matches_the_reference(cluster, i):
    """The slice as a whole: each main-path signature served by a worker
    process, against the JAX package's ``engine.run`` on its ``local``
    substrate (SpMV within 1e-5, BFS parents equal, GSANA scores within
    1e-6 and candidates equal where not tied), and bit for bit against the
    port's own ``engine.run``."""
    op, inputs, st = signatures("port")[i]
    request = Request(op, inputs, st, CudaSubstrate(CPU))
    got = cluster.submit(request).result(timeout=WAIT).result
    want, _ = J.run(J.Request(*signatures("ref")[i]), iters=1, warmup=0)
    assert_matches_reference(op, got, want)
    assert_equal_results(got, _oracle(request))


def test_sticky_placement_pins_same_signature_to_one_worker(cluster):
    requests = [r for r in _mixed_requests(24) if r.op == "spmv"][:4]
    responses = [cluster.submit(r).result(timeout=WAIT) for r in requests]
    by_signature = {}
    for request, response in zip(requests, responses):
        key = request.strategy.replicate_x  # two signatures alternate
        by_signature.setdefault(key, set()).add(response.worker_id)
    assert len(by_signature) == 2
    for workers in by_signature.values():
        assert len(workers) == 1  # a signature never bounces between workers


def test_remote_errors_propagate_and_are_not_retried(cluster):
    bad = Request("spmv", bfs_pair()[1], None, CudaSubstrate(CPU))  # BFS inputs to spmv
    before = cluster.stats()["retries"]
    with pytest.raises(C.RemoteOpError):
        cluster.submit(bad).result(timeout=WAIT)
    assert cluster.stats()["retries"] == before  # deterministic: no retry
    assert cluster.stats()["n_healthy"] == 2  # and no worker was condemned


def test_request_naming_the_cluster_substrate_is_refused_in_the_worker(cluster):
    """A worker never sends a request round again: one that names the
    ``cluster`` substrate fails there, as a remote error."""
    op, inputs, st = signatures("port")[0]
    before = cluster.stats()["retries"]
    with pytest.raises(C.RemoteOpError, match="cluster substrate"):
        cluster.submit(Request(op, inputs, st, "cluster")).result(timeout=WAIT)
    assert cluster.stats()["retries"] == before and cluster.stats()["n_healthy"] == 2


def test_cluster_substrate_spans_processes(cluster):
    sub = C.ClusterSubstrate(CPU)
    assert sub.placement_slots() == 2 and sub.placement_policy == "affinity"
    fp = sub.cache_fingerprint()
    assert fp[0] == "cluster" and fp[1] == "cpu"
    generation, members = fp[2]
    assert len(members) == 2  # topology is part of every plan-cache key
    assert sub.kind == "cuda" and C.ClusterSubstrate.kind == "cuda"  # the workers' kind
    assert sub.supports("spmv") and not sub.supports("moe_dispatch")
    pinned = sub.placement_variant(1, 2)
    assert pinned.worker_pin in {w.worker_id for w in cluster.coordinator.healthy_workers()}
    assert pinned.cache_fingerprint() != sub.cache_fingerprint()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_substrate("cluster")  # a substrate named by string is built on the card


def test_engine_service_pool_over_cluster_substrate(cluster):
    requests = [r for r in _mixed_requests(8) if r.op != "moe_dispatch"]
    svc = EngineService(substrate="cluster", device=CPU, workers=2).start()
    try:
        futures = [svc.submit(Request(r.op, r.inputs, r.strategy, "cluster")) for r in requests]
        responses = [f.result(timeout=WAIT) for f in futures]
    finally:
        svc.stop(timeout=WAIT)
    assert len(responses) == len(requests)
    for request, response in zip(requests, responses):
        assert response.report.substrate == "cluster"
        assert_equal_results(response.result, _oracle(request))
    assert cluster.stats()["kernel_calls"] > 0  # genuinely crossed processes
    stats = svc.stats()
    assert stats.workers == 2
    assert stats.resize_signal() in ("grow", "hold", "shrink")


def test_tensor_written_in_place_ships_its_new_bytes(cluster):
    """An input written in place between two submits is served with its new
    values: its digest moved with the tensor's ``_version``, so the new
    bytes shipped."""
    a = T.partition_ell(TS.laplacian_2d(128, device=CPU), 8, device=CPU)
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(128 * 128).astype(np.float32))
    request = Request("spmv", SpMVInputs(a, x), None, CudaSubstrate(CPU))  # x: 64 KiB, a blob
    first = cluster.submit(request).result(timeout=WAIT).result
    assert torch.equal(first, _oracle(request))
    x.add_(1)
    second = cluster.submit(request).result(timeout=WAIT).result
    assert torch.equal(second, _oracle(request)) and not torch.equal(second, first)


# -- failover and start-up (own clusters) -------------------------------------


def test_sigkill_failover_terminates_every_future_with_parity():
    with C.launch_cluster(
        n_workers=2, service_workers=1, device=CPU, activate=False,
        heartbeat_interval=0.2, heartbeat_timeout=3.0, wait_timeout=WAIT,
    ) as cluster:
        fp_before = cluster.coordinator.topology_fingerprint()
        requests = _mixed_requests(12)
        futures = [cluster.submit(r) for r in requests]
        victim = cluster.coordinator.healthy_workers()[0].worker_id
        cluster.kill_worker(victim, sig=signal.SIGKILL)
        responses = [f.result(timeout=WAIT) for f in futures]  # all terminate
        for request, response in zip(requests, responses):
            assert_equal_results(response.result, _oracle(request))
        stats = cluster.stats()
        assert stats["failovers"] == 1
        assert stats["n_healthy"] == 1
        dead = [w for w in stats["workers"] if w["worker_id"] == victim]
        assert dead and dead[0]["state"] == "dead"
        # survivors absorbed the victim's load; membership re-fingerprints
        # so no plan-cache entry aliases across the two topologies
        assert cluster.coordinator.topology_fingerprint() != fp_before
        survivor_served = sum(w["served"] for w in stats["workers"] if w["worker_id"] != victim)
        assert survivor_served > 0


def test_worker_without_its_device_fails_the_launch_with_its_message():
    """No fallback: a worker asked for the card on a machine without one
    fails at start-up, and the launch raises with the worker's message."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the workers' default device is available")
    with pytest.raises(C.WorkerStartError, match="no CUDA device"):
        C.launch_cluster(n_workers=1, device="cuda", activate=False, wait_timeout=WAIT)


def test_serve_cli_cluster_demo_with_failover():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--ops", "--cluster", "2",
         "--cluster-kill-one", "--ops-requests", "12", "--device", "cpu"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, capture_output=True, text=True,
        timeout=WAIT,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["requests"] == 12 and report["mismatches"] == 0
    assert report["cluster"]["failovers"] == 1


# -- launcher backends (no processes needed) ----------------------------------


def test_k8s_backend_emits_pod_spec_but_does_not_schedule():
    spec = C.WorkerSpec(worker_id=3, connect=("10.0.0.7", 4242), token="tok")
    backend = C.K8sBackend(image="repro-serving:v1", namespace="serving")
    pod = backend.pod_spec(spec)
    assert pod["kind"] == "Pod"
    assert pod["metadata"]["name"] == "repro-worker-3"
    assert pod["metadata"]["namespace"] == "serving"
    container = pod["spec"]["containers"][0]
    assert container["image"] == "repro-serving:v1"
    assert container["command"] == spec.argv()
    assert "--connect" in container["command"]
    assert "10.0.0.7:4242" in container["command"]
    assert {"name": "REPRO_CLUSTER_TOKEN", "value": "tok"} in container["env"]
    json.dumps(pod)  # manifest must be plain-JSON appliable
    with pytest.raises(NotImplementedError):
        backend.start(spec)


def test_worker_spec_argv_is_reproducible_entrypoint():
    argv = C.WorkerSpec(worker_id=0, connect=("127.0.0.1", 9000)).argv()
    assert argv[1:3] == ["-m", "repro_torch.cluster.worker"]
    assert "--worker-id" in argv and "0" in argv
    assert argv[argv.index("--substrate") + 1] == "cuda" and argv[argv.index("--device") + 1] == "cuda"


# -- resize signal (autoscaler trigger; pure threshold logic) -----------------


def _stats(pkg, occupancy, wall=10.0):
    return pkg(requests=8, wall_seconds=wall, workers=len(occupancy),
               worker_occupancy=list(occupancy), occupancy_hwm=max(occupancy, default=0.0))


def test_resize_signal_custom_thresholds_and_to_dict():
    for pkg in (ServiceStats, J.ServiceStats):
        stats = _stats(pkg, [0.6, 0.6])
        assert stats.resize_signal(grow_above=0.5) == "grow"
        assert _stats(pkg, [0.3, 0.3]).resize_signal(shrink_below=0.35) == "shrink"
        row = stats.to_dict()
        assert row["resize_signal"] == "hold"
        assert row["occupancy_hwm"] == 0.6
        assert row["worker_occupancy"] == [0.6, 0.6]
