"""Cluster launcher: stand the worker pool up as processes.

``launch_cluster(n_workers)`` is the one-call path the CLI
(``launch/serve.py --ops --cluster N``), ``chip_smoke.py`` and the tests
share: start a coordinator, spawn N localhost worker subprocesses through
a :class:`LaunchBackend`, wait for them to join, install the coordinator
as the active cluster (so ``substrate="cluster"`` resolves), and hand
back a :class:`Cluster` that cleans all of it up.

Backends are pluggable behind three methods (``start/alive/stop``):

- :class:`LocalProcessBackend` — ``subprocess.Popen`` on this host, with
  ``PYTHONPATH`` pointed at this checkout's ``src`` and the cluster auth
  token in the environment. What the tests and ``chip_smoke.py`` use.
- :class:`K8sBackend` — the deployment seam: :meth:`K8sBackend.pod_spec`
  emits the pod manifest a real scheduler would apply (same worker argv,
  token via env, coordinator address as the dial target); ``start``
  raises ``NotImplementedError`` until one is wired in. It exists so the
  worker contract (dial back, hello, heartbeat) is demonstrably
  scheduler-shaped, not subprocess-shaped.

Process exits are watched by the training plane's
:class:`~repro_torch.runtime.supervisor.ProcessSupervisor` — ``restarts > 0``
respawns a crashed worker, which re-dials the coordinator and rejoins the
pool (membership generation bumps; plans re-fingerprint). The default is
0: request-level failover already guarantees liveness, so restarts are an
availability knob, not a correctness one.

On the card, N workers that each built the CUDA kernels at their first
request would run N ``nvcc`` builds while their heartbeats wait:
``launch_cluster`` builds them once, before it spawns a worker, and the
workers only load the libraries. Each worker holds its own CUDA context and
its own copy of the blobs it serves; without MPS the contexts time-slice
the card, so kernels of different workers do not overlap.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import threading
import time
from typing import Any

import torch

from ..kernels import build
from ..runtime.supervisor import ProcessSupervisor
from .coordinator import ClusterError, Coordinator, WorkerStartError
from .substrate import activate_cluster, deactivate_cluster


@dataclasses.dataclass
class WorkerSpec:
    """Everything a backend needs to start one worker."""

    worker_id: int
    connect: "tuple[str, int]"  # coordinator (host, port) to dial
    substrate: str = "cuda"
    device: str = "cuda"
    service_workers: int = 2
    token: str = ""

    def argv(self) -> "list[str]":
        return [
            sys.executable, "-m", "repro_torch.cluster.worker",
            "--connect", f"{self.connect[0]}:{self.connect[1]}",
            "--worker-id", str(self.worker_id),
            "--substrate", self.substrate,
            "--device", self.device,
            "--service-workers", str(self.service_workers),
        ]


class LaunchBackend:
    """Where worker processes run. Implementations provide start/alive/stop."""

    def start(self, spec: WorkerSpec) -> Any:
        raise NotImplementedError

    def alive(self, handle: Any) -> bool:
        raise NotImplementedError

    def stop(self, handle: Any) -> None:
        raise NotImplementedError


class LocalProcessBackend(LaunchBackend):
    """Workers as localhost subprocesses of this interpreter."""

    def start(self, spec: WorkerSpec) -> subprocess.Popen:
        import repro_torch

        src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
        env = dict(os.environ)
        existing = env.get("PYTHONPATH")
        env["PYTHONPATH"] = src + (os.pathsep + existing if existing else "")
        env["REPRO_CLUSTER_TOKEN"] = spec.token
        return subprocess.Popen(spec.argv(), env=env)

    def alive(self, handle: subprocess.Popen) -> bool:
        return handle.poll() is None

    def stop(self, handle: subprocess.Popen) -> None:
        if handle.poll() is None:
            handle.terminate()
            try:
                handle.wait(timeout=10)
            except subprocess.TimeoutExpired:
                handle.kill()
                handle.wait(timeout=10)


class K8sBackend(LaunchBackend):
    """Pod-spec emitter stub: the shape a real scheduler slots into."""

    def __init__(self, image: str = "repro-torch-serving:latest", namespace: str = "repro"):
        self.image = image
        self.namespace = namespace

    def pod_spec(self, spec: WorkerSpec) -> "dict[str, Any]":
        """The manifest ``kubectl apply`` would take for this worker."""
        return {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": f"repro-worker-{spec.worker_id}",
                "namespace": self.namespace,
                "labels": {"app": "repro-cluster", "role": "worker"},
            },
            "spec": {
                "restartPolicy": "OnFailure",
                "containers": [{
                    "name": "worker",
                    "image": self.image,
                    "command": spec.argv(),
                    "env": [
                        {"name": "REPRO_CLUSTER_TOKEN", "value": spec.token},
                    ],
                }],
            },
        }

    def start(self, spec: WorkerSpec) -> Any:
        raise NotImplementedError(
            "K8sBackend emits pod specs (pod_spec()) but does not schedule; "
            "wire it to a cluster API or use LocalProcessBackend"
        )

    def alive(self, handle: Any) -> bool:  # pragma: no cover - stub
        raise NotImplementedError

    def stop(self, handle: Any) -> None:  # pragma: no cover - stub
        raise NotImplementedError


class Cluster:
    """A running cluster: coordinator + supervised worker processes."""

    def __init__(
        self,
        coordinator: Coordinator,
        backend: LaunchBackend,
        specs: "list[WorkerSpec]",
        supervisor: ProcessSupervisor,
        poll_interval: float = 0.5,
    ):
        self.coordinator = coordinator
        self.backend = backend
        self.specs = {spec.worker_id: spec for spec in specs}
        self.supervisor = supervisor
        self._stopping = False
        self._poller = threading.Thread(
            target=self._poll_loop, args=(poll_interval,),
            name="cluster-supervise", daemon=True,
        )
        self._poller.start()

    def _poll_loop(self, interval: float) -> None:
        while not self._stopping:
            time.sleep(interval)
            self.supervisor.poll()

    def worker_pid(self, worker_id: int) -> "int | None":
        handle = self.supervisor.handles().get(f"worker-{worker_id}")
        return getattr(handle, "pid", None)

    def kill_worker(self, worker_id: int, sig: "int | None" = None) -> None:
        """Hard-kill one worker process (failover tests / demos).
        ``sig=None`` uses SIGKILL."""
        import signal

        pid = self.worker_pid(worker_id)
        if pid is None:
            raise ClusterError(f"no process handle for worker {worker_id}")
        os.kill(pid, signal.SIGKILL if sig is None else sig)

    def submit(self, request: Any):
        return self.coordinator.submit(request)

    def stats(self) -> "dict[str, Any]":
        return self.coordinator.stats()

    def shutdown(self) -> None:
        if self._stopping:
            return
        self._stopping = True
        deactivate_cluster(self.coordinator)
        self.coordinator.shutdown()
        for handle in self.supervisor.handles().values():
            try:
                self.backend.stop(handle)
            except Exception:
                pass

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.shutdown()


def _wait_joined(coordinator: Coordinator, n_workers: int, handles: list,
                 backend: LaunchBackend, timeout: float) -> None:
    """``coordinator.wait_ready`` in steps of a second, raising early when a
    worker reports that it could not start (:class:`WorkerStartError`, its
    message) or its process exits before it joined."""
    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        try:
            coordinator.wait_ready(n_workers, timeout=min(1.0, max(0.0, remaining)))
            return
        except WorkerStartError:
            raise
        except ClusterError:
            if remaining <= 1.0:
                raise
            exited = [getattr(h, "returncode", None) for h in handles if not backend.alive(h)]
            if not exited:
                continue
            # a worker that could not start says why in a frame sent just
            # before it exits: give that frame a moment to be read
            try:
                coordinator.wait_ready(n_workers, timeout=2.0)
                return
            except WorkerStartError:
                raise
            except ClusterError:
                raise ClusterError(
                    f"{len(exited)} worker process(es) exited before joining "
                    f"(exit codes {exited})"
                ) from None


def launch_cluster(
    n_workers: int = 2,
    *,
    substrate: str = "cuda",
    device: str = "cuda",
    service_workers: int = 2,
    backend: "LaunchBackend | None" = None,
    heartbeat_interval: float = 0.5,
    heartbeat_timeout: float = 5.0,
    max_inflight: int = 512,
    restarts: int = 0,
    wait_timeout: float = 180.0,
    activate: bool = True,
    flush_window: float = 0.002,
    blob_min_bytes: "int | None" = None,
) -> Cluster:
    """Stand up a localhost cluster and return its :class:`Cluster` handle.

    The workers run ``substrate`` kernels on ``device`` (the card by
    default; a worker that finds no card fails at start-up and this raises
    :class:`WorkerStartError` with its message). ``activate=True`` (default)
    installs the coordinator as the process's active cluster so
    ``substrate="cluster"`` resolves everywhere.
    ``flush_window`` is the submit-coalescing window; ``blob_min_bytes``
    the content-addressing threshold (None = ``REPRO_BLOB_MIN_BYTES`` or
    its 64 KiB default). Workers read ``REPRO_BLOB_BUDGET_BYTES`` from
    their (inherited) environment for the blob-store byte budget.
    """
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        build.build()  # once here, so no worker runs nvcc while its heartbeat waits
    coordinator = Coordinator(
        heartbeat_interval=heartbeat_interval,
        heartbeat_timeout=heartbeat_timeout,
        max_inflight=max_inflight,
        flush_window=flush_window,
        blob_min_bytes=blob_min_bytes,
    )
    host, port = coordinator.listen()
    backend = backend if backend is not None else LocalProcessBackend()
    supervisor = ProcessSupervisor(max_restarts=restarts)
    specs = [
        WorkerSpec(
            worker_id=k,
            connect=(host, port),
            substrate=substrate,
            device=device,
            service_workers=service_workers,
            token=coordinator.token,
        )
        for k in range(n_workers)
    ]
    started: list = []
    try:
        for spec in specs:
            handle = backend.start(spec)
            started.append(handle)
            supervisor.watch(
                f"worker-{spec.worker_id}",
                handle,
                alive=backend.alive,
                restart=(lambda s=spec: backend.start(s)) if restarts else None,
            )
        _wait_joined(coordinator, n_workers, started, backend, wait_timeout)
    except Exception:
        coordinator.shutdown()
        for handle in started:
            try:
                backend.stop(handle)
            except Exception:
                pass
        raise
    if activate:
        activate_cluster(coordinator)
    return Cluster(coordinator, backend, specs, supervisor)
