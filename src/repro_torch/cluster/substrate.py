"""`ClusterSubstrate`: worker processes as placement slots.

Registered as ``"cluster"`` through the ordinary
:func:`~repro_torch.engine.substrate.register_substrate` hook, so the
serving plane — plan-cache pinning, placement variants, QoS — carries over
*unchanged* at the process level:

- :meth:`placement_slots` spans the live worker processes, so
  ``EngineService(substrate="cluster", workers="auto")`` sizes its pool to
  the cluster;
- :meth:`placement_variant` pins pool slot *k* to one worker process
  (``worker_pin``), and :meth:`cache_fingerprint` embeds both the pin and
  the coordinator's topology fingerprint — a plan made against one
  membership generation never serves another;
- :meth:`kernel` returns a **forwarder**: the kernel call (args + kwargs,
  wire-encoded) executes on the pinned worker, which runs the real kernel
  from its own registry against its own substrate and device. Capability is
  the *remote* kind's registry — the cluster supports what its workers
  support. Forwarded arguments ride the protocol-v2 data plane: raw frame
  segments for small arrays, content-addressed blobrefs for large ones, so
  a repeatedly forwarded graph crosses the wire once per worker, not once
  per call.

``placement_policy = "affinity"``: a plan's warm state (its blobs on a
card, its first call) lives in one process.

A substrate is bound to a device (``device=``, default ``"cuda"``): the
device the coordinator's inputs lie on and a forwarded kernel's result is
moved to (results cross the wire as CPU tensors). The workers have devices
of their own. ``EngineService(substrate="cluster", device=...)`` and
``get_substrate("cluster")`` build it without a coordinator, so it resolves
through the **active cluster**: the coordinator installed by
:func:`activate_cluster` (done by ``launch_cluster``). Without one, a clear
error tells you to launch first.
"""
from __future__ import annotations

import threading
from typing import Any, Callable

import torch

from ..engine.api import OpNotSupportedError
from ..engine.registry import default_registry
from ..engine.substrate import Substrate, register_substrate
from ..engine.wire import to_device
from .coordinator import ClusterError, Coordinator

# what the workers run when they name no substrate: the launcher's default
DEFAULT_WORKER_KIND = "cuda"

_ACTIVE_LOCK = threading.Lock()
_ACTIVE: "Coordinator | None" = None


def activate_cluster(coordinator: Coordinator) -> None:
    """Install ``coordinator`` as what ``get_substrate("cluster")`` binds to."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = coordinator


def deactivate_cluster(coordinator: "Coordinator | None" = None) -> None:
    """Uninstall the active cluster (no-op if ``coordinator`` is stale)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if coordinator is None or _ACTIVE is coordinator:
            _ACTIVE = None


def active_cluster() -> Coordinator:
    with _ACTIVE_LOCK:
        if _ACTIVE is None:
            raise ClusterError(
                "no active cluster — launch one first "
                "(repro_torch.cluster.launch_cluster(n_workers=...) or "
                "launch/serve.py --ops --cluster N)"
            )
        return _ACTIVE


class _RemoteKind:
    """``ClusterSubstrate.kind``: on an instance, the kind its workers'
    kernels resolve under; on the class (the capability table reads the
    classes), the workers' default."""

    def __get__(self, obj: "ClusterSubstrate | None", cls: type) -> str:
        return DEFAULT_WORKER_KIND if obj is None else obj.remote_kind()


class ClusterSubstrate(Substrate):
    """Executes kernels on the cluster's worker processes."""

    name = "cluster"
    kind = _RemoteKind()
    placement_policy = "affinity"

    def __init__(
        self,
        device: "str | torch.device" = "cuda",
        coordinator: "Coordinator | None" = None,
        worker_pin: "int | None" = None,
    ):
        super().__init__(device)
        self._coordinator = coordinator
        self.worker_pin = worker_pin

    @property
    def coordinator(self) -> Coordinator:
        return self._coordinator if self._coordinator is not None else active_cluster()

    def remote_kind(self) -> str:
        """The kernel-registry kind calls resolve under *on the worker*: the
        workers' substrate name (one substrate per cluster: the launcher
        starts every worker with the same). Without an active cluster, the
        workers' default, so the capability and placement tables stay
        readable after a mere import; only *executing* a kernel needs a live
        coordinator."""
        try:
            workers = self.coordinator.healthy_workers()
        except ClusterError:
            return DEFAULT_WORKER_KIND
        return workers[0].substrate if workers else DEFAULT_WORKER_KIND

    def supports(self, op_name: str) -> bool:
        return default_registry().has_kernel(op_name, self.remote_kind())

    def kernel(self, op_name: str) -> Callable:
        if not self.supports(op_name):
            raise OpNotSupportedError(
                f"op {op_name!r} has no kernel for the cluster's remote "
                f"kind {self.remote_kind()!r}"
            )
        pin = self.worker_pin

        def forward(*args: Any, **kwargs: Any) -> Any:
            # resolved per call, not at plan time: a plan may outlive a
            # coordinator, and an inactive cluster should fail with the
            # launch hint only when work actually needs a worker
            result = self.coordinator.kernel_call(op_name, args, kwargs, worker_pin=pin)
            return to_device(result, self.device)

        return forward

    def placement_slots(self) -> int:
        try:
            return max(1, len(self.coordinator.healthy_workers()))
        except ClusterError:
            return 1

    def placement_variant(self, slot: int, n_slots: int) -> "ClusterSubstrate":
        try:
            workers = sorted(w.worker_id for w in self.coordinator.healthy_workers())
        except ClusterError:
            return self
        if not workers:
            return self
        return ClusterSubstrate(
            self.device, self._coordinator, worker_pin=workers[slot % len(workers)]
        )

    def cache_fingerprint(self) -> tuple:
        return (
            self.name,
            str(self.device),
            self.coordinator.topology_fingerprint(),
            self.worker_pin,
        )


register_substrate(ClusterSubstrate)
