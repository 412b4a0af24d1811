"""Cluster plane: multi-process serving substrate, launcher, failover.

The serving plane, out of one process:

    from repro_torch.cluster import launch_cluster
    from repro_torch.engine import Request

    with launch_cluster(n_workers=2) as cluster:    # workers on the card
        fut = cluster.submit(Request("spmv", SpMVInputs(a, x), None, "cuda"))
        resp = fut.result()            # served by a worker process
        # ... or drive the executor pool across processes:
        svc = EngineService(substrate="cluster", workers="auto")

Pieces: a binary-framed v2 protocol — JSON envelope + raw out-of-band
tensor segments (:mod:`.protocol`), a content-addressed blob store so
repeated large inputs ship once per worker and stay on its card
(:mod:`.blobs`), worker processes each running their own ``EngineService``
and CUDA context (:mod:`.worker`), a coordinator owning
admission/routing/heartbeats/failover plus the data-plane writer that
coalesces submits (:mod:`.coordinator`), a ``"cluster"`` substrate whose
placement slots span processes (:mod:`.substrate`), and a launcher with
pluggable process backends (:mod:`.launch`). Importing this package
registers the substrate.
"""
from .blobs import (
    BlobDigestMismatch,
    BlobError,
    BlobMissing,
    BlobStore,
    blob_digest,
)
from .coordinator import (
    ClusterError,
    ClusterFuture,
    ClusterResponse,
    Coordinator,
    RemoteOpError,
    WorkerFailure,
    WorkerStartError,
    WorkerState,
)
from .launch import (
    Cluster,
    K8sBackend,
    LaunchBackend,
    LocalProcessBackend,
    WorkerSpec,
    launch_cluster,
)
from .substrate import (
    ClusterSubstrate,
    activate_cluster,
    active_cluster,
    deactivate_cluster,
)

__all__ = [
    "BlobDigestMismatch",
    "BlobError",
    "BlobMissing",
    "BlobStore",
    "Cluster",
    "ClusterError",
    "ClusterFuture",
    "ClusterResponse",
    "ClusterSubstrate",
    "Coordinator",
    "K8sBackend",
    "LaunchBackend",
    "LocalProcessBackend",
    "RemoteOpError",
    "WorkerFailure",
    "WorkerSpec",
    "WorkerStartError",
    "WorkerState",
    "activate_cluster",
    "active_cluster",
    "blob_digest",
    "deactivate_cluster",
    "launch_cluster",
]
