"""Cluster worker process: one `EngineService` behind a socket.

Spawned by the launcher as ``python -m repro_torch.cluster.worker --connect
HOST:PORT --worker-id K [--substrate cuda] [--device cuda]``, it dials back
to the coordinator, sends a ``hello``, and serves the protocol until
``shutdown`` or EOF:

- ``submit`` — rebuild the :class:`~repro_torch.engine.request.Request`
  from its wire form on this worker's device and run it through this
  process's own :class:`EngineService` worker loop. The worker therefore has
  everything the in-process serving plane has — plan cache, QoS, admission,
  a CUDA stream a pool slot — which is what makes cluster results
  *structurally* bit-identical to ``engine.run``: the same pipeline
  executes, one process over. A request that names the ``cluster``
  substrate is refused here, never sent round again.
- ``kernel_call`` — execute one substrate kernel on forwarded arguments
  (the :class:`~repro_torch.cluster.substrate.ClusterSubstrate` path),
  resolved once per value-independent signature (:class:`_KernelCache`).
- ``submit_many`` — a coordinator-coalesced frame: each item is a full
  submit (ticket + request) sharing the frame's segment table; they fan
  out to the pool exactly as if they had arrived one frame each.
- ``put_blob`` / ``blob_gone`` — content-addressed data plane: shipped
  blobs land in a byte-budgeted LRU :class:`~repro_torch.cluster.blobs.BlobStore`
  on this worker's device, each verified on its host bytes first (corrupt
  shipments are refused). The verify runs on a thread of its own, never on
  the reader: the reader marks the digest expected and reads on, and a
  request that references it waits in ``ensure`` until it is stored, so the
  bytes are stored before any frame that refers to them decodes, and a
  verify of hundreds of MB never holds back a ``pong``. A request whose
  blob this worker no longer holds blocks in ``ensure`` while a
  ``need_blob`` round trip re-fetches the bytes.
- ``ping`` — answered inline by the reader thread, *never* queued behind
  compute or a verify, so a busy worker still heartbeats and only a dead or
  truly hung process misses its deadline.

A worker that cannot start (``--device cuda`` without a card) sends a
``fatal`` frame with its error instead of ``hello`` and exits non-zero; it
never serves on another device. A kernel that fails to build or launch
answers its ticket with an ``error`` frame.

Log records from the ``repro_torch`` logger tree are forwarded to the
coordinator as ``log`` messages (one line of a worker's warning shows up in
the coordinator's log, attributed to the worker).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import logging
import os
import socket
import sys
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import torch

from ..device import resolve_device
from ..engine.api import args_signature
from ..engine.request import Request
from ..engine.service import EngineService
from ..engine.wire import (
    SegmentTable,
    canonical_bytes,
    collect_blob_digests,
    decode_value,
    encode_value,
    to_device,
)
from ..kernels.bfs.kernel import bfs_expand
from ..kernels.flash_attention.kernel import flash_attn
from ..kernels.spmv.kernel import spmv_ell
from ..kernels.spmv.stripe import spmv_ell_stripes
from ..kernels.topk_sim.kernel import topk_sim
from .blobs import BlobMissing, BlobStore
from .coordinator import ClusterError
from .protocol import Channel
from .substrate import ClusterSubstrate

log = logging.getLogger("repro_torch.cluster.worker")


class _ForwardingLogHandler(logging.Handler):
    """Ships ``repro_torch.*`` log records to the coordinator as ``log`` frames."""

    def __init__(self, channel: Channel, worker_id: int):
        super().__init__(level=logging.INFO)
        self._channel = channel
        self._worker_id = worker_id

    def emit(self, record: logging.LogRecord) -> None:
        if record.name.startswith("repro_torch.cluster"):
            return  # don't forward our own transport chatter (loop risk)
        try:
            self._channel.send({
                "kind": "log",
                "worker_id": self._worker_id,
                "level": record.levelname,
                "logger": record.name,
                "msg": self.format(record),
            })
        except Exception:
            pass  # a dying channel must not take the service down


class _KernelCache:
    """The resolved kernel for each forwarded call's signature.

    Key: (op, substrate fingerprint, value-independent argument signature,
    canonical kwargs), as the JAX package's worker keys its jitted
    executables. The port has no tracer: the cached value is the kernel
    callable itself, called with the arguments and kwargs of each call.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._fns: dict[Any, Any] = {}

    def call(self, substrate: Any, op: str, args: tuple, kwargs: dict) -> Any:
        key = (
            op,
            substrate.cache_fingerprint(),
            args_signature(args),
            canonical_bytes(kwargs),
        )
        with self._lock:
            fn = self._fns.get(key)
        if fn is None:
            fn = substrate.kernel(op)
            with self._lock:
                self._fns[key] = fn
        return fn(*args, **kwargs)


class _InputsCache:
    """The decoded inputs of recent requests, keyed by their encoded form.

    A worker decodes every request anew, and a new inputs object misses each
    memo the engine keys on the inputs' identity (the ops' traffic replays
    and placement models: seconds of host work a request at the main path's
    size). Requests whose encoded inputs are equal — the same blob digests,
    the same bytes of the small arrays, the same scalars — share one decoded
    object here, as one object serves a stream in a single process. An
    entry serves only while every blob it holds is still in the store (an
    evicted blob decodes anew); ``capacity`` entries, LRU.
    """

    def __init__(self, capacity: int = 16):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, tuple[Any, list[str]]]" = OrderedDict()

    @staticmethod
    def key(encoded: Any) -> str:
        """The identity of encoded inputs: a segment's index varies from frame
        to frame, so an ``ndref`` counts by the sha256 of its bytes."""

        def strip(node: Any) -> Any:
            if isinstance(node, dict):
                if node.get("__wire__") == "ndref":
                    return ["ndref", hashlib.sha256(node["data"]).hexdigest(), node["dtype"],
                            node["shape"]]
                return {k: strip(v) for k, v in node.items()}
            if isinstance(node, list):
                return [strip(v) for v in node]
            return node

        return json.dumps(strip(encoded), sort_keys=True, separators=(",", ":"))

    def get(self, key: str, store: BlobStore) -> Any:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            if any(d not in store for d in entry[1]):
                del self._entries[key]
                return None
            self._entries.move_to_end(key)
            return entry[0]

    def put(self, key: str, inputs: Any, digests: "list[str]") -> None:
        with self._lock:
            self._entries[key] = (inputs, digests)
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)


def kernel_launches() -> "dict[str, int]":
    """Every CUDA kernel wrapper's launch count in this process."""
    return {k.__name__: k.launches
            for k in (spmv_ell, spmv_ell_stripes, bfs_expand, topk_sim, flash_attn)}


def serve(
    connect: "tuple[str, int]",
    worker_id: int,
    *,
    substrate: str = "cuda",
    device: str = "cuda",
    service_workers: int = 2,
    token: "str | None" = None,
) -> None:
    """Dial the coordinator and serve until ``shutdown`` or EOF. Raises
    (after telling the coordinator, in a ``fatal`` frame) when the device
    or the service cannot be set up."""
    token = token if token is not None else os.environ.get("REPRO_CLUSTER_TOKEN", "")
    sock = socket.create_connection(connect, timeout=30)
    sock.settimeout(None)
    channel = Channel(sock)
    try:
        dev = resolve_device(device)
        service = EngineService(substrate=substrate, device=dev, workers=service_workers)
        service.start()
    except Exception as exc:
        channel.send({"kind": "fatal", "worker_id": worker_id, "token": token,
                      "etype": type(exc).__name__, "error": str(exc)})
        channel.close()
        raise
    handler = _ForwardingLogHandler(channel, worker_id)
    logging.getLogger("repro_torch").addHandler(handler)
    sub = service.default_substrate
    kernels = _KernelCache()
    blob_store = BlobStore(device=dev)
    inputs_cache = _InputsCache()
    pool = ThreadPoolExecutor(
        max_workers=max(2, service_workers), thread_name_prefix=f"w{worker_id}"
    )
    verifier = ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"w{worker_id}-blobs")
    channel.send({
        "kind": "hello",
        "worker_id": worker_id,
        "pid": os.getpid(),
        "token": token,
        "substrate": substrate,
        "slots": sub.placement_slots(),
    })

    def request_blobs(missing: "list[str]") -> None:
        channel.send({"kind": "need_blob", "digests": missing})

    def decode_with_blobs(decode):
        """Run ``decode()`` with every referenced blob present, re-fetching
        via ``need_blob`` when the LRU evicted one between arrival and
        decode (bounded — a blob the coordinator cannot produce raises)."""
        for _attempt in range(3):
            try:
                return decode()
            except BlobMissing as exc:
                blob_store.ensure([exc.digest], request_blobs)
        return decode()

    def finish_submit(ticket: int, payload: dict) -> None:
        try:
            if payload.get("substrate") == ClusterSubstrate.name:
                raise ClusterError(
                    "a request naming the cluster substrate cannot be served inside "
                    "a cluster worker; name the workers' substrate instead"
                )
            key = inputs_cache.key(payload["inputs"])
            inputs = inputs_cache.get(key, blob_store)
            if inputs is None:
                digests = collect_blob_digests(payload)
                if digests:
                    blob_store.ensure(digests, request_blobs)
                request = decode_with_blobs(
                    lambda: Request.from_wire(payload, blob_resolver=blob_store.resolve, device=dev)
                )
                inputs_cache.put(key, request.inputs, digests)
            else:
                request = dataclasses.replace(
                    Request.from_wire({**payload, "inputs": None}, device=dev), inputs=inputs)
            response = service.submit(request).result()
            table = SegmentTable()
            channel.send({
                "kind": "result",
                "ticket": ticket,
                "result": encode_value(response.result, segments=table),
                "report": encode_value(response.report, segments=table),
            }, table.segments)
        except Exception as exc:  # noqa: BLE001 — every ticket must answer
            _send_error(ticket, exc)

    def finish_kernel(ticket: int, message: dict) -> None:
        try:
            digests = collect_blob_digests([message["args"], message["kwargs"]])
            if digests:
                blob_store.ensure(digests, request_blobs)
            args, kwargs = decode_with_blobs(
                lambda: (
                    decode_value(message["args"], blob_resolver=blob_store.resolve),
                    decode_value(message["kwargs"], blob_resolver=blob_store.resolve),
                )
            )
            result = kernels.call(
                sub, message["op"], to_device(tuple(args), dev), to_device(kwargs, dev)
            )
            table = SegmentTable()
            channel.send({
                "kind": "result",
                "ticket": ticket,
                "result": encode_value(result, segments=table),
                "report": None,
            }, table.segments)
        except Exception as exc:  # noqa: BLE001
            _send_error(ticket, exc)

    def store_blob(digest: str, blob: Any) -> None:
        try:
            blob_store.put(digest, decode_value(blob))
        except Exception:
            blob_store.expect_failed(digest)
            log.exception("worker %d: refused blob %s", worker_id, digest)

    def _send_error(ticket: int, exc: BaseException) -> None:
        try:
            channel.send({
                "kind": "error",
                "ticket": ticket,
                "etype": type(exc).__name__,
                "error": str(exc),
            })
        except Exception:
            pass

    try:
        while True:
            message = channel.recv()
            if message is None:
                break  # coordinator gone
            kind = message["kind"]
            if kind == "ping":
                channel.send({"kind": "pong", "inflight": len(service)})
            elif kind == "submit":
                pool.submit(finish_submit, message["ticket"], message["request"])
            elif kind == "submit_many":
                for item in message["items"]:
                    pool.submit(finish_submit, item["ticket"], item["request"])
            elif kind == "put_blob":
                # marked before the next frame is read, so a submit that
                # refers to the blob waits for it instead of asking again
                blob_store.expect(message["digest"])
                verifier.submit(store_blob, message["digest"], message["blob"])
            elif kind == "blob_gone":
                blob_store.mark_gone(message["digest"])
            elif kind == "kernel_call":
                pool.submit(finish_kernel, message["ticket"], message)
            elif kind == "stats":
                stats = service.stats()
                stats.wire_bytes_sent = channel.bytes_sent
                stats.wire_bytes_received = channel.bytes_received
                store_stats = blob_store.stats()
                stats.blob_hits = store_stats["hits"]
                stats.blob_misses = store_stats["misses"]
                row = stats.to_dict()
                row["blob_store"] = store_stats
                row["kernel_launches"] = kernel_launches()
                row["pid"] = os.getpid()
                if dev.type == "cuda":
                    row["device_memory"] = {
                        "allocated": torch.cuda.memory_allocated(dev),
                        "reserved": torch.cuda.memory_reserved(dev),
                        "max_allocated": torch.cuda.max_memory_allocated(dev),
                    }
                channel.send({
                    "kind": "stats_reply",
                    "ticket": message["ticket"],
                    "stats": row,
                })
            elif kind == "shutdown":
                break
            else:
                log.warning("worker %d: unknown message kind %r", worker_id, kind)
    finally:
        pool.shutdown(wait=False)
        verifier.shutdown(wait=False)
        try:
            service.stop(drain=False)
        except Exception:
            pass
        logging.getLogger("repro_torch").removeHandler(handler)
        channel.close()


def main(argv: "list[str] | None" = None) -> None:
    parser = argparse.ArgumentParser(description="repro_torch cluster worker process")
    parser.add_argument("--connect", required=True, help="coordinator HOST:PORT")
    parser.add_argument("--worker-id", type=int, required=True)
    parser.add_argument("--substrate", default="cuda")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--service-workers", type=int, default=2)
    args = parser.parse_args(argv)
    host, _, port = args.connect.rpartition(":")
    try:
        serve(
            (host, int(port)),
            args.worker_id,
            substrate=args.substrate,
            device=args.device,
            service_workers=args.service_workers,
        )
    except Exception as exc:  # the coordinator has the message; exit non-zero
        print(f"cluster worker {args.worker_id}: {type(exc).__name__}: {exc}", file=sys.stderr)
        raise SystemExit(1) from exc


if __name__ == "__main__":
    main()
