"""Cluster coordinator: admission, routing, health, and failover.

The coordinator owns the client-facing end of the control plane. It
listens on a localhost socket; workers dial in and say ``hello``; from
then on each worker is a :class:`WorkerHandle` with a reader thread, a
health state, and an in-flight table. Two submission paths share the
machinery:

- :meth:`Coordinator.submit` — a whole :class:`Request` crosses the wire
  and the worker's own ``EngineService`` serves it (the serving path;
  warm plan-cache executables live *in the worker*). Requests are routed
  by **placement key** (op name x input signature x strategy identity):
  the first request of a key pins it to the least-loaded live worker, and
  every later request with the same key — i.e. the same compiled
  executable — goes to the same process. That is the Emu discipline one
  level up: migrate the *request* to the process that owns the data
  (here: the warm plan and the blobs on its card), never migrate the data.
- :meth:`Coordinator.kernel_call` — one substrate kernel invocation
  (the :class:`~repro_torch.cluster.substrate.ClusterSubstrate` path), pinned
  to a worker by the substrate's placement variant.

**Health**: a monitor thread pings every worker each
``heartbeat_interval``; a worker whose last ``pong`` is older than
``heartbeat_timeout`` — or whose connection EOFs, the fast path for a
SIGKILLed process — is declared dead.

**Failover**: when a worker dies, its placement pins are dropped (keys
re-place on survivors on next submit — "slots redistributed") and every
in-flight request it held is retried **once** on a surviving worker. Safe
because ops are pure: re-running a request cannot double-apply anything.
A request whose retry also dies fails its future with
:class:`WorkerFailure` — every submitted future terminates, always.
Remote *computation* errors are not retried (they are deterministic); they
re-raise as :class:`RemoteOpError`.

**Data plane (protocol v2)**: every outgoing submit/kernel_call encodes
its arrays out-of-band — raw frame segments for small ones, and
content-addressed blobrefs for arrays at/above ``blob_min_bytes``.
Blob bytes ship to a given worker **once** (``put_blob``), tracked in the
per-worker ``blob_digests`` belief set; re-submits of the same tensor send
only its digest. Workers that evicted a blob ask for it back with
``need_blob``; failover re-ships an in-flight request's pinned blobs to
the survivor before replaying the request, so retries stay bit-identical.
Submits to the same worker are coalesced by a per-worker writer thread
into one ``submit_many`` frame under ``flush_window`` — continuous-batch
decode traffic pays one syscall + frame per flush, not per request.

Results decode as CPU tensors (``ClusterResponse.result``); the caller
moves them where it needs them (the ``cluster`` substrate moves a
forwarded kernel's result to its own device).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import logging
import queue
import secrets
import socket
import threading
import time
import weakref
from typing import Any

import numpy as np
import torch

from ..engine.api import args_signature
from ..engine.request import Request
from ..engine.wire import SegmentTable, array_nbytes, decode_value, encode_value
from .blobs import BlobStore, blob_digest, blob_min_bytes_default
from .protocol import Channel, ProtocolError

log = logging.getLogger("repro_torch.cluster")


class ClusterError(RuntimeError):
    """The cluster cannot serve (no live workers / not listening / stopped)."""


class WorkerStartError(ClusterError):
    """A worker reported that it could not start (its device, its service)."""


class WorkerFailure(ClusterError):
    """The worker executing a request died, and so did its one retry."""


class RemoteOpError(RuntimeError):
    """The request itself raised on the worker (not a transport failure)."""

    def __init__(self, etype: str, message: str, worker_id: int):
        super().__init__(f"[worker {worker_id}] {etype}: {message}")
        self.etype = etype
        self.worker_id = worker_id


class WorkerState(str, enum.Enum):
    STARTING = "starting"
    HEALTHY = "healthy"
    DEAD = "dead"


@dataclasses.dataclass
class ClusterResponse:
    """What a resolved cluster future yields."""

    ticket: int
    result: Any
    report: Any  # RunReport for submit(); None for kernel calls
    worker_id: int
    retried: bool = False


class ClusterFuture:
    """Terminates exactly once: a response, a remote error, or failover
    exhaustion. Same blocking surface as ``ServiceFuture``.
    ``submitted_at``/``done_at`` (``time.perf_counter``) bound its total
    latency, a failover's retry included."""

    def __init__(self, ticket: int):
        self.ticket = ticket
        self.submitted_at = time.perf_counter()
        self.done_at: "float | None" = None
        self._done = threading.Event()
        self._response: "ClusterResponse | None" = None
        self._exception: "BaseException | None" = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: "float | None" = None) -> ClusterResponse:
        if not self._done.wait(timeout):
            raise TimeoutError(f"cluster request {self.ticket} still pending")
        if self._exception is not None:
            raise self._exception
        assert self._response is not None
        return self._response

    def exception(self, timeout: "float | None" = None) -> "BaseException | None":
        if not self._done.wait(timeout):
            raise TimeoutError(f"cluster request {self.ticket} still pending")
        return self._exception

    def _resolve(self, response: ClusterResponse) -> None:
        self._response = response
        self.done_at = time.perf_counter()
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self._exception = exc
        self.done_at = time.perf_counter()
        self._done.set()


@dataclasses.dataclass
class _Inflight:
    ticket: int
    future: ClusterFuture
    #: resend template (everything but the ticket) — what failover replays
    message: "dict[str, Any]"
    decode_report: bool
    retried: bool = False
    #: the message's out-of-band payload buffers (ndref targets), replayed
    #: verbatim on failover so the retry is bit-identical
    segments: "list[Any]" = dataclasses.field(default_factory=list)
    #: digest -> array pins for every blobref the message references —
    #: strong refs, so failover can re-ship even past store eviction
    blobs: "dict[str, Any]" = dataclasses.field(default_factory=dict)


def _offset_ndrefs(node: Any, offset: int) -> Any:
    """A structural copy of an encoded message with every ndref's segment
    index shifted by ``offset`` — how per-submit segment tables concatenate
    into one ``submit_many`` frame. A copy, never in-place: the original is
    an in-flight entry's resend template."""
    if isinstance(node, dict):
        out = {k: _offset_ndrefs(v, offset) for k, v in node.items()}
        if out.get("__wire__") == "ndref" and isinstance(out.get("seg"), int):
            out["seg"] += offset
        return out
    if isinstance(node, list):
        return [_offset_ndrefs(v, offset) for v in node]
    return node


class WorkerHandle:
    """Coordinator-side view of one worker process."""

    def __init__(self, worker_id: int, channel: Channel, hello: dict):
        self.worker_id = worker_id
        self.channel = channel
        self.pid: "int | None" = hello.get("pid")
        self.substrate: str = hello.get("substrate", "local")
        self.slots: int = int(hello.get("slots", 1))
        self.state = WorkerState.HEALTHY
        self.last_pong = time.monotonic()
        self.served = 0
        self.inflight: "dict[int, _Inflight]" = {}
        self.reader: "threading.Thread | None" = None
        #: belief set: digests this worker has been shipped (may be stale —
        #: the worker LRU-evicts; ``need_blob`` repairs the divergence)
        self.blob_digests: "set[str]" = set()
        #: blobrefs sent without re-shipping bytes (the data-plane win) /
        #: shipments (first sends + need_blob re-sends)
        self.blob_hits = 0
        self.blob_misses = 0
        #: pipelined-submit writer: dispatch enqueues, the writer coalesces
        self.send_queue: "queue.Queue[Any]" = queue.Queue()
        self.writer: "threading.Thread | None" = None

    def describe(self) -> dict:
        return {
            "worker_id": self.worker_id,
            "pid": self.pid,
            "state": self.state.value,
            "substrate": self.substrate,
            "slots": self.slots,
            "served": self.served,
            "inflight": len(self.inflight),
            "blob_hits": self.blob_hits,
            "blob_misses": self.blob_misses,
            "blobs_shipped": len(self.blob_digests),
            **self.channel.wire_stats(),
        }


class Coordinator:
    def __init__(
        self,
        *,
        heartbeat_interval: float = 0.5,
        heartbeat_timeout: float = 5.0,
        max_inflight: int = 512,
        call_timeout: float = 300.0,
        token: "str | None" = None,
        flush_window: float = 0.002,
        blob_min_bytes: "int | None" = None,
        blob_budget_bytes: "int | None" = None,
    ):
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        self.max_inflight = max_inflight
        self.call_timeout = call_timeout
        self.token = token if token is not None else secrets.token_hex(8)
        #: submit-coalescing window (seconds): when a worker's writer sees
        #: a *burst* — several submits already queued, or other submits
        #: still in flight on the worker — it lingers this long for
        #: stragglers before flushing everything as one ``submit_many``
        #: frame. An isolated submit with nothing else outstanding is
        #: flushed immediately — the window never taxes synchronous
        #: single-stream latency. 0 disables the linger (still coalesces
        #: whatever already queued up).
        self.flush_window = flush_window
        #: arrays at/above this many bytes become content-addressed blobs
        self.blob_min_bytes = (
            blob_min_bytes_default() if blob_min_bytes is None else int(blob_min_bytes)
        )
        #: re-ship source for ``need_blob``; in-flight pins cover the rest
        self._blob_store = BlobStore(budget_bytes=blob_budget_bytes)
        self._digest_lock = threading.Lock()
        self._digest_cache: "dict[int, tuple[Any, Any, str]]" = {}
        self._lock = threading.RLock()
        self._space = threading.Condition(self._lock)  # admission: slot freed
        self._joined = threading.Condition(self._lock)  # wait_ready()
        self._workers: "dict[int, WorkerHandle]" = {}
        self._tickets = itertools.count(1)
        self._inflight_total = 0
        self._placement: "dict[Any, int]" = {}  # placement key -> worker_id
        self._start_failures: "dict[int, str]" = {}  # worker_id -> its fatal error
        self._generation = 0  # bumps on every join/death (topology identity)
        self._listener: "socket.socket | None" = None
        self._threads: "list[threading.Thread]" = []
        self._stopping = False
        # counters for stats()
        self._submitted = 0
        self._kernel_calls = 0
        self._retries = 0
        self._failovers = 0
        self._remote_errors = 0
        self._submit_frames = 0  # frames that carried >=1 submit
        self._submits_coalesced = 0  # submits that rode a submit_many

    # -- lifecycle -------------------------------------------------------------

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> "tuple[str, int]":
        """Bind the control socket and start the accept + monitor threads.
        Returns the bound ``(host, port)`` workers should dial."""
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((host, port))
        listener.listen(64)
        self._listener = listener
        for target, name in ((self._accept_loop, "accept"), (self._monitor_loop, "monitor")):
            thread = threading.Thread(
                target=target, name=f"cluster-{name}", daemon=True
            )
            thread.start()
            self._threads.append(thread)
        return listener.getsockname()[:2]

    @property
    def address(self) -> "tuple[str, int]":
        if self._listener is None:
            raise ClusterError("coordinator is not listening (call listen())")
        return self._listener.getsockname()[:2]

    def wait_ready(self, n_workers: int, timeout: float = 120.0) -> None:
        """Block until ``n_workers`` workers are registered and healthy.
        Raises :class:`WorkerStartError` at once, with the worker's message,
        when a worker reports that it could not start."""
        deadline = time.monotonic() + timeout
        with self._joined:
            while len(self.healthy_workers()) < n_workers:
                if self._start_failures:
                    raise WorkerStartError(
                        "worker(s) failed at start-up: " + "; ".join(
                            f"worker {wid}: {msg}"
                            for wid, msg in sorted(self._start_failures.items())
                        )
                    )
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ClusterError(
                        f"only {len(self.healthy_workers())} of {n_workers} "
                        f"workers joined within {timeout:.0f}s"
                    )
                self._joined.wait(remaining)

    def shutdown(self) -> None:
        """Stop serving: tell workers to exit, fail leftover futures."""
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
            workers = list(self._workers.values())
            self._space.notify_all()
        for worker in workers:
            worker.send_queue.put(None)  # stop the writer
            try:
                worker.channel.send({"kind": "shutdown"})
            except Exception:
                pass
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        time.sleep(0.05)  # give shutdown frames a beat to flush
        for worker in workers:
            worker.channel.close()
            self._sweep_inflight(worker, ClusterError("cluster shut down"))

    # -- membership ------------------------------------------------------------

    def healthy_workers(self) -> "list[WorkerHandle]":
        with self._lock:
            return [
                w for w in self._workers.values() if w.state == WorkerState.HEALTHY
            ]

    def worker(self, worker_id: int) -> WorkerHandle:
        with self._lock:
            return self._workers[worker_id]

    def topology_fingerprint(self) -> tuple:
        """Hashable cluster-topology identity for plan-cache fingerprints:
        which workers exist, where, and the membership generation — plans
        compiled against one topology never serve another."""
        with self._lock:
            members = tuple(
                (w.worker_id, w.substrate, w.slots)
                for w in sorted(self._workers.values(), key=lambda w: w.worker_id)
                if w.state == WorkerState.HEALTHY
            )
            return (self._generation, members)

    def _accept_loop(self) -> None:
        assert self._listener is not None
        while not self._stopping:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return  # listener closed — shutting down
            sock.settimeout(None)
            threading.Thread(
                target=self._register, args=(sock,), daemon=True
            ).start()

    def _register(self, sock: socket.socket) -> None:
        channel = Channel(sock)
        try:
            hello = channel.recv()
        except ProtocolError:
            channel.close()
            return
        if hello is None or hello.get("kind") not in ("hello", "fatal"):
            channel.close()
            return
        if self.token and hello.get("token") != self.token:
            log.warning("rejecting worker with bad token")
            channel.close()
            return
        if hello["kind"] == "fatal":
            # the worker could not start (no card for device="cuda", ...):
            # wait_ready raises with its message instead of timing out
            with self._joined:
                self._start_failures[int(hello["worker_id"])] = (
                    f"{hello.get('etype', 'Exception')}: {hello.get('error', '')}"
                )
                self._joined.notify_all()
            channel.close()
            return
        worker = WorkerHandle(int(hello["worker_id"]), channel, hello)
        with self._joined:
            stale = self._workers.get(worker.worker_id)
            if stale is not None and stale.state != WorkerState.DEAD:
                log.warning(
                    "worker %d reconnected while marked %s; replacing",
                    worker.worker_id, stale.state.value,
                )
                stale.channel.close()
            self._workers[worker.worker_id] = worker
            self._generation += 1
            self._joined.notify_all()
        reader = threading.Thread(
            target=self._reader_loop,
            args=(worker,),
            name=f"cluster-reader-{worker.worker_id}",
            daemon=True,
        )
        worker.reader = reader
        reader.start()
        writer = threading.Thread(
            target=self._writer_loop,
            args=(worker,),
            name=f"cluster-writer-{worker.worker_id}",
            daemon=True,
        )
        worker.writer = writer
        writer.start()
        log.info(
            "worker %d joined (pid=%s, substrate=%s, slots=%d)",
            worker.worker_id, worker.pid, worker.substrate, worker.slots,
        )

    # -- submission ------------------------------------------------------------

    def _array_digest(self, original: Any) -> str:
        """Content digest of one array, memoized by the *original* object's
        identity: a stream that re-submits the same matrix or graph pays the
        hash once, not per request, and a tensor on the card is not copied
        to the host to be hashed again.

        A tensor's entry also keeps its ``_version``, the counter every
        in-place torch op bumps: a tensor written in place (``t.add_(1)``)
        and re-submitted hashes anew and ships its new bytes. What the
        counter cannot see: writes through a ``.numpy()`` view, through
        ``.data``, or by a kernel through a raw pointer; re-submit a new
        tensor after such writes. A numpy array is memoized only when
        read-only; a writable one recomputes every time. Weak refs keep the
        cache from pinning arrays; un-weakref-able inputs just recompute."""
        key = id(original)
        version = getattr(original, "_version", None) if isinstance(original, torch.Tensor) else None
        with self._digest_lock:
            entry = self._digest_cache.get(key)
            if entry is not None and entry[0]() is original and entry[1] == version:
                return entry[2]
        digest = blob_digest(original)
        if version is None and not (
            isinstance(original, np.ndarray) and not original.flags.writeable
        ):
            return digest
        try:
            ref = weakref.ref(
                original, lambda _r, k=key: self._digest_cache.pop(k, None)
            )
        except TypeError:
            return digest
        with self._digest_lock:
            self._digest_cache[key] = (ref, version, digest)
        return digest

    def _make_blob_sink(self, blobs: "dict[str, Any]"):
        """A ``blob_sink`` for :func:`encode_value`: arrays at/above the
        threshold become blobrefs, pinned in ``blobs`` and admitted to the
        coordinator's re-ship store. Only an array whose digest is not
        memoized, or whose bytes the store no longer holds, is copied to
        the host."""

        def sink(original: Any) -> "str | None":
            if array_nbytes(original) < self.blob_min_bytes:
                return None
            digest = self._array_digest(original)
            stored = self._blob_store.get(digest)
            if stored is None:
                stored = self._blob_store.put(digest, original, verify=False)
            blobs[digest] = stored
            return digest

        return sink

    def submit(self, request: Request) -> ClusterFuture:
        """Serve one Request on the cluster; returns a future that always
        terminates (result, remote error, or :class:`WorkerFailure`)."""
        segments = SegmentTable()
        blobs: "dict[str, Any]" = {}
        # raises WireError before admission
        payload = request.to_wire(
            segments=segments, blob_sink=self._make_blob_sink(blobs)
        )
        op_name = payload["op"]
        strategy = request.strategy
        strategy_id = (
            strategy.cache_key() if hasattr(strategy, "cache_key") else strategy
        )
        placement_key = (op_name, strategy_id, args_signature((request.inputs,)))
        message = {"kind": "submit", "request": payload}
        with self._space:
            while (
                self._inflight_total >= self.max_inflight and not self._stopping
            ):
                self._space.wait(1.0)
            if self._stopping:
                raise ClusterError("coordinator is shut down")
            worker = self._place(placement_key)
            self._submitted += 1
        return self._dispatch(
            worker,
            message,
            decode_report=True,
            segments=segments.segments,
            blobs=blobs,
        )

    def kernel_call(
        self,
        op: str,
        args: tuple,
        kwargs: dict,
        *,
        worker_pin: "int | None" = None,
        timeout: "float | None" = None,
    ) -> Any:
        """Execute one substrate kernel on a worker (blocking). Pinned calls
        go to ``worker_pin`` while it is healthy; a death mid-call fails
        over exactly like a submit."""
        segments = SegmentTable()
        blobs: "dict[str, Any]" = {}
        sink = self._make_blob_sink(blobs)
        message = {
            "kind": "kernel_call",
            "op": op,
            "args": encode_value(tuple(args), segments=segments, blob_sink=sink),
            "kwargs": encode_value(
                dict(kwargs), segments=segments, blob_sink=sink
            ),
        }
        with self._lock:
            if self._stopping:
                raise ClusterError("coordinator is shut down")
            worker = None
            if worker_pin is not None:
                candidate = self._workers.get(worker_pin)
                if candidate is not None and candidate.state == WorkerState.HEALTHY:
                    worker = candidate
            if worker is None:
                worker = self._least_loaded()
            self._kernel_calls += 1
        future = self._dispatch(
            worker,
            message,
            decode_report=False,
            segments=segments.segments,
            blobs=blobs,
        )
        timeout = self.call_timeout if timeout is None else timeout
        try:
            response = future.result(timeout=timeout)
        except TimeoutError:
            # hung worker the heartbeat hasn't condemned yet (e.g. pings
            # answered but compute wedged): condemn it ourselves; failover
            # resubmits the call, so wait once more for the retry
            self._on_death(worker, f"kernel call exceeded {timeout:.0f}s")
            response = future.result(timeout=timeout)
        return response.result

    def _place(self, key: Any) -> WorkerHandle:
        """Sticky placement: first arrival of a key pins it to the
        least-loaded live worker; later arrivals follow the pin. Dead
        workers' pins were dropped at death, so their keys re-place here —
        the slot-redistribution half of failover."""
        pinned = self._placement.get(key)
        if pinned is not None:
            worker = self._workers.get(pinned)
            if worker is not None and worker.state == WorkerState.HEALTHY:
                return worker
        worker = self._least_loaded()
        self._placement[key] = worker.worker_id
        return worker

    def _least_loaded(self) -> WorkerHandle:
        healthy = [
            w for w in self._workers.values() if w.state == WorkerState.HEALTHY
        ]
        if not healthy:
            raise ClusterError("no healthy workers")
        pins: "dict[int, int]" = {w.worker_id: 0 for w in healthy}
        for wid in self._placement.values():
            if wid in pins:
                pins[wid] += 1
        return min(
            healthy, key=lambda w: (len(w.inflight), pins[w.worker_id], w.worker_id)
        )

    def _dispatch(
        self,
        worker: WorkerHandle,
        message: "dict[str, Any]",
        *,
        decode_report: bool,
        retried: bool = False,
        future: "ClusterFuture | None" = None,
        segments: "list[Any] | None" = None,
        blobs: "dict[str, Any] | None" = None,
    ) -> ClusterFuture:
        segments = [] if segments is None else segments
        blobs = {} if blobs is None else blobs
        with self._lock:
            if worker.state == WorkerState.DEAD:
                # died between placement and dispatch: reroute immediately
                # (raises ClusterError when no one is left)
                worker = self._least_loaded()
            ticket = next(self._tickets)
            if future is None:
                future = ClusterFuture(ticket)
            entry = _Inflight(
                ticket, future, message, decode_report, retried,
                segments=segments, blobs=blobs,
            )
            worker.inflight[ticket] = entry
            self._inflight_total += 1
            # decide blob shipments under the lock (belief set is shared
            # state); the actual sends happen outside it
            unshipped = [d for d in blobs if d not in worker.blob_digests]
            worker.blob_digests.update(unshipped)
            worker.blob_hits += len(blobs) - len(unshipped)
            worker.blob_misses += len(unshipped)
        try:
            for digest in unshipped:
                # direct send, so TCP ordering puts the bytes on the worker
                # before any frame that references the digest
                self._ship_blob(worker, digest, blobs[digest])
            if message.get("kind") == "submit":
                # the writer coalesces queued submits into submit_many
                worker.send_queue.put(({**message, "ticket": ticket}, segments))
            else:
                worker.channel.send({**message, "ticket": ticket}, segments)
        except Exception as exc:  # connection died between place and send
            self._on_death(worker, f"send failed: {exc}")
        return future

    def _ship_blob(self, worker: WorkerHandle, digest: str, array: Any) -> None:
        table = SegmentTable()
        encoded = encode_value(array, segments=table)
        worker.channel.send(
            {"kind": "put_blob", "digest": digest, "blob": encoded},
            table.segments,
        )

    def _writer_loop(self, worker: WorkerHandle) -> None:
        """Per-worker pipelined-submit writer: pick up one queued submit,
        drain whatever else already queued, and flush it all as a single
        frame — ``submit_many`` when more than one coalesced. The
        ``flush_window`` linger only happens when a burst is plausibly in
        progress — the drain found company, or the caller has *other*
        submits still in flight on this worker (a pipelined stream, so
        more is coming); a synchronous single-stream caller's isolated
        submit flushes immediately and pays no latency tax."""
        q = worker.send_queue
        while True:
            item = q.get()
            if item is None:
                return  # death or shutdown sentinel
            batch = [item]
            stop = False

            def drain() -> None:
                nonlocal stop
                while not stop:
                    try:
                        nxt = q.get_nowait()
                    except queue.Empty:
                        return
                    if nxt is None:
                        stop = True
                        return
                    batch.append(nxt)

            drain()
            # worker.inflight already holds the batch's own entries
            # (dispatch registers before enqueueing), so a strictly larger
            # inflight table means other submits are still outstanding
            if (
                self.flush_window > 0
                and not stop
                and (len(batch) > 1 or len(worker.inflight) > len(batch))
            ):
                time.sleep(self.flush_window)
                drain()
            try:
                self._send_batch(worker, batch)
            except Exception as exc:
                # _on_death retries everything in worker.inflight —
                # including the batch and anything still queued
                self._on_death(worker, f"send failed: {exc}")
                return
            if stop:
                return

    def _send_batch(self, worker: WorkerHandle, batch: "list[tuple]") -> None:
        if len(batch) == 1:
            message, segments = batch[0]
            worker.channel.send(message, segments)
            with self._lock:
                self._submit_frames += 1
            return
        items: "list[Any]" = []
        all_segments: "list[Any]" = []
        for message, segments in batch:
            items.append(_offset_ndrefs(message, len(all_segments)))
            all_segments.extend(segments)
        worker.channel.send(
            {"kind": "submit_many", "items": items}, all_segments
        )
        with self._lock:
            self._submit_frames += 1
            self._submits_coalesced += len(batch)

    # -- worker I/O ------------------------------------------------------------

    def _reader_loop(self, worker: WorkerHandle) -> None:
        while True:
            try:
                message = worker.channel.recv()
            except ProtocolError as exc:
                self._on_death(worker, f"protocol error: {exc}")
                return
            if message is None:
                if worker.state != WorkerState.DEAD and not self._stopping:
                    self._on_death(worker, "connection closed")
                return
            try:
                self._on_message(worker, message)
            except Exception:
                log.exception(
                    "error handling %r from worker %d",
                    message.get("kind"), worker.worker_id,
                )

    def _on_message(self, worker: WorkerHandle, message: dict) -> None:
        kind = message["kind"]
        if kind == "pong":
            worker.last_pong = time.monotonic()
            return
        if kind == "log":
            level = getattr(logging, message.get("level", "INFO"), logging.INFO)
            logging.getLogger(
                f"repro_torch.cluster.w{worker.worker_id}.{message.get('logger', '?')}"
            ).log(level, "%s", message.get("msg", ""))
            return
        if kind in ("result", "error"):
            with self._space:
                entry = worker.inflight.pop(message["ticket"], None)
                if entry is not None:
                    self._inflight_total -= 1
                    self._space.notify_all()
            if entry is None:
                return  # already failed over; late answer is redundant
            if kind == "error":
                with self._lock:
                    self._remote_errors += 1
                entry.future._fail(
                    RemoteOpError(
                        message.get("etype", "Exception"),
                        message.get("error", ""),
                        worker.worker_id,
                    )
                )
                return
            worker.served += 1
            report = message.get("report")
            entry.future._resolve(
                ClusterResponse(
                    ticket=entry.ticket,
                    result=decode_value(message["result"]),
                    report=(
                        decode_value(report)
                        if entry.decode_report and report is not None
                        else None
                    ),
                    worker_id=worker.worker_id,
                    retried=entry.retried,
                )
            )
            return
        if kind == "stats_reply":
            with self._lock:
                entry = worker.inflight.pop(message["ticket"], None)
                self._inflight_total -= 1 if entry else 0
            if entry is not None:
                entry.future._resolve(
                    ClusterResponse(
                        entry.ticket, message.get("stats"), None, worker.worker_id
                    )
                )
            return
        if kind == "need_blob":
            # the worker evicted (or never had) these digests: re-ship from
            # the coordinator store, falling back to in-flight pins; answer
            # blob_gone for anything unproducible so the request fails fast
            # instead of hanging in BlobStore.ensure
            for digest in message.get("digests", ()):
                array = self._blob_store.get(digest)
                if array is None:
                    with self._lock:
                        for w in self._workers.values():
                            for entry in w.inflight.values():
                                if digest in entry.blobs:
                                    array = entry.blobs[digest]
                                    break
                            if array is not None:
                                break
                try:
                    if array is None:
                        log.warning(
                            "worker %d needs blob %s but it is gone",
                            worker.worker_id, digest,
                        )
                        # forget the belief too: the next submit that
                        # references this digest must re-ship the bytes,
                        # not trust a pin we just failed to honor
                        with self._lock:
                            worker.blob_digests.discard(digest)
                        worker.channel.send(
                            {"kind": "blob_gone", "digest": digest}
                        )
                        continue
                    with self._lock:
                        worker.blob_digests.add(digest)
                        worker.blob_misses += 1
                    self._ship_blob(worker, digest, array)
                except Exception as exc:
                    self._on_death(worker, f"blob re-ship failed: {exc}")
                    return
            return
        log.warning("unknown message kind %r from worker %d", kind, worker.worker_id)

    # -- health + failover -----------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stopping:
            time.sleep(self.heartbeat_interval)
            if self._stopping:  # woke into a shutdown: channels are closing
                return
            now = time.monotonic()
            for worker in self.healthy_workers():
                if now - worker.last_pong > self.heartbeat_timeout:
                    self._on_death(
                        worker,
                        f"missed heartbeats for {now - worker.last_pong:.1f}s",
                    )
                    continue
                try:
                    worker.channel.send({"kind": "ping"})
                except Exception as exc:
                    self._on_death(worker, f"ping failed: {exc}")

    def _on_death(self, worker: WorkerHandle, reason: str) -> None:
        """Declare ``worker`` dead: drop its placement pins, retry its
        in-flight work once on survivors, fail what was already retried."""
        with self._joined:
            if worker.state == WorkerState.DEAD or self._stopping:
                return  # already handled, or a shutdown tearing channels down
            worker.state = WorkerState.DEAD
            self._generation += 1
            self._failovers += 1
            dropped = [
                key for key, wid in self._placement.items()
                if wid == worker.worker_id
            ]
            for key in dropped:
                del self._placement[key]
            orphans = list(worker.inflight.values())
            worker.inflight.clear()
            self._inflight_total -= len(orphans)
            self._space.notify_all()
            self._joined.notify_all()
        worker.send_queue.put(None)  # stop the writer
        log.warning(
            "worker %d is dead (%s): redistributing %d placement pins, "
            "retrying %d in-flight request(s)",
            worker.worker_id, reason, len(dropped), len(orphans),
        )
        worker.channel.close()
        for entry in orphans:
            if entry.retried:
                entry.future._fail(
                    WorkerFailure(
                        f"request {entry.ticket} lost worker "
                        f"{worker.worker_id} ({reason}) after one retry"
                    )
                )
                continue
            try:
                with self._lock:
                    survivor = self._least_loaded()
                    self._retries += 1
                # segments + blob pins travel with the retry: the survivor
                # gets the same bytes (put_blob first if it lacks any
                # digest), so the replay is bit-identical
                self._dispatch(
                    survivor,
                    entry.message,
                    decode_report=entry.decode_report,
                    retried=True,
                    future=entry.future,
                    segments=entry.segments,
                    blobs=entry.blobs,
                )
            except ClusterError as exc:
                entry.future._fail(
                    WorkerFailure(
                        f"request {entry.ticket} lost worker "
                        f"{worker.worker_id} ({reason}) and no healthy "
                        f"worker remains: {exc}"
                    )
                )

    def _sweep_inflight(self, worker: WorkerHandle, exc: BaseException) -> None:
        with self._lock:
            orphans = list(worker.inflight.values())
            worker.inflight.clear()
            self._inflight_total -= len(orphans)
        for entry in orphans:
            entry.future._fail(exc)

    # -- introspection ---------------------------------------------------------

    def worker_stats(self, worker_id: int, timeout: float = 30.0) -> dict:
        """The worker's own ``ServiceStats.to_dict()`` snapshot, fetched
        over the wire."""
        worker = self.worker(worker_id)
        future = self._dispatch(
            worker, {"kind": "stats"}, decode_report=False
        )
        return future.result(timeout=timeout).result

    def stats(self) -> "dict[str, Any]":
        """Control-plane counters + per-worker health, serve counts, and
        wire-traffic rows (bytes/frames/blob hit-miss per worker)."""
        with self._lock:
            workers = [w.describe() for w in self._workers.values()]
            served = sum(w.served for w in self._workers.values())
            return {
                "workers": workers,
                "n_workers": len(workers),
                "n_healthy": sum(
                    1 for w in workers if w["state"] == WorkerState.HEALTHY.value
                ),
                "generation": self._generation,
                "submitted": self._submitted,
                "kernel_calls": self._kernel_calls,
                "served": served,
                "inflight": self._inflight_total,
                "retries": self._retries,
                "failovers": self._failovers,
                "remote_errors": self._remote_errors,
                "placement_pins": len(self._placement),
                "wire_bytes_sent": sum(w["bytes_sent"] for w in workers),
                "wire_bytes_received": sum(
                    w["bytes_received"] for w in workers
                ),
                "blob_hits": sum(w["blob_hits"] for w in workers),
                "blob_misses": sum(w["blob_misses"] for w in workers),
                "blob_store": self._blob_store.stats(),
                "submit_frames": self._submit_frames,
                "submits_coalesced": self._submits_coalesced,
                "flush_window": self.flush_window,
            }
