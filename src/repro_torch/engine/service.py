"""EngineService: the serving front-end over the plan/compile/execute
pipeline, in two modes.

**Batch mode** (the default): ``submit()`` returns an int ticket and
nothing runs until ``drain()`` executes everything, grouped by plan key so
each group compiles at most once.

    svc = EngineService(device="cuda")
    t = svc.submit(Request("spmv", inputs))      # -> int ticket
    responses = svc.drain()                      # one compile per plan key

**Worker-loop mode** (the serving path): ``start()`` spawns an *execution
plane* — one scheduler/compile thread feeding a pool of N executor workers:

- the **scheduler** pops plan-key groups off the admission queue, orders
  them by QoS weight, places each group on a pool slot, runs the group's
  first (possibly compiling) call, and hands warm work to the slot's queue;
- each **executor worker** serves its queue of cache-hit calls in QoS
  order; an idle worker steals queued (or straggling) groups from the
  busiest peer — on "spread" substrates only.

    svc = EngineService(workers=4, max_queue_depth=256, qos={"bfs": 2.0})
    svc.start()
    fut = svc.submit(Request("spmv", inputs))    # -> ServiceFuture, non-blocking
    resp = fut.result(timeout=60)                # ServiceResponse
    svc.stop()                                   # drains by default
    print(svc.stats().worker_occupancy)          # per-worker utilization

**On the card** each pool worker runs its calls on a CUDA stream of its own,
and the scheduler (plans, ``"auto"`` picks, first calls) on another, so the
slots' kernels can overlap and a call's ``RunReport.seconds`` — which ends
in a synchronize of the current stream only — never includes another
slot's kernels. The streams belong to the service, not to the substrate:
they are not part of any cache key, so a compiled entry serves every slot
and a steal moves work between streams freely. Four hazards come with
streams, and each is handled here:

- a slot's stream does not wait for the stream that produced the inputs:
  ``submit`` records an event on the submitter's current stream, the
  scheduler's stream waits for it before building the plan, and the slot's
  stream waits for an event recorded after the plan before its first launch;
- a future resolves only after its slot's stream is synchronized;
- a result tensor was allocated on the slot's stream: ``ServiceFuture.result``
  records the caller's current stream on it (``record_stream``), so the
  allocator does not hand its memory to the slot while the caller's work on
  it is queued. (Plan arguments made on the scheduler's stream are freed
  only after every slot that read them has synchronized.)
- kernels launch on the calling thread's current device, so every call
  runs under ``torch.cuda.device`` of its substrate.

Admission control: ``max_queue_depth`` bounds the request queue;
``admission="block"`` applies backpressure to submitters (requires a running
worker to make progress), ``admission="reject"`` raises
:class:`AdmissionError` immediately (counted in ``ServiceStats.rejected``).
``qos`` maps op names to scheduling weights — within each queue snapshot,
higher-weight groups run first, and the per-slot queues keep that order
within every worker (ordering, not preemption).

Results are **bit-identical** to sequential ``engine.run`` in both modes and
at any pool width: each request still executes the same cached-executor
call the synchronous path would have run; concurrency changes *when* plans
compile and *where* warm calls run, never what they compute. The service's
lock is never held across an executor call, so a first call that waits on
a kernel build (``kernels/build.py``) never blocks a submitter.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import threading
import time
from collections import deque
from typing import Any, Iterator

import torch

from .. import trace
from ..core.strategies import MigratoryStrategy
from ..device import resolve_device
from .api import RunReport
from .cache import PlanCache
from .request import Request
from .runner import build_plan, resolve_op, single_call
from .substrate import Substrate, get_substrate, substrate_classes

# per-request latency samples kept for percentile estimation (newest wins;
# bounds memory for long-lived services, like the span folding below)
_LATENCY_WINDOW = 4096

# workers="auto" resolves to min(this, substrate.placement_slots())
_AUTO_WORKER_CAP = 8

# placement memory (base plan key -> slot) is LRU-bounded; evicting a pin
# only costs a re-placement, never correctness
_PIN_TABLE_MAX = 4096

# the scheduler's stream key (pool workers use their slot index)
_COMPILE_CHANNEL = "compile"


def _percentile(ordered: "list[float]", q: float) -> float:
    """Nearest-rank percentile of an already-sorted sample list."""
    if not ordered:
        return 0.0
    idx = min(len(ordered) - 1, max(0, int(round(q * (len(ordered) - 1)))))
    return ordered[idx]


class AdmissionError(RuntimeError):
    """submit() refused: the queue is full under the 'reject' policy (or
    'block' with no worker running to ever free space)."""


class ServiceStopped(RuntimeError):
    """The service shut down: raised by submissions after stop() and by
    futures whose queued request was cancelled by stop(drain=False)."""


class ServiceTimeout(RuntimeError):
    """A request's per-request deadline (``Request.timeout``) passed while
    it was still queued: the service shed it instead of running it (counted
    in ``ServiceStats.timed_out``)."""


@dataclasses.dataclass(frozen=True)
class ServiceRequest:
    ticket: int
    op: Any
    inputs: Any
    strategy: "MigratoryStrategy | str | None"
    substrate: Substrate
    t_admit: float = 0.0  # perf_counter at admission (queue-wait percentiles)
    qos: "float | None" = None  # per-request weight override (Request.qos)
    timeout: "float | None" = None  # deadline seconds from admission


@dataclasses.dataclass
class ServiceResponse:
    ticket: int
    result: Any
    report: RunReport


def _result_tensors(result: Any) -> "Iterator[torch.Tensor]":
    if isinstance(result, torch.Tensor):
        yield result
    elif isinstance(result, (tuple, list)):
        for r in result:
            yield from _result_tensors(r)


class ServiceFuture:
    """Handle for one worker-loop submission — what async ``submit`` returns.

    ``result(timeout)`` blocks until the request is served and returns its
    :class:`ServiceResponse`; it re-raises the request's exception if the
    run failed or the service dropped it (:class:`ServiceStopped`). A
    result on the card is complete when ``result`` returns, and is marked
    in use by the caller's current stream.
    """

    def __init__(self, ticket: int):
        self.ticket = ticket
        self._done = threading.Event()
        self._response: ServiceResponse | None = None
        self._exception: BaseException | None = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: "float | None" = None) -> ServiceResponse:
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.ticket} not served within {timeout}s")
        if self._exception is not None:
            raise self._exception
        for t in _result_tensors(self._response.result):
            if t.is_cuda:
                t.record_stream(torch.cuda.current_stream(t.device))
        return self._response

    def exception(self, timeout: "float | None" = None) -> "BaseException | None":
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.ticket} not served within {timeout}s")
        return self._exception

    def _resolve(self, response: ServiceResponse) -> None:
        self._response = response
        self._done.set()

    def _reject(self, exc: BaseException) -> None:
        self._exception = exc
        self._done.set()


@dataclasses.dataclass
class _WorkItem:
    """One admitted worker-loop request moving through the pipeline.

    ``waiters`` are in-flight-coalesced duplicates: (ticket, future) pairs
    of value-identical requests that attached to this item instead of
    queueing. They resolve (or fail, or cancel) with it, atomically.
    ``ready`` is the CUDA event the item's first launch waits for (the
    submitter's stream at admission, then the scheduler's after the plan)."""

    request: ServiceRequest
    future: ServiceFuture
    op: Any = None
    plan: Any = None
    dedup_key: "str | None" = None  # content hash when dedup is enabled
    waiters: "list[tuple[int, ServiceFuture]]" = dataclasses.field(default_factory=list)
    ready: "torch.cuda.Event | None" = None


@dataclasses.dataclass
class _Group:
    """One plan-key group placed on a pool slot — the scheduling unit of the
    execution plane. ``items`` is consumed head-first by the owning worker;
    stealers split from the tail, so arrival order survives on the owner."""

    key: Any
    qos: float
    first_ticket: int
    slot: int = 0
    stealable: bool = True
    stolen: bool = False  # arrived at its worker via a steal, not dispatch
    items: "deque[_WorkItem]" = dataclasses.field(default_factory=deque)


def _content_hash(op: Any, inputs: Any, strategy: Any, substrate: Any) -> str:
    """Value-keyed identity of one request: op name x strategy identity x
    substrate fingerprint x the *bytes* of every input leaf. Two requests
    with equal hashes are the same computation — ops are pure — so the
    service may answer the second from the first's response.

    Built on the stable wire encoding
    (:func:`~repro_torch.engine.wire.canonical_bytes`), the bytes a
    :class:`~repro_torch.engine.request.Request` serializes to, so
    "identical computation" means one thing in and out of process. Inputs
    on the card are copied to the host for it (on the caller's stream)."""
    from .wire import canonical_bytes

    h = hashlib.sha256()
    op_name = op if isinstance(op, str) else getattr(op, "name", repr(op))
    strat_id = strategy.cache_key() if isinstance(strategy, MigratoryStrategy) else strategy
    h.update(canonical_bytes((op_name, strat_id, inputs)))
    h.update(repr(get_substrate(substrate).cache_fingerprint()).encode())
    return h.hexdigest()


def _union_seconds(spans: "list[tuple[float, float]]") -> float:
    """Total covered time of possibly-overlapping (t0, t1) spans."""
    return sum(t1 - t0 for t0, t1 in _merge_spans(spans))


def _merge_spans(spans: "list[tuple[float, float]]") -> "list[tuple[float, float]]":
    """Union of spans as a sorted, non-overlapping span list (the executor
    pool's N workers overlap each other; merging first keeps the two-pointer
    intersection below exact)."""
    merged: list[tuple[float, float]] = []
    for t0, t1 in sorted(spans):
        if merged and t0 <= merged[-1][1]:
            if t1 > merged[-1][1]:
                merged[-1] = (merged[-1][0], t1)
        else:
            merged.append((t0, t1))
    return merged


def _intersection_seconds(
    a: "list[tuple[float, float]]", b: "list[tuple[float, float]]"
) -> float:
    """Total time spans from ``a`` and ``b`` ran simultaneously. Each list
    must be internally non-overlapping (``a``: the single scheduler thread;
    ``b``: pre-merged via :func:`_merge_spans`), so a two-pointer sweep is
    exact."""
    a, b = sorted(a), sorted(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


@dataclasses.dataclass
class ServiceStats:
    """Aggregate serving counters across the service's lifetime, both modes.

    Timing semantics (the ``to_dict()`` schema):

    - ``wall_seconds`` — observable serving window. Batch mode: summed
      ``drain()`` wall time. Worker mode: first admission -> latest
      completion, so idle time between bursts counts — it is the
      denominator of sustained ``requests_per_second``.
    - ``busy_seconds`` — time at least one pipeline stage was doing work
      (union of compile-stage and all executor-worker spans; equals wall
      time in batch mode). ``wall - busy`` is idle.
    - ``overlap_seconds`` — time the compile stage of one plan-key group ran
      simultaneously with any worker executing another;
      ``overlap_ratio = overlap_seconds / total compile-stage seconds`` is
      the fraction of compile time hidden under execution (0 in batch mode).
    - ``queue_wait_p50/p95/p99`` — per-request admission -> run-start wait;
      ``service_p50/p95/p99`` — per-request run duration; ``total_p50/p95/p99``
      — admission -> completion, the latency a client observes. Estimated
      over the most recent ``_LATENCY_WINDOW`` executed requests;
      dedup-served requests wait for neither and are excluded.
    - SLO accounting (``slo_target_seconds`` on the constructor): every
      executed request's *total* latency is checked against the target —
      ``slo_checked``/``slo_violations`` count them and ``slo_attainment``
      is the within-target fraction. ``timed_out`` counts requests shed at
      their ``Request.timeout`` deadline (their futures raise
      :class:`ServiceTimeout`; they are neither errors nor SLO samples).
    - ``dedup_hits`` — requests answered from the value-keyed response cache
      without executing (``dedup=True`` only). ``dedup_coalesced`` is the
      in-flight subset: duplicates that attached to a *pending* identical
      request instead of waiting for it to complete first.
    - ``workers``/``steals`` and the ``worker_*`` columns — the execution
      plane: pool width, total stolen groups, and per-worker busy seconds /
      executed requests / steals / occupancy (busy ÷ serving window).
    - ``wire_bytes_*`` and ``blob_*`` are the wire counters of a
      multi-process plane; an in-process service leaves them 0.
    """

    requests: int = 0
    batches: int = 0
    drains: int = 0
    cache_hits: int = 0
    compiles: int = 0
    compile_seconds: float = 0.0
    run_seconds: float = 0.0  # steady-state execution seconds (compile excluded)
    wall_seconds: float = 0.0  # serving window (see class docstring)
    busy_seconds: float = 0.0  # >=1 pipeline stage active (see class docstring)
    queue_depth_hwm: int = 0  # high-water mark of the admission queue
    rejected: int = 0  # admission-control rejections
    cancelled: int = 0  # queued requests dropped by stop(drain=False)
    errors: int = 0  # requests whose plan/execute raised
    overlap_seconds: float = 0.0
    overlap_ratio: float = 0.0
    dedup_hits: int = 0  # responses served from the value-keyed dedup cache
    dedup_coalesced: int = 0  # ... of which attached to an in-flight primary
    workers: int = 1  # executor-pool width
    steals: int = 0  # groups (or group tails) migrated to an idle worker
    timed_out: int = 0  # requests shed at their per-request deadline
    queue_wait_p50: float = 0.0
    queue_wait_p95: float = 0.0
    queue_wait_p99: float = 0.0
    service_p50: float = 0.0
    service_p95: float = 0.0
    service_p99: float = 0.0
    total_p50: float = 0.0  # admission -> completion (queue wait + service)
    total_p95: float = 0.0
    total_p99: float = 0.0
    slo_target_seconds: "float | None" = None
    slo_checked: int = 0  # executed requests measured against the target
    slo_violations: int = 0  # ... of which exceeded it
    worker_busy_seconds: "list[float]" = dataclasses.field(default_factory=list)
    worker_requests: "list[int]" = dataclasses.field(default_factory=list)
    worker_steals: "list[int]" = dataclasses.field(default_factory=list)
    worker_occupancy: "list[float]" = dataclasses.field(default_factory=list)
    #: peak per-worker occupancy observed across stats() snapshots
    occupancy_hwm: float = 0.0
    wire_bytes_sent: int = 0
    wire_bytes_received: int = 0
    blob_hits: int = 0
    blob_misses: int = 0

    @property
    def requests_per_second(self) -> float:
        return self.requests / self.wall_seconds if self.wall_seconds > 0 else 0.0

    @property
    def amortization(self) -> float:
        """Requests served per compile — the batching win."""
        return self.requests / self.compiles if self.compiles else float(self.requests)

    @property
    def slo_attainment(self) -> "float | None":
        """Fraction of SLO-checked requests whose total latency met the
        declared target; None when no target was declared (or nothing ran)."""
        if self.slo_target_seconds is None or self.slo_checked == 0:
            return None
        return 1.0 - self.slo_violations / self.slo_checked

    def resize_signal(self, *, grow_above: float = 0.75, shrink_below: float = 0.25) -> str:
        """``"grow" | "hold" | "shrink"`` from per-worker occupancy — the
        elastic-pool resize trigger.

        - **grow**: mean occupancy at/above ``grow_above``.
        - **shrink**: more than one worker and even the *busiest* sits
          at/below ``shrink_below``.
        - **hold**: everything in between, or nothing observed yet."""
        occ = self.worker_occupancy
        if not occ or self.wall_seconds <= 0.0:
            return "hold"
        mean = sum(occ) / len(occ)
        if mean >= grow_above:
            return "grow"
        if len(occ) > 1 and max(occ) <= shrink_below:
            return "shrink"
        return "hold"

    def to_dict(self) -> dict[str, Any]:
        row = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        # the reference's column order: slo_attainment after the SLO counts
        out: dict[str, Any] = {}
        for name, value in row.items():
            out[name] = value
            if name == "slo_violations":
                out["slo_attainment"] = self.slo_attainment
        out["resize_signal"] = self.resize_signal()
        out["requests_per_second"] = self.requests_per_second
        out["amortization"] = self.amortization
        return out


class EngineService:
    """Serving front-end over the plan/compile/execute pipeline.

    Constructed services are in batch mode; ``start()`` switches to the
    worker loop (module docstring). ``substrate`` is the default for
    requests that name none; a substrate given by name (here or on a
    request) is built on ``device`` (default the card; without one the
    constructor raises). ``workers`` sets the executor-pool width: an int,
    or ``"auto"`` to size from the default substrate's ``placement_slots()``
    (capped at 8). ``batch_window`` is the micro-batching window — after the
    first request of a burst arrives, the scheduler waits this long before
    snapshotting the queue; ``pipeline_depth`` scales the plane's dispatch
    budget — at most ``pipeline_depth * workers`` groups queued across the
    pool — as backpressure on the scheduler.

    ``dedup=True`` puts a value-keyed response cache in front of the
    pipeline: requests whose op + strategy + substrate + input *values*
    content-hash to an already-served request are answered from the stored
    response without planning or executing, and concurrent identical
    requests coalesce onto the pending request's future
    (``ServiceStats.dedup_hits`` / ``dedup_coalesced``). Off by default —
    hashing copies every input to the host.
    """

    def __init__(
        self,
        cache: PlanCache | None = None,
        substrate: "Substrate | str" = "local",
        autotune: bool = False,
        *,
        device: "str | torch.device" = "cuda",
        workers: "int | str" = 1,
        max_queue_depth: "int | None" = None,
        admission: str = "block",
        qos: "dict[str, float] | None" = None,
        batch_window: float = 0.0,
        pipeline_depth: int = 2,
        dedup: bool = False,
        dedup_max_entries: int = 256,
        slo_target_seconds: "float | None" = None,
    ):
        if admission not in ("block", "reject"):
            raise ValueError(f"admission must be 'block' or 'reject', got {admission!r}")
        if isinstance(workers, str):
            if workers != "auto":
                raise ValueError(f"workers must be an int >= 1 or 'auto', got {workers!r}")
        elif int(workers) < 1:
            raise ValueError(f"workers must be an int >= 1 or 'auto', got {workers!r}")
        if slo_target_seconds is not None and float(slo_target_seconds) <= 0:
            raise ValueError(f"slo_target_seconds must be > 0, got {slo_target_seconds!r}")
        self.device = resolve_device(device)
        self._named: dict[str, Substrate] = {}  # name -> instance on self.device
        self.cache = cache if cache is not None else PlanCache()
        self.default_substrate = self._substrate(substrate)
        self.autotune = autotune
        self.workers = workers
        self.max_queue_depth = max_queue_depth
        self.admission = admission
        # validate weights here: a bad value must fail the constructor, not
        # the scheduler inside the worker thread
        self.qos = {name: float(weight) for name, weight in (qos or {}).items()}
        self.batch_window = batch_window
        self.pipeline_depth = max(1, pipeline_depth)
        self.dedup = dedup
        self.dedup_max_entries = max(1, dedup_max_entries)
        self.slo_target_seconds = slo_target_seconds
        # value-keyed response store: content hash -> served ServiceResponse
        self._dedup_store: "collections.OrderedDict[str, ServiceResponse]" = (
            collections.OrderedDict()
        )
        # content hash -> the in-flight primary item coalesced waiters attach to
        self._dedup_pending: "dict[str, _WorkItem]" = {}
        self._queue_waits: deque = deque(maxlen=_LATENCY_WINDOW)
        self._service_times: deque = deque(maxlen=_LATENCY_WINDOW)
        self._total_latencies: deque = deque(maxlen=_LATENCY_WINDOW)
        self._pending: list[ServiceRequest] = []
        self._next_ticket = 0
        self._stats = ServiceStats()
        # worker-loop state: one lock, five conditions on it
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)  # scheduler: items arrived
        self._space = threading.Condition(self._lock)  # submitters: space freed
        self._idle = threading.Condition(self._lock)  # flush(): all resolved
        self._pool_work = threading.Condition(self._lock)  # workers: groups queued
        self._pool_space = threading.Condition(self._lock)  # scheduler: slot freed
        self._queue: deque[_WorkItem] = deque()
        self._inflight = 0  # admitted worker requests not yet resolved
        self._running = False
        self._stopping = False
        self._sched_done = False  # scheduler exited; workers may drain + exit
        self._cancel_queued = False  # stop(drain=False): cancel undispatched work
        self._threads: list[threading.Thread] = []
        # the execution plane: per-worker group queues + in-progress groups
        self._n_workers = 1
        self._pool_queues: "list[list[_Group]]" = []
        self._pool_current: "list[_Group | None]" = []
        self._worker_spans: "list[list[tuple[float, float]]]" = []
        self._worker_busy: list[float] = []
        self._worker_reqs: list[int] = []
        self._worker_steal_counts: list[int] = []
        # placement memory: base plan key -> slot (scheduler thread only)
        self._pins: "collections.OrderedDict[Any, int]" = collections.OrderedDict()
        self._rr_next = 0
        # (device index, channel) -> the CUDA stream that channel runs on
        self._streams: "dict[tuple[int, Any], torch.cuda.Stream]" = {}
        self._stream_lock = threading.Lock()
        # every not-yet-done worker-mode future, for the shutdown sweep that
        # guarantees no submitted future is ever stranded
        self._live: "dict[int, ServiceFuture]" = {}
        # (worker, first_ticket, qos, stolen) per executed group — bounded
        # trace the pool tests assert per-worker QoS ordering against
        self._exec_trace: deque = deque(maxlen=4096)
        self._compile_spans: list[tuple[float, float]] = []
        # long-run safety: spans periodically fold into these accumulators so
        # a service alive for millions of requests stays O(1) in memory
        self._overlap_acc = 0.0
        self._busy_acc = 0.0
        self._compile_busy_acc = 0.0
        self._drain_wall = 0.0
        self._t_first: "float | None" = None
        self._t_last: "float | None" = None
        self._occ_hwm = 0.0  # peak per-worker occupancy across snapshots

    def __len__(self) -> int:
        """Unserved requests: batch-pending plus worker-admitted in flight."""
        with self._lock:
            return len(self._pending) + self._inflight

    # -- substrates and streams -------------------------------------------------

    def _substrate(self, spec: "Substrate | str | None") -> Substrate:
        """A request's substrate: instances pass through, names resolve to
        one instance per name on the service's device, None to the
        default."""
        if spec is None:
            return self.default_substrate
        if isinstance(spec, Substrate):
            return spec
        sub = self._named.get(spec)
        if sub is None:
            classes = substrate_classes()
            if spec not in classes:
                raise ValueError(f"unknown substrate {spec!r}; registered: {sorted(classes)}")
            sub = self._named.setdefault(spec, classes[spec](self.device))
        return sub

    def _stream(self, device: torch.device, channel: Any) -> "torch.cuda.Stream":
        index = device.index if device.index is not None else torch.cuda.current_device()
        with self._stream_lock:
            stream = self._streams.get((index, channel))
            if stream is None:
                stream = self._streams[(index, channel)] = torch.cuda.Stream(device=index)
            return stream

    @contextlib.contextmanager
    def _on_channel(self, sub: Substrate, channel: Any) -> "Iterator[torch.cuda.Stream | None]":
        """Run the body on ``sub``'s device and, for a pool channel (a slot
        index or the compile stage), on that channel's stream; yields the
        stream (None off the card or for ``channel=None``: the caller's
        own stream, batch mode)."""
        if sub.device.type != "cuda":
            yield None
            return
        with torch.cuda.device(sub.device):
            if channel is None:
                yield None
                return
            stream = self._stream(sub.device, channel)
            with torch.cuda.stream(stream):
                yield stream

    # -- admission -------------------------------------------------------------

    def qos_weight(self, op_name: str) -> float:
        return float(self.qos.get(op_name, 1.0))

    def _effective_qos(self, item: _WorkItem) -> float:
        """Per-request ``Request.qos`` override, else the per-op table."""
        q = item.request.qos
        return float(q) if q is not None else self.qos_weight(item.op.name)

    def _resolve_workers(self) -> int:
        if isinstance(self.workers, int):
            return max(1, self.workers)
        return max(1, min(_AUTO_WORKER_CAP, self.default_substrate.placement_slots()))

    def _admit_locked(self) -> None:
        if self._stopping:
            raise ServiceStopped("service stopped; no new submissions")
        if self.max_queue_depth is None:
            return
        while (len(self._queue) if self._running else len(self._pending)) >= self.max_queue_depth:
            if self.admission == "reject" or not self._running:
                self._stats.rejected += 1
                reason = (
                    "policy is 'reject'"
                    if self.admission == "reject"
                    else "'block' needs a running worker to free space; call start()"
                )
                raise AdmissionError(f"queue full ({self.max_queue_depth} requests); {reason}")
            self._space.wait(timeout=0.1)
            if self._stopping:
                raise ServiceStopped("service stopped while blocked on admission")

    def submit(self, request: Request) -> "int | ServiceFuture":
        """Enqueue one :class:`~repro_torch.engine.request.Request`. Batch
        mode returns its int ticket (serve via ``drain()``); worker-loop mode
        returns a :class:`ServiceFuture`. ``Request.qos`` overrides the
        service's per-op weight for this request's group; ``Request.timeout``
        is a deadline from admission — still queued past it, the request is
        shed (:class:`ServiceTimeout`). Full queues block or raise per the
        admission policy. With ``dedup=True``, a worker-mode request whose
        content hash matches an already-*served* response resolves
        immediately, and one matching a *pending* identical request
        coalesces onto its future — neither enters the queue (batch mode
        dedups inside ``drain()``)."""
        if not isinstance(request, Request):
            raise TypeError(f"submit takes a Request, got {type(request).__name__}")
        op, inputs, strategy = request.op, request.inputs, request.strategy
        if strategy is None and self.autotune:
            strategy = "auto"
        sub = self._substrate(request.substrate)
        dkey = None
        # batch mode hashes inside drain() instead — a submit-time hash could
        # never serve a hit there (responses only exist once drain runs)
        if self.dedup and self._running:
            dkey = _content_hash(op, inputs, strategy, sub)  # outside the lock
        ready = None
        if self._running and sub.device.type == "cuda":
            # the inputs are complete once the submitter's stream reaches here
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(sub.device))
        with self._lock:
            if dkey is not None and self._running and not self._stopping:
                served = self._dedup_submit_locked(dkey)
                if served is not None:
                    return served
            self._admit_locked()
            if dkey is not None and self._running:
                # _admit_locked may have blocked; the answer (or a pending
                # primary) may have appeared while we waited
                served = self._dedup_submit_locked(dkey)
                if served is not None:
                    return served
            ticket = self._next_ticket
            self._next_ticket += 1
            req = ServiceRequest(
                ticket=ticket,
                op=op,
                inputs=inputs,
                strategy=strategy,
                substrate=sub,
                t_admit=time.perf_counter(),
                qos=request.qos,
                timeout=request.timeout,
            )
            if self._running:
                future = ServiceFuture(ticket)
                item = _WorkItem(req, future, dedup_key=dkey, ready=ready)
                if dkey is not None:
                    self._dedup_pending[dkey] = item
                self._queue.append(item)
                self._live[ticket] = future
                self._inflight += 1
                if self._t_first is None:
                    self._t_first = time.perf_counter()
                self._stats.queue_depth_hwm = max(self._stats.queue_depth_hwm, len(self._queue))
                self._work.notify()
                return future
            self._pending.append(req)
            self._stats.queue_depth_hwm = max(self._stats.queue_depth_hwm, len(self._pending))
            return ticket

    def _dedup_serve_locked(self, response: ServiceResponse) -> ServiceFuture:
        """A fresh, already-resolved future answering from ``response``."""
        ticket = self._next_ticket
        self._next_ticket += 1
        self._stats.requests += 1
        self._stats.dedup_hits += 1
        future = ServiceFuture(ticket)
        future._resolve(ServiceResponse(ticket, response.result, response.report))
        return future

    def _dedup_submit_locked(self, dkey: str) -> "ServiceFuture | None":
        """Submit-time dedup: serve from the response store, or coalesce
        onto a pending identical request. None = no hit, enqueue normally."""
        hit = self._dedup_store.get(dkey)
        if hit is not None:
            self._dedup_store.move_to_end(dkey)
            return self._dedup_serve_locked(hit)
        prim = self._dedup_pending.get(dkey)
        if prim is None:
            return None
        if prim.future.done():
            # primary finished between resolving its future and its locked
            # bookkeeping; serve from its response if it has one
            resp = prim.future._response
            return None if resp is None else self._dedup_serve_locked(resp)
        ticket = self._next_ticket
        self._next_ticket += 1
        future = ServiceFuture(ticket)
        prim.waiters.append((ticket, future))
        self._live[ticket] = future
        return future

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "EngineService":
        """Spawn the execution plane (scheduler + executor pool); subsequent
        ``submit()`` calls return futures. Restartable after ``stop()``."""
        with self._lock:
            if self._running:
                raise RuntimeError("service already started")
            if self._pending:
                raise RuntimeError("drain() pending batch-mode requests before start()")
            self._running = True
            self._stopping = False
            self._sched_done = False
            self._cancel_queued = False
            self._n_workers = self._resolve_workers()
            n = self._n_workers
            self._pool_queues = [[] for _ in range(n)]
            self._pool_current = [None] * n
            while len(self._worker_spans) < n:
                self._worker_spans.append([])
                self._worker_busy.append(0.0)
                self._worker_reqs.append(0)
                self._worker_steal_counts.append(0)
            self._threads = [
                threading.Thread(
                    target=self._scheduler_loop, name="engine-service-scheduler", daemon=True
                )
            ] + [
                threading.Thread(
                    target=self._worker_loop, args=(w,), name=f"engine-service-exec-{w}",
                    daemon=True,
                )
                for w in range(n)
            ]
            threads = list(self._threads)
        for t in threads:
            t.start()
        return self

    def stop(self, drain: bool = True, timeout: "float | None" = None) -> None:
        """Graceful shutdown. ``drain=True`` serves everything already
        admitted first; ``drain=False`` cancels still-queued requests — in
        the admission queue, in every worker's group queue, *and* in the
        scheduler's not-yet-compiled snapshot — along with their coalesced
        waiters (the futures raise :class:`ServiceStopped`; groups already
        compiled or handed to a worker complete). After the pool joins, a
        final sweep rejects any future that somehow survived, so every
        submitted future terminates. Idempotent; ``start()`` again to
        restart. If ``timeout`` expires with workers still running, raises
        TimeoutError and leaves the service stopping — call ``stop()``
        again."""
        with self._lock:
            if not self._running:
                return
            self._stopping = True
            if not drain:
                self._cancel_queued = True
                while self._queue:
                    self._cancel_item_locked(self._queue.popleft())
                for q in self._pool_queues:
                    for group in q:
                        while group.items:
                            self._cancel_item_locked(group.items.popleft())
                    q.clear()
                self._idle.notify_all()
                self._pool_space.notify_all()
            self._work.notify_all()
            self._space.notify_all()
            self._pool_work.notify_all()
            threads = list(self._threads)
        for t in threads:
            t.join(timeout)
        alive = [t.name for t in threads if t.is_alive()]
        if alive:
            # a later start() must not spawn a second pipeline racing this one
            raise TimeoutError(
                f"stop() timed out with worker thread(s) still running: {alive}; call stop() again"
            )
        with self._lock:
            self._running = False
            self._threads = []
            # with the plane shut down, any future neither resolved nor
            # cancelled is stranded forever — reject it now
            leaked = [f for f in self._live.values() if not f.done()]
            for fut in leaked:
                fut._reject(ServiceStopped("service stopped with this request unresolved"))
                self._stats.cancelled += 1
            self._live.clear()
            self._dedup_pending.clear()
            if leaked:
                self._inflight = 0
                self._idle.notify_all()
            # _stopping stays True: submit() after stop raises ServiceStopped
            # until start() is called again.

    def __enter__(self) -> "EngineService":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()

    def flush(self, timeout: "float | None" = None) -> None:
        """Block until every admitted worker-loop request has resolved."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._queue or self._inflight:
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError("flush timed out with work still in flight")
                self._idle.wait(timeout=0.1)

    # -- the execution plane ---------------------------------------------------

    def _scheduler_loop(self) -> None:
        """The plane's single compile stage: snapshot the queue, schedule
        plan-key groups by QoS, place each on a pool slot, run cold groups'
        first call, feed warm work to the executor workers."""
        try:
            while True:
                with self._lock:
                    while not self._queue and not self._stopping:
                        self._work.wait(timeout=0.1)
                    if not self._queue:
                        if self._stopping:
                            break
                        continue
                if self.batch_window > 0:
                    time.sleep(self.batch_window)  # let the burst accumulate
                with self._lock:
                    snapshot = list(self._queue)
                    self._queue.clear()
                    self._space.notify_all()
                try:
                    dispatched: set[int] = set()
                    for items in self._plan_groups(snapshot, channel=_COMPILE_CHANNEL):
                        with self._lock:
                            # stop(drain=False) after the snapshot was taken:
                            # groups not yet compiled or handed to a worker
                            # cancel like still-queued requests do
                            if self._cancel_queued:
                                for item in items:
                                    if not item.future.done():
                                        self._cancel_item_locked(item)
                                        dispatched.add(id(item))
                                self._idle.notify_all()
                                continue
                        group = self._place_group(items)
                        if group is None:
                            continue
                        with self._lock:
                            self._stats.batches += 1
                        if not self.cache.is_warm(group.key):
                            first = group.items.popleft()
                            dispatched.add(id(first))
                            self._compile_item(first, group.slot)
                        if group.items:
                            dispatched.update(id(it) for it in group.items)
                            self._dispatch_group(group)
                except Exception as exc:
                    # defensive: a scheduler bug must not strand futures —
                    # reject the snapshot's undispatched requests (the
                    # executor pool owns the dispatched ones) and keep going
                    for item in snapshot:
                        if id(item) not in dispatched and not item.future.done():
                            self._finish_error(item, exc)
        finally:
            with self._lock:
                self._sched_done = True
                self._pool_work.notify_all()

    def _place_group(self, items: "list[_WorkItem]") -> "_Group | None":
        """Placement: resolve the group's slot (pinned key > cache pin >
        round-robin on "affinity" substrates, round-robin on "spread" ones)
        and, when the substrate carves per-slot variants, rebuild the
        members' plan against the slot's variant."""
        if not items:
            return None
        first = items[0]
        base_sub = first.request.substrate
        bkey = first.plan.key if first.plan.key is not None else ("__unkeyed__", first.request.ticket)
        n = self._n_workers
        slot = 0
        affinity = base_sub.placement_policy == "affinity"
        if n > 1:
            if affinity:
                # sticky: a key re-routes to the slot that compiled it
                slot = self._pins.get(bkey)
                if slot is None:
                    slot = self.cache.slot_of(first.plan.key)
                if slot is None:
                    slot = self._rr_next % n
                    self._rr_next += 1
                slot %= n
                self._pins[bkey] = slot
                self._pins.move_to_end(bkey)
                while len(self._pins) > _PIN_TABLE_MAX:
                    self._pins.popitem(last=False)
                self.cache.pin_key(first.plan.key, slot)
            else:
                # spread: plain round-robin; stealing rebalances the rest
                slot = self._rr_next % n
                self._rr_next += 1
            variant = base_sub.placement_variant(slot, n)
            if variant is not base_sub:
                # one rebuild per group: members share an identity plan
                try:
                    with self._on_channel(variant, _COMPILE_CHANNEL) as stream:
                        plan = build_plan(first.op, first.request.inputs, first.plan.strategy,
                                          variant)
                        ready = self._record(stream)
                except Exception as exc:  # placement failures reject the group
                    for item in items:
                        self._finish_error(item, exc)
                    return None
                for item in items:
                    item.plan = plan
                    if ready is not None:
                        item.ready = ready
        return _Group(
            key=items[0].plan.key,
            qos=self._effective_qos(items[0]),
            first_ticket=items[0].request.ticket,
            slot=slot,
            stealable=not affinity,
            items=deque(items),
        )

    def _dispatch_group(self, group: _Group) -> None:
        """Hand a (now warm) group to its slot's queue, QoS-ordered. The
        plane holds at most ``pipeline_depth * workers`` queued groups in
        total (backpressure on the scheduler; a shared budget so dispatch
        to idle slots never blocks behind one hot slot's queue)."""
        with self._lock:
            while sum(len(q) for q in self._pool_queues) >= self.pipeline_depth * self._n_workers:
                self._pool_space.wait(timeout=0.1)
            q = self._pool_queues[group.slot]
            rank = (-group.qos, group.first_ticket)
            idx = len(q)
            for i, queued in enumerate(q):
                if (-queued.qos, queued.first_ticket) > rank:
                    idx = i
                    break
            q.insert(idx, group)
            self._pool_work.notify_all()

    def _worker_loop(self, w: int) -> None:
        """Executor worker ``w``: serve own queue in QoS order; steal from
        the busiest peer when idle (spread-policy groups only)."""
        while True:
            with self._lock:
                group = self._pop_group_locked(w)
                if group is None:
                    if self._sched_done and not any(self._pool_queues):
                        break
                    self._pool_work.wait(timeout=0.05)
                    continue
                self._pool_current[w] = group
                self._exec_trace.append((w, group.first_ticket, group.qos, group.stolen))
                self._pool_space.notify_all()
            t0 = time.perf_counter()
            served = 0
            while True:
                with self._lock:
                    if not group.items:
                        break
                    item = group.items.popleft()
                self._run_item(item, slot=w, channel=w)
                served += 1
            t1 = time.perf_counter()
            with self._lock:
                self._pool_current[w] = None
                if served:
                    self._worker_spans[w].append((t0, t1))
                    self._worker_busy[w] += t1 - t0
                    self._worker_reqs[w] += served
                    self._note_span_end_locked(t1)
                    self._maybe_fold_spans_locked()

    def _pop_group_locked(self, w: int) -> "_Group | None":
        """Own queue head, else steal. Stealing prefers whole queued groups
        from the most-loaded peer (tail = lowest priority, so the victim's
        QoS order is undisturbed); failing that, it splits the tail half of
        the largest in-progress stealable group (straggler relief)."""
        q = self._pool_queues[w]
        if q:
            return q.pop(0)
        if self._n_workers <= 1:
            return None
        victim, loaded = None, 0
        for v, vq in enumerate(self._pool_queues):
            if v == w:
                continue
            n_stealable = sum(1 for g in vq if g.stealable)
            if n_stealable > loaded:
                victim, loaded = v, n_stealable
        if victim is not None:
            vq = self._pool_queues[victim]
            for i in range(len(vq) - 1, -1, -1):
                if vq[i].stealable:
                    group = vq.pop(i)
                    group.slot = w
                    group.stolen = True
                    self._note_steal_locked(w)
                    return group
        # no queued group to take: split a straggler's remaining tail
        best = None
        for v, cur in enumerate(self._pool_current):
            if v == w or cur is None or not cur.stealable:
                continue
            if len(cur.items) >= 2 and (best is None or len(cur.items) > len(best.items)):
                best = cur
        if best is not None:
            stolen: deque[_WorkItem] = deque()
            for _ in range(len(best.items) // 2):
                stolen.appendleft(best.items.pop())
            self._note_steal_locked(w)
            return _Group(
                key=best.key, qos=best.qos, first_ticket=best.first_ticket, slot=w,
                stealable=True, stolen=True, items=stolen,
            )
        return None

    def _note_steal_locked(self, w: int) -> None:
        self._stats.steals += 1
        self._worker_steal_counts[w] += 1

    @staticmethod
    def _record(stream: "torch.cuda.Stream | None") -> "torch.cuda.Event | None":
        """An event at the current end of ``stream`` (None off the card)."""
        if stream is None:
            return None
        event = torch.cuda.Event()
        event.record(stream)
        return event

    def _plan_groups(
        self, items: "list[_WorkItem]", channel: Any = None
    ) -> "list[list[_WorkItem]]":
        """The scheduler: group requests by identity (op x inputs object x
        strategy x substrate x per-request qos), bind **one plan per group**
        shared by every member, and order groups by QoS weight (higher
        first) then arrival. Plans (and ``"auto"``'s pick) are built on
        ``channel``'s stream after the members' inputs are ready; the
        members' first launches wait for the end of that work."""
        groups: dict[Any, list[_WorkItem]] = {}
        order: list[Any] = []
        for item in items:
            req = item.request
            try:
                item.op = resolve_op(req.op)
            except Exception as exc:  # resolve failures reject that future only
                self._finish_error(item, exc)
                continue
            strategy = req.strategy
            strat_id = strategy.cache_key() if isinstance(strategy, MigratoryStrategy) else strategy
            gkey = (item.op.name, id(req.inputs), strat_id, id(req.substrate), req.qos)
            if gkey not in groups:
                order.append(gkey)
            groups.setdefault(gkey, []).append(item)
        out: list[list[_WorkItem]] = []
        for gkey in order:
            members = groups[gkey]
            first = members[0]
            req = first.request
            try:
                with self._on_channel(req.substrate, channel) as stream:
                    for member in members:
                        if stream is not None and member.ready is not None:
                            stream.wait_event(member.ready)
                    strategy = req.strategy
                    if isinstance(strategy, str) and strategy == "auto":
                        from .autotune import choose_strategy

                        strategy = choose_strategy(first.op, req.inputs, req.substrate)
                    plan = build_plan(first.op, req.inputs, strategy, req.substrate)
                    ready = self._record(stream)
            except Exception as exc:  # plan failures reject the identity group
                for member in members:
                    self._finish_error(member, exc)
                continue
            for member in members:
                member.op, member.plan = first.op, plan
                if ready is not None:
                    member.ready = ready
            out.append(members)
        return sorted(out, key=lambda g: (-self._effective_qos(g[0]), g[0].request.ticket))

    def _compile_item(self, item: _WorkItem, slot: int) -> None:
        """Plane compile stage: a cold group's first request runs its first
        call on the scheduler thread (and its stream) — pinning the entry to
        ``slot`` — while the pool executes other groups; the group's later
        members are cache hits by construction."""
        t0 = time.perf_counter()
        self._run_item(item, slot=slot, channel=_COMPILE_CHANNEL)
        t1 = time.perf_counter()
        with self._lock:
            self._compile_spans.append((t0, t1))
            self._note_span_end_locked(t1)
            self._maybe_fold_spans_locked()

    def _note_span_end_locked(self, t1: float) -> None:
        """Extend the wall window to the span end: _run_item stamped _t_last
        before the span closed, and busy (span union) must stay <= wall."""
        if self._t_last is None or t1 > self._t_last:
            self._t_last = t1

    _SPAN_FOLD_THRESHOLD = 8192

    def _maybe_fold_spans_locked(self) -> None:
        """Fold recorded spans into scalar accumulators once the buffers grow
        large, bounding memory and stats() cost for long-lived services (at
        the cost of ignoring overlap straddling a fold boundary)."""
        n_spans = len(self._compile_spans) + sum(len(spans) for spans in self._worker_spans)
        if n_spans <= self._SPAN_FOLD_THRESHOLD:
            return
        all_exec = [s for spans in self._worker_spans for s in spans]
        self._overlap_acc += _intersection_seconds(self._compile_spans, _merge_spans(all_exec))
        self._busy_acc += _union_seconds(self._compile_spans + all_exec)
        self._compile_busy_acc += sum(t1 - t0 for t0, t1 in self._compile_spans)
        self._compile_spans.clear()
        for spans in self._worker_spans:
            spans.clear()

    def _run_item(self, item: _WorkItem, slot: "int | None" = None, channel: Any = None) -> None:
        """Serve one item on ``channel``'s stream (None: the caller's own,
        batch mode): dedup and deadline checks, the single call, and the
        future resolved only once that stream has finished the call."""
        t0 = time.perf_counter()
        if item.dedup_key is not None and self._try_serve_dedup(item):
            return
        if self._shed_if_expired(item, t0):
            return
        rid = ("ticket", item.request.ticket)
        try:
            with trace.request("service.execute", rid), \
                    self._on_channel(item.request.substrate, channel) as stream:
                if stream is not None and item.ready is not None:
                    stream.wait_event(item.ready)
                result, report = single_call(item.plan, item.op, cache=self.cache, slot=slot)
                if stream is not None:
                    stream.synchronize()
        except Exception as exc:
            self._finish_error(item, exc)
            return
        t1 = time.perf_counter()
        with trace.request("service.handoff", rid):
            response = ServiceResponse(item.request.ticket, result, report)
            item.future._resolve(response)
            with self._lock:
                self._live.pop(item.request.ticket, None)
                if item.dedup_key is not None:
                    self._dedup_store[item.dedup_key] = response
                    self._dedup_store.move_to_end(item.dedup_key)
                    while len(self._dedup_store) > self.dedup_max_entries:
                        self._dedup_store.popitem(last=False)
                    if self._dedup_pending.get(item.dedup_key) is item:
                        del self._dedup_pending[item.dedup_key]
                self._resolve_waiters_locked(item, response)
                if item.request.t_admit:
                    self._queue_waits.append(max(0.0, t0 - item.request.t_admit))
                    total = max(0.0, t1 - item.request.t_admit)
                    self._total_latencies.append(total)
                    if self.slo_target_seconds is not None:
                        self._stats.slo_checked += 1
                        if total > self.slo_target_seconds:
                            self._stats.slo_violations += 1
                self._service_times.append(t1 - t0)
                self._account_locked(report)
                self._finish_locked()

    def _resolve_waiters_locked(self, item: _WorkItem, response: ServiceResponse) -> None:
        """Answer every coalesced duplicate with the primary's response
        (fresh ticket, shared result/report) — the in-flight dedup hit."""
        for ticket, fut in item.waiters:
            fut._resolve(ServiceResponse(ticket, response.result, response.report))
            self._live.pop(ticket, None)
            self._stats.requests += 1
            self._stats.dedup_hits += 1
            self._stats.dedup_coalesced += 1
        item.waiters.clear()

    def _drop_pending_locked(self, item: _WorkItem) -> None:
        self._live.pop(item.request.ticket, None)
        if item.dedup_key is not None and self._dedup_pending.get(item.dedup_key) is item:
            del self._dedup_pending[item.dedup_key]

    def _try_serve_dedup(self, item: _WorkItem) -> bool:
        """Late dedup check (drain loop / pipeline stages): answer from the
        response store if an identical request completed since admission.
        Returns True when the item was served."""
        with self._lock:
            hit = self._dedup_store.get(item.dedup_key)
            if hit is None:
                return False
            self._dedup_store.move_to_end(item.dedup_key)
            self._stats.requests += 1
            self._stats.dedup_hits += 1
            response = ServiceResponse(item.request.ticket, hit.result, hit.report)
            item.future._resolve(response)
            self._drop_pending_locked(item)
            self._resolve_waiters_locked(item, response)
            self._finish_locked()
            return True

    def _fail_locked(self, item: _WorkItem, exc: BaseException, counter: str) -> None:
        """Reject ``item`` and its coalesced waiters with ``exc``, counting
        each in ``ServiceStats.<counter>``."""
        item.future._reject(exc)
        self._drop_pending_locked(item)
        for ticket, fut in item.waiters:
            fut._reject(exc)
            self._live.pop(ticket, None)
        n = 1 + len(item.waiters)
        item.waiters.clear()
        setattr(self._stats, counter, getattr(self._stats, counter) + n)

    def _shed_if_expired(self, item: _WorkItem, now: float) -> bool:
        """Deadline shedding: a request whose ``Request.timeout`` elapsed
        while it sat in the queue is dropped instead of run — its future
        (and any coalesced waiters') raises :class:`ServiceTimeout`, counted
        in ``ServiceStats.timed_out``. Returns True when the item was shed."""
        timeout = item.request.timeout
        if timeout is None or not item.request.t_admit:
            return False
        waited = now - item.request.t_admit
        if waited <= timeout:
            return False
        exc = ServiceTimeout(
            f"request {item.request.ticket} shed: queued {waited:.3f}s past "
            f"its {timeout:.3f}s deadline"
        )
        with self._lock:
            self._fail_locked(item, exc, "timed_out")
            self._finish_locked()
        return True

    def _finish_error(self, item: _WorkItem, exc: BaseException) -> None:
        # coalesced duplicates asked for the same computation: it failed
        with self._lock:
            self._fail_locked(item, exc, "errors")
            self._finish_locked()

    def _cancel_item_locked(self, item: _WorkItem) -> None:
        """Reject a still-queued item (and its coalesced waiters) with
        ServiceStopped — the stop(drain=False) path."""
        self._fail_locked(item, ServiceStopped("service stopped before this request ran"),
                          "cancelled")
        self._inflight -= 1

    def _finish_locked(self) -> None:
        self._inflight -= 1
        self._t_last = time.perf_counter()
        self._idle.notify_all()

    def _account_locked(self, report: RunReport) -> None:
        self._stats.requests += 1
        self._stats.cache_hits += int(report.cache_hit)
        self._stats.compiles += int(not report.cache_hit)
        self._stats.compile_seconds += report.compile_seconds
        # a cold request's single timed call IS the compile call;
        # count only its steady-state remainder as run time
        self._stats.run_seconds += report.seconds - report.compile_seconds

    # -- batch mode ------------------------------------------------------------

    def drain(self) -> "list[ServiceResponse]":
        """Batch mode: run every pending request in the calling thread (on
        its current stream), batching same-plan-key requests so each batch
        compiles at most once. Responses in submission order. In worker-loop
        mode use the futures (or ``flush()``) instead."""
        with self._lock:
            if self._running:
                raise RuntimeError(
                    "drain() is the batch-mode API; the worker loop is running — "
                    "use the futures returned by submit(), or flush()"
                )
            pending, self._pending = self._pending, []
        if not pending:
            return []
        t_wall = time.perf_counter()
        items = [
            _WorkItem(
                req,
                ServiceFuture(req.ticket),
                dedup_key=(
                    _content_hash(req.op, req.inputs, req.strategy, req.substrate)
                    if self.dedup
                    else None
                ),
            )
            for req in pending
        ]
        with self._lock:
            self._inflight += len(items)  # balanced by _finish_locked per item
        try:
            groups = self._plan_groups(items)
            # fail fast: a plan that would not bind raises before any group
            # spends compile/execute time
            bad = next((i for i in items if i.future._exception is not None), None)
            if bad is not None:
                raise bad.future._exception
            responses: list[ServiceResponse] = []
            for group in groups:
                with self._lock:
                    self._stats.batches += 1
                for item in group:
                    self._run_item(item)
                    if item.future._exception is not None:
                        raise item.future._exception
                    responses.append(item.future._response)
        finally:
            with self._lock:
                # items skipped by a fail-fast raise never reached
                # _finish_locked; balance their admission count
                for item in items:
                    if not item.future.done():
                        self._inflight -= 1
                self._stats.drains += 1
                self._drain_wall += time.perf_counter() - t_wall
        responses.sort(key=lambda r: r.ticket)
        return responses

    # -- reporting -------------------------------------------------------------

    def stats(self) -> ServiceStats:
        """A snapshot of the aggregate counters with the timing/overlap
        fields recomputed from the recorded stage spans and the per-worker
        columns attached (see :class:`ServiceStats`). Each call returns a
        fresh object."""
        with self._lock:
            worker_wall = (
                self._t_last - self._t_first
                if self._t_first is not None and self._t_last is not None
                else 0.0
            )
            all_exec = [s for spans in self._worker_spans for s in spans]
            overlap_seconds = self._overlap_acc + _intersection_seconds(
                self._compile_spans, _merge_spans(all_exec)
            )
            compile_busy = self._compile_busy_acc + sum(t1 - t0 for t0, t1 in self._compile_spans)
            waits = list(self._queue_waits)  # copy only; sort off-lock
            services = list(self._service_times)
            totals = list(self._total_latencies)
            # every slot ever used, not just the current width: a restart
            # with a narrower pool keeps its per-worker counters
            busy = list(self._worker_busy)
            reqs = list(self._worker_reqs)
            steals = list(self._worker_steal_counts)
            window = max(0.0, worker_wall)
            occupancy = [b / window if window > 0 else 0.0 for b in busy]
            if occupancy:
                self._occ_hwm = max(self._occ_hwm, max(occupancy))
            snapshot = dataclasses.replace(
                self._stats,
                wall_seconds=self._drain_wall + window,
                busy_seconds=(
                    self._drain_wall + self._busy_acc
                    + _union_seconds(self._compile_spans + all_exec)
                ),
                overlap_seconds=overlap_seconds,
                overlap_ratio=overlap_seconds / compile_busy if compile_busy > 0 else 0.0,
                workers=self._n_workers,
                worker_busy_seconds=busy,
                worker_requests=reqs,
                worker_steals=steals,
                worker_occupancy=occupancy,
                occupancy_hwm=self._occ_hwm,
                slo_target_seconds=self.slo_target_seconds,
            )
        for samples, prefix in ((waits, "queue_wait"), (services, "service"), (totals, "total")):
            samples.sort()
            for q in (50, 95, 99):
                setattr(snapshot, f"{prefix}_p{q}", _percentile(samples, q / 100))
        return snapshot

    def throughput_report(self) -> dict[str, Any]:
        """Aggregate record: service counters + plan-cache health."""
        return {**self.stats().to_dict(), "cache": self.cache.stats()}
