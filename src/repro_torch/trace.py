"""Spans and counters inside the port: where a request's host time goes
and how often it waits for the card.

    with trace.request("engine.run"):        # the root: a new request id
        with trace.span("engine.plan"):
            ...
        trace.count("sync.block")            # a host read of a card value

**Off** (no ``torch.profiler`` session and no :func:`enable`), :func:`span`
and :func:`request` hand back one shared no-op context, and nothing is
recorded: a flag test and two empty calls. **On**, a span opens
``torch._C._profiler._RecordFunctionFast(name)``, so it shows in the
profiler's timeline as a ``cpu_op`` on the trace's own clock (never a
``user_annotation``, which Kineto shadows on the device and a device-time
reader would count as work), and on closing appends one record to a bounded
in-memory store: name, request id, span id, parent span id, start and end as
``time.perf_counter_ns()``. Under :func:`enable` without a profiler, spans go
to the store only.

Spans of one request share its id: :func:`request` opens a request's root
span, allocating the id (``engine.run``) or taking the caller's (the serving
plane passes ``("ticket", n)``, the request's ticket); a thread-local stack
gives every span its parent.

:func:`count` charges an increment to the traced request open on the
calling thread, under the module's one lock, so a reader gets exact
per-request counts of the traced part alone; with no traced request open it
returns at once and keeps nothing. The same lock guards the kernels' launch
counts (:func:`count_launch`), which stay the wrappers' ``.launches``.

Counters on the engine path:

- ``sync.<site>``: a place where the host waits for a card value
  (``sync.block``: the runner's stream synchronize; ``sync.bfs_frontier``:
  the host round loop's frontier test; ``sync.bfs_root``: the two stores of
  the root into the host round loop's state (a search on the card, one
  ``bfs.search`` span, charges neither); ``sync.spmv_nnz``: SpMV's non-zero
  count; ``sync.bfs_reached``: BFS's reached count; ``sync.bfs_replay``: the
  traffic replay's host copy of the graph, on a memo miss). A site counts
  each pass, also where the value lies on the host.
- ``memo.hit.<kind>``, ``memo.miss.<kind>``: the ops' derived-stats memo.

:func:`enable`, :func:`disable`, :func:`snapshot` and :func:`reset` are for
an operator who wants the store without a profiler; the profiler's own trace
already exports the spans.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any

import torch.autograd.profiler as _profiler

try:
    from torch._C._profiler import _RecordFunctionFast as _FAST
except ImportError:  # an older torch: spans go to the store only
    _FAST = None

STORE_MAX = 1 << 18  # span records kept (oldest dropped first)
REQUESTS_MAX = 1 << 16  # requests whose charged counts are kept

_LOCK = threading.Lock()
_enabled = False
_spans: "collections.deque[tuple]" = collections.deque(maxlen=STORE_MAX)
_charged: "collections.OrderedDict[Any, dict[str, int]]" = collections.OrderedDict()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)


class _Local(threading.local):
    """A thread's open spans (ids, innermost last) and its request id."""

    def __init__(self):
        self.stack: "list[int]" = []
        self.rid: Any = None


_tls = _Local()


class _Off:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """A recording span; with a ``rid``, the root of that request."""

    __slots__ = ("name", "rid", "id", "parent", "prev_rid", "t0", "rf")

    def __init__(self, name: str, rid: Any = None):
        self.name, self.rid, self.rf = name, rid, None

    def __enter__(self):
        tls = _tls
        stack = tls.stack
        self.parent = stack[-1] if stack else None
        self.id = next(_span_ids)
        stack.append(self.id)
        self.prev_rid = tls.rid
        if self.rid is not None:
            tls.rid = self.rid
        else:
            self.rid = self.prev_rid
        if _FAST is not None and _profiler._is_profiler_enabled:
            self.rf = _FAST(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        tls = _tls
        tls.stack.pop()
        tls.rid = self.prev_rid
        with _LOCK:
            _spans.append((self.name, self.rid, self.id, self.parent, self.t0, t1))
        return False


def span(name: str):
    """A span inside the current request (or outside any, with request id
    None): a context manager, the shared no-op one while off."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def request(name: str, rid: Any = None):
    """The root span of a request: spans and counts inside it take ``rid``,
    a new id when None. The no-op span while off."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, next(_request_ids) if rid is None else rid)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open traced request's count of ``name``; nothing
    outside a traced request."""
    rid = _tls.rid
    if rid is None:
        return
    with _LOCK:
        mine = _charged.get(rid)
        if mine is None:
            mine = _charged[rid] = {}
            if len(_charged) > REQUESTS_MAX:
                _charged.popitem(last=False)
        mine[name] = mine.get(name, 0) + n


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the kernel's launch count, under the
    module's lock: the service's pool workers launch the same kernel from
    several threads, and ``+= 1`` on an attribute is a read-modify-write."""
    with _LOCK:
        wrapper.launches += 1


def enable() -> None:
    """Record spans without a profiler session."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def snapshot() -> dict:
    """What the store holds: ``spans`` (dicts, in the order they closed) and
    ``requests`` (each traced request's charged counts)."""
    with _LOCK:
        spans = [
            {"name": n, "request": r, "id": i, "parent": p, "t0_ns": t0, "t1_ns": t1}
            for n, r, i, p, t0, t1 in _spans
        ]
        return {
            "spans": spans,
            "requests": {rid: dict(c) for rid, c in _charged.items()},
        }


def reset() -> None:
    """Empty the store and the requests' charged counts (launch counts stay
    the wrappers')."""
    with _LOCK:
        _spans.clear()
        _charged.clear()
