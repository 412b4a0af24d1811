"""Plan cache: keep an executor per plan key and reuse it for every later
plan with the same shape/dtype/strategy/substrate signature.

PyTorch runs eagerly, so nothing is traced or compiled here: the cached
executor is the plan's own callable. An entry counts as *compiled* once its
first call completed; that call (which builds a CUDA kernel the first time
the process launches it) is what the runner reports as ``compile_seconds``.
A later plan with the same key is a *hit* and reports
``cache_hit=True, compile_seconds=0.0``.

Caching an executor closure is sound because
:func:`~repro_torch.engine.api.plan_key` pins everything the closure
captures: the op, the substrate fingerprint, every strategy axis, the op's
static scalars, and the argument signature. The cache is thread-safe; only
the bookkeeping is taken under its lock, never an executor call.

**Placement pinning** (the service's executor pool): an entry remembers the
pool slot that first resolved it (``CacheEntry.slot``). The service's
scheduler routes a plan-key group back to its pinned slot on substrates
with the ``"affinity"`` placement policy; a work-steal *executes* a warm
entry from another worker but never re-pins it. The CUDA stream a slot
runs on is an execution channel, not cached state, so it is not part of
the entry or its key.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Any, Callable

from .api import ExecutionPlan


@dataclasses.dataclass
class CacheEntry:
    """One cached executor + its first-call accounting."""

    executor: Callable[..., Any]
    compiled: bool = False  # first call completed
    compile_seconds: float = 0.0
    slot: int | None = None  # executor-pool placement pin (None = unpinned)


@dataclasses.dataclass
class CompiledPlan:
    """A plan resolved through the cache, ready to execute.

    ``cache_hit`` is True iff an executor that already completed its first
    call was reused — the run will be pure steady state.
    """

    plan: ExecutionPlan
    executor: Callable[..., Any]
    cache_hit: bool
    entry: CacheEntry | None

    def __call__(self) -> Any:
        return self.executor(*self.plan.args)


class PlanCache:
    """LRU cache of executors keyed by ``ExecutionPlan.key``."""

    # placement pins for keys whose entries live under another key (a
    # substrate whose per-slot variants change the fingerprint); bounded
    # apart from the entry table
    _PIN_ALIAS_MAX = 4096

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._entries: collections.OrderedDict[tuple, CacheEntry] = collections.OrderedDict()
        self._key_pins: collections.OrderedDict[tuple, int] = collections.OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.uncacheable = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __bool__(self) -> bool:
        return True  # an empty cache is still a cache, not a None stand-in

    def get(self, plan: ExecutionPlan, *, slot: "int | None" = None) -> CompiledPlan:
        """Resolve a plan's executor; keyless plans bypass the cache.
        ``slot`` tags the entry with the executor-pool slot on its first
        resolution; later resolutions never move the pin."""
        with self._lock:
            if plan.key is None:
                self.uncacheable += 1
                return CompiledPlan(plan, plan.executor, cache_hit=False, entry=None)
            entry = self._entries.get(plan.key)
            if entry is not None:
                self._entries.move_to_end(plan.key)
                if slot is not None and entry.slot is None:
                    entry.slot = slot  # adopt: e.g. batch-run, pool-served
                if entry.compiled:
                    self.hits += 1
                    return CompiledPlan(plan, entry.executor, cache_hit=True, entry=entry)
                # entry exists but its first call never completed: still cold
                self.misses += 1
                return CompiledPlan(plan, entry.executor, cache_hit=False, entry=entry)
            entry = CacheEntry(executor=plan.executor, slot=slot)
            self._entries[plan.key] = entry
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
            self.misses += 1
            return CompiledPlan(plan, entry.executor, cache_hit=False, entry=entry)

    def note_compiled(self, compiled: CompiledPlan, seconds: float) -> None:
        """Record the timed first call of a miss."""
        with self._lock:
            if compiled.entry is not None and not compiled.entry.compiled:
                compiled.entry.compiled = True
                compiled.entry.compile_seconds = seconds

    def is_warm(self, key: "tuple | None") -> bool:
        """True iff ``key`` resolves to an executor whose first call
        already completed."""
        if key is None:
            return False
        with self._lock:
            entry = self._entries.get(key)
            return entry is not None and entry.compiled

    def pin_key(self, key: "tuple | None", slot: int) -> None:
        """Pin a *key* to a slot without requiring an entry under it (a
        base plan key whose entry is stored under a slot-variant key), so
        affinity survives the service's own pin table. First pin wins."""
        if key is None:
            return
        with self._lock:
            if key not in self._key_pins:
                self._key_pins[key] = slot
                while len(self._key_pins) > self._PIN_ALIAS_MAX:
                    self._key_pins.popitem(last=False)

    def slot_of(self, key: "tuple | None") -> "int | None":
        """The executor-pool slot pinned at first resolution (None =
        unpinned); falls back to the :meth:`pin_key` alias table."""
        if key is None:
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.slot is not None:
                return entry.slot
            return self._key_pins.get(key)

    def stats(self) -> dict[str, Any]:
        """Aggregate counters — the cache health record."""
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "uncacheable": self.uncacheable,
                "hit_rate": self.hits / lookups if lookups else 0.0,
                "compile_seconds_total": sum(e.compile_seconds for e in self._entries.values()),
                "pinned": sum(1 for e in self._entries.values() if e.slot is not None),
            }

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._key_pins.clear()
            self.hits = self.misses = self.uncacheable = 0


_DEFAULT_CACHE = PlanCache()


def default_cache() -> PlanCache:
    """The process-wide cache ``engine.run`` uses when none is passed."""
    return _DEFAULT_CACHE
