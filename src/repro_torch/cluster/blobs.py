"""Content-addressed blob store for the cluster data plane.

Move the lightweight context (the request envelope) to where the bulk data
already lives, never the bulk data itself. Large arrays are addressed by
the sha256 of their canonical wire bytes
(:func:`repro_torch.engine.wire.content_digest`, the identity the dedup
cache hashes and the JAX package's cluster addresses blobs by), shipped to
a worker **once** as a ``put_blob`` frame, and referenced thereafter as
``{"__wire__": "blobref", "digest": ...}``: steady-state serving moves the
small per-request arrays, not the matrices and graphs the worker already
holds.

Both ends hold a :class:`BlobStore`, a byte-budgeted LRU of tensors on one
device:

- the **worker's** store lives on the worker's device (the card): each
  blob is verified on its host bytes, then copied there once, so a request
  that references it decodes without moving bulk data. On a miss (evicted,
  or a coordinator's stale belief) the worker sends ``need_blob`` and
  blocks that request in :meth:`BlobStore.ensure` until the blob is
  re-shipped, or the coordinator answers ``blob_gone``, which tombstones
  the digest and fails the request instead of hanging it. The tombstone is
  *transient*: it fails the waits that saw it and is cleared, so a later
  submit (which re-pins the blob coordinator-side) can re-fetch it. A blob
  whose frame has arrived but is still being verified is *expected*: a wait
  for it does not ask again.
- the **coordinator's** store (on the CPU) keeps recently shipped blobs for
  ``need_blob`` re-fetches and failover re-shipping (in-flight requests
  also pin their blobs on the ``_Inflight`` entry, so a retry can re-ship
  even past the store's eviction).

Every entry is the store's own copy: a caller may write its tensor after
``put`` without changing the stored bytes. Entries are shared by every
request that resolves their digest, and no op writes its inputs.

Budgets and thresholds (env-overridable, read at store or coordinator
creation):

- ``REPRO_BLOB_MIN_BYTES`` (default 64 KiB): arrays below this ride the
  frame inline as ``ndref`` segments; blob bookkeeping pays off only when
  re-shipping would hurt.
- ``REPRO_BLOB_BUDGET_BYTES`` (default 256 MiB): per-store LRU byte budget.
  A single blob larger than the budget is still admitted alone (refusing
  it would deadlock the request that needs it).
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch

from ..engine.wire import array_digest

DEFAULT_BLOB_MIN_BYTES = 64 << 10
DEFAULT_BLOB_BUDGET_BYTES = 256 << 20


def _env_bytes(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return max(1, int(raw))
    except ValueError:
        return default


def blob_min_bytes_default() -> int:
    """Arrays at/above this many bytes become blobrefs (coordinator side)."""
    return _env_bytes("REPRO_BLOB_MIN_BYTES", DEFAULT_BLOB_MIN_BYTES)


def blob_budget_bytes_default() -> int:
    """Per-store LRU byte budget."""
    return _env_bytes("REPRO_BLOB_BUDGET_BYTES", DEFAULT_BLOB_BUDGET_BYTES)


def blob_digest(array: Any) -> str:
    """Content address of one tensor or array: :func:`content_digest` of its
    canonical wire form (dtype/shape-aware and bit-exact, so two arrays
    share a digest iff they are the same tensor), computed in steps by
    :func:`~repro_torch.engine.wire.array_digest`."""
    return array_digest(array)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class BlobError(RuntimeError):
    """A blob the data plane needs cannot be produced."""


class BlobDigestMismatch(BlobError):
    """A shipped blob's bytes do not hash to its claimed digest."""


class BlobMissing(BlobError):
    """A blobref resolved against a store that does not hold the digest."""

    def __init__(self, digest: str):
        super().__init__(f"blob {digest} is not in the store")
        self.digest = digest


class BlobStore:
    """Byte-budgeted LRU of content-addressed tensors on ``device``, with
    waiter support.

    Thread-safe. ``put`` verifies the digest by default on the host bytes (a
    worker must refuse corrupt shipments: :class:`BlobDigestMismatch`),
    stores its own copy on ``device``, and wakes any :meth:`ensure`
    waiters. Eviction is LRU by last ``get``/``resolve``/``put`` touch, down
    to the byte budget.
    """

    def __init__(self, budget_bytes: "int | None" = None, device: "str | torch.device" = "cpu"):
        self.budget_bytes = (
            blob_budget_bytes_default() if budget_bytes is None else int(budget_bytes)
        )
        self.device = torch.device(device)
        self._cond = threading.Condition()
        self._entries: "OrderedDict[str, torch.Tensor]" = OrderedDict()
        self._gone: "set[str]" = set()  # coordinator said blob_gone
        self._expected: "set[str]" = set()  # arrived, being verified
        self.bytes_stored = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserted = 0
        # the largest blob verified so far: its bytes and its verify seconds
        self.largest_verified_bytes = 0
        self.largest_verify_seconds = 0.0

    def __contains__(self, digest: str) -> bool:
        with self._cond:
            return digest in self._entries

    def __len__(self) -> int:
        with self._cond:
            return len(self._entries)

    def get(self, digest: str) -> "torch.Tensor | None":
        """The stored tensor (LRU-touched) or None. Does not count stats —
        use :meth:`resolve` on the decode path."""
        with self._cond:
            t = self._entries.get(digest)
            if t is not None:
                self._entries.move_to_end(digest)
            return t

    def resolve(self, digest: str) -> torch.Tensor:
        """Decode-path lookup: the tensor, or :class:`BlobMissing`."""
        with self._cond:
            t = self._entries.get(digest)
            if t is None:
                raise BlobMissing(digest)
            self._entries.move_to_end(digest)
            self.hits += 1
            return t

    def put(self, digest: str, array: Any, *, verify: bool = True) -> torch.Tensor:
        """Admit one blob (a tensor on any device, or an array-like); evict
        LRU entries past the byte budget. With ``verify`` (the worker-side
        default) the host bytes must hash back to ``digest`` before anything
        is copied to ``device``: a mismatched shipment is refused, never
        stored. Returns the stored tensor."""
        if verify:
            t0 = time.perf_counter()
            actual = blob_digest(array)
            seconds = time.perf_counter() - t0
            if actual != digest:
                self.expect_failed(digest)
                raise BlobDigestMismatch(
                    f"blob claimed digest {digest} but its bytes hash to "
                    f"{actual}; refusing the shipment"
                )
        with self._cond:
            existing = self._entries.get(digest)
            if existing is not None:
                self._gone.discard(digest)
                self._expected.discard(digest)
                self._entries.move_to_end(digest)
                self._cond.notify_all()
                return existing
        src = array.detach() if isinstance(array, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(np.asarray(array)))
        stored = src.to(self.device, copy=True).contiguous()
        if stored.is_cuda:
            # the copy is queued on this thread's stream; a request that
            # resolves the blob may run on another
            torch.cuda.current_stream(stored.device).synchronize()
        with self._cond:
            if verify and _nbytes(stored) >= self.largest_verified_bytes:
                self.largest_verified_bytes = _nbytes(stored)
                self.largest_verify_seconds = seconds
            self._gone.discard(digest)
            self._expected.discard(digest)
            if digest in self._entries:
                self._entries.move_to_end(digest)
                self._cond.notify_all()
                return self._entries[digest]
            self._entries[digest] = stored
            self.bytes_stored += _nbytes(stored)
            self.inserted += 1
            # a single over-budget blob stays (alone); everything else LRUs out
            while self.bytes_stored > self.budget_bytes and len(self._entries) > 1:
                _old_digest, old = self._entries.popitem(last=False)
                self.bytes_stored -= _nbytes(old)
                self.evictions += 1
            self._cond.notify_all()
            return stored

    def expect(self, digest: str) -> None:
        """A ``put_blob`` frame for ``digest`` has arrived and is being
        verified off the reader thread: :meth:`ensure` waits for it instead
        of asking for it again."""
        with self._cond:
            self._expected.add(digest)

    def expect_failed(self, digest: str) -> None:
        """The expected blob was refused: waits may ask for it again."""
        with self._cond:
            self._expected.discard(digest)
            self._cond.notify_all()

    def mark_gone(self, digest: str) -> None:
        """The coordinator cannot produce this digest (``blob_gone``):
        tombstone it so :meth:`ensure` waiters fail instead of timing out."""
        with self._cond:
            self._gone.add(digest)
            self._cond.notify_all()

    def missing(self, digests: "list[str]") -> "list[str]":
        with self._cond:
            return [d for d in digests if d not in self._entries]

    def ensure(
        self,
        digests: "list[str]",
        request_missing: "Callable[[list[str]], None]",
        timeout: float = 60.0,
    ) -> None:
        """Block until every digest is present **simultaneously**. Missing
        digests that are not already arriving are asked for via
        ``request_missing`` (the worker's ``need_blob`` send); arrival of
        ``put_blob``/``blob_gone`` frames wakes the wait. A digest that was
        present (or even one that just arrived) can be LRU-evicted by
        another ``put`` before the full set is satisfied — such digests are
        **re-requested**, so the wait converges whenever the budget can hold
        the whole set at once (needed blobs land MRU; eviction eats the cold
        tail). Raises :class:`BlobError` on a tombstoned digest or
        timeout."""
        deadline = time.monotonic() + timeout
        requested: "set[str]" = set()  # asked for and not yet arrived
        while True:
            with self._cond:
                gone = [d for d in digests if d in self._gone]
                if gone:
                    # fail *this* wait, but clear the tombstone: blob_gone
                    # is a statement about the coordinator's store at one
                    # moment — a later submit re-pins the blob there, so a
                    # later ensure() must be allowed to re-ask
                    self._gone.difference_update(gone)
                    raise BlobError(
                        f"blob(s) {gone} are gone at the coordinator and "
                        "cannot be re-fetched"
                    )
                still = [d for d in digests if d not in self._entries]
                if not still:
                    return
                # an arrived-then-evicted digest leaves `requested` here,
                # making it re-askable below
                requested &= set(still)
                to_ask = [
                    d for d in still if d not in requested and d not in self._expected
                ]
                if to_ask:
                    self.misses += len(to_ask)
                    requested.update(to_ask)
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise BlobError(
                            f"timed out after {timeout:.0f}s waiting for "
                            f"blob(s) {still}"
                        )
                    self._cond.wait(remaining)
                    continue
            # outside the lock: request_missing sends on the wire, and the
            # thread that stores the answer needs the lock to put()
            request_missing(to_ask)

    def stats(self) -> "dict[str, Any]":
        with self._cond:
            return {
                "blobs": len(self._entries),
                "bytes_stored": self.bytes_stored,
                "budget_bytes": self.budget_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "inserted": self.inserted,
                "largest_verified_bytes": self.largest_verified_bytes,
                "largest_verify_ms": self.largest_verify_seconds * 1e3,
            }
