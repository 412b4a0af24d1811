"""Measured-probe persistence for the autotuner — the on-disk sibling of
the in-process plan cache.

``autotune(..., probe_top_k=k)`` executes the leading candidates to let
measured seconds override the traffic model. Those measurements are pure
re-derivable state, so a :class:`ProbeStore` spills them as
``(plan key -> {seconds, machine})`` JSON at
``experiments/torch_autotune_probes.json`` (``REPRO_TORCH_PROBES_PATH``
overrides) and reloads them lazily on first use: a repeat session skips
the probe execution entirely and reuses the stored timing. The file is the
port's own: the JAX package's store would prune the port's entries as
foreign fingerprints, and the reverse.

Plan keys are exactly the plan cache keys
(:func:`~repro_torch.engine.api.plan_key`): op x substrate fingerprint
(its device included) x strategy x static scalars x argument shape/dtype
signature — everything a probe timing depends on besides the machine
itself. Keys are stored as their ``repr`` (they are tuples of primitives
and strings, so the repr is stable across sessions). The machine itself is
covered by the calibration plane: each entry carries the
:func:`~repro_torch.machine.machine.machine_fingerprint` it was measured
under (schema v2), ``get`` ignores entries from a different topology, and
``save`` prunes them — a probe measured on one card never ranks strategies
on another host. Schema-v1 entries (bare floats, no fingerprint) are
treated as unknown provenance: always stale, pruned on the next save.
"""
from __future__ import annotations

import json
import os
import threading
import warnings
from pathlib import Path

DEFAULT_PROBES_PATH = (
    Path(__file__).resolve().parents[3] / "experiments" / "torch_autotune_probes.json"
)
_SCHEMA_VERSION = 2


class ProbeStore:
    """Persistent ``(plan key -> measured seconds)`` map, loaded lazily and
    spilled atomically. Thread-safe; read-only filesystems degrade to an
    in-memory store (save() becomes a no-op). Entries are fingerprinted to
    the machine topology they were measured on; foreign entries read as
    absent and are pruned on save."""

    def __init__(self, path: "str | os.PathLike"):
        self.path = Path(path)
        self._lock = threading.RLock()
        # key -> (seconds, fingerprint-key-or-None)
        self._data: "dict[str, tuple[float, str | None]] | None" = None
        self._machine: "str | None | bool" = False  # False = not yet computed
        self.reused = 0  # probes served from the store this session
        self.recorded = 0  # fresh measurements added this session
        self.stale = 0  # lookups rejected for a foreign fingerprint
        self.pruned = 0  # foreign entries dropped by the last save()

    @staticmethod
    def encode_key(key: tuple) -> str:
        return repr(key)

    def _machine_key(self) -> "str | None":
        """This host's topology fingerprint, computed once per store."""
        if self._machine is False:
            from ..machine.machine import fingerprint_key, machine_fingerprint

            self._machine = fingerprint_key(machine_fingerprint())
        return self._machine

    def _load_locked(self) -> "dict[str, tuple[float, str | None]]":
        if self._data is None:
            try:
                blob = self.path.read_bytes()
            except FileNotFoundError:  # absent store: normal first session
                self._data = {}
                return self._data
            except OSError as exc:  # exists but unreadable: say so
                warnings.warn(
                    f"unreadable probe store at {self.path} ({exc!r}); "
                    "starting with an empty store",
                    RuntimeWarning,
                    stacklevel=3,
                )
                self._data = {}
                return self._data
            try:
                # bytes in: json.loads does the decode, so non-UTF-8 garbage
                # lands in the corrupt handler below instead of raising here
                raw = json.loads(blob)
                self._data = {
                    str(k): self._parse_value(v)
                    for k, v in raw.get("probes", {}).items()
                }
            except (ValueError, AttributeError, TypeError, KeyError) as exc:
                # corrupt/truncated store (killed run, disk-full spill, hand
                # edit): probes are rederivable, so degrade to empty — but
                # loudly, the file will be overwritten on the next save()
                warnings.warn(
                    f"corrupt probe store at {self.path} ({exc!r}); "
                    "starting with an empty store",
                    RuntimeWarning,
                    stacklevel=3,
                )
                self._data = {}
        return self._data

    @staticmethod
    def _parse_value(v) -> "tuple[float, str | None]":
        """v2 ``{"seconds": s, "machine": fp}`` or v1 bare seconds (which
        carry no provenance -> fingerprint None -> always stale)."""
        if isinstance(v, dict):
            fp = v.get("machine")
            return (float(v["seconds"]), fp if isinstance(fp, str) else None)
        return (float(v), None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._load_locked())

    def get(self, key: "tuple | None") -> "float | None":
        """Stored seconds for a plan key measured on *this* topology, or
        None (uncacheable / unseen / recorded on a different machine)."""
        if key is None:
            return None
        with self._lock:
            hit = self._load_locked().get(self.encode_key(key))
            if hit is None:
                return None
            seconds, fp = hit
            if fp is None or fp != self._machine_key():
                self.stale += 1
                return None
            self.reused += 1
            return seconds

    def record(self, key: "tuple | None", seconds: float) -> None:
        if key is None:
            return
        with self._lock:
            self._load_locked()[self.encode_key(key)] = (
                float(seconds), self._machine_key(),
            )
            self.recorded += 1

    def save(self) -> None:
        """Atomic spill (tmp file + rename) of the entries valid for this
        topology — foreign and provenance-less (v1) entries are pruned.
        Silently skipped where the experiments directory is not writable."""
        with self._lock:
            mine = self._machine_key()
            data = self._load_locked()
            kept = {
                k: {"seconds": s, "machine": fp}
                for k, (s, fp) in data.items()
                if fp is not None and fp == mine
            }
            self.pruned = len(data) - len(kept)
            payload = {"version": _SCHEMA_VERSION, "probes": kept}
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.path.with_suffix(".json.tmp")
            tmp.write_text(json.dumps(payload, indent=2, sort_keys=True))
            tmp.replace(self.path)
        except OSError:
            pass


_default_store: "ProbeStore | None" = None
_default_store_lock = threading.Lock()


def default_probe_store() -> ProbeStore:
    """The process-wide store at ``experiments/torch_autotune_probes.json``
    (``REPRO_TORCH_PROBES_PATH`` overrides the location)."""
    global _default_store
    with _default_store_lock:
        if _default_store is None:
            path = os.environ.get("REPRO_TORCH_PROBES_PATH", str(DEFAULT_PROBES_PATH))
            _default_store = ProbeStore(path)
        return _default_store
