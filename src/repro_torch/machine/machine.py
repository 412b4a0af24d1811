"""The machine file: a versioned, fingerprinted record of what this host
actually sustains.

The paper's Emu analysis only became credible once the Chick was
characterized with microbenchmarks (arXiv:1809.07696: STREAM-like
bandwidth, migration latency); this module is that characterization for
the device the port runs on. ``microbench.calibrate(device=...)`` writes a
:class:`MachineProfile` to ``experiments/torch_machine.json``; the perf
model (:mod:`~repro_torch.machine.perfmodel`) combines it with the per-op
traffic models to predict wall seconds, and the autotuner ranks in those
seconds when a *calibrated* profile is present.

Three guarantees:

- **works uncalibrated** — :data:`DEFAULT_PROFILE` bundles the H100 SXM's
  published peaks plus conservative host-side substrate terms, so every
  consumer has a profile; only *ranking* and RunReport honesty columns
  require a calibrated file;
- **staleness is detected** — the file carries a topology fingerprint
  (:func:`machine_fingerprint`: torch backend, card count and names, host
  cores); :func:`load_machine` refuses (with a warning) a profile recorded
  on a different topology, so a file measured on an H100 is never read on
  a CPU-only host, nor a CPU measurement on the card's host;
- **one dtype-width table** — :data:`DTYPE_BYTES`.

The port keeps its own files (``experiments/torch_machine.json``,
``REPRO_TORCH_MACHINE_PATH``) apart from the JAX package's, whose machine
file it never reads.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import warnings
from pathlib import Path
from typing import Any

import torch

from ..device import resolve_device

SCHEMA_VERSION = 1

DEFAULT_MACHINE_PATH = (
    Path(__file__).resolve().parents[3] / "experiments" / "torch_machine.json"
)

# dtype -> bytes per element, in XLA's short spellings (the machine file's
# schema is shared with the JAX package's)
DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}


def machine_fingerprint(device: "str | torch.device | None" = None) -> dict[str, Any]:
    """Topology identity a calibration is valid for: the torch backend it
    measured (``cuda`` or ``cpu``), the host's card count and names, and
    its core count. ``device`` None means the host's own backend: its card
    when it has one, else the CPU. Naming a CUDA device on a host without
    one raises."""
    cards = (
        [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        if torch.cuda.is_available() else []
    )
    if device is None:
        backend = "cuda" if cards else "cpu"
    else:
        backend = resolve_device(device).type
    return {
        "backend": backend,
        "device_count": len(cards),
        "device_kinds": sorted(set(cards)),
        "cpu_count": os.cpu_count() or 1,
    }


def fingerprint_key(fp: "dict[str, Any] | None") -> "str | None":
    """Stable string encoding of a fingerprint (what ProbeStore entries
    carry); None stays None (unknown provenance == always stale)."""
    if fp is None:
        return None
    return json.dumps(fp, sort_keys=True, default=str)


@dataclasses.dataclass(frozen=True)
class AlphaBeta:
    """The classic collective cost model: ``seconds(n) = alpha + beta*n``
    — per-launch latency plus per-byte inverse bandwidth."""

    alpha: float  # seconds per launch
    beta: float  # seconds per byte

    def seconds(self, nbytes: float, launches: float = 1.0) -> float:
        return launches * self.alpha + self.beta * float(nbytes)

    def to_dict(self) -> dict[str, float]:
        return {"alpha": self.alpha, "beta": self.beta}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "AlphaBeta":
        return cls(alpha=float(d["alpha"]), beta=float(d["beta"]))


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Roofline peaks of one device."""

    flops: float  # FLOP/s per device (float32 outside the tensor cores)
    hbm_bw: float  # bytes/s per device
    # bytes/s between devices: the dry-run's collective term
    # (launch/roofline.py) divides each device's ring wire bytes by it. The
    # bundled figure is the H100 SXM's NVLink 4 total, 900 GB/s over its 18
    # links counting both directions (450 GB/s each way), so the term is
    # the least such a step could take
    ici_bw: float

    def to_dict(self) -> dict[str, float]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Peaks":
        return cls(
            flops=float(d["flops"]), hbm_bw=float(d["hbm_bw"]),
            ici_bw=float(d["ici_bw"]),
        )


#: the H100 SXM's dense bf16 FLOP/s on the tensor cores (NVIDIA's data
#: sheet), the dry-run's rate for bf16 products. The machine file keeps the
#: JAX package's schema, one FLOP rate (``Peaks.flops``, float32 outside the
#: tensor cores), so this rate stands beside it
BF16_TENSOR_FLOPS = 989e12


@dataclasses.dataclass(frozen=True)
class SubstrateProfile:
    """What one substrate sustains: STREAM bandwidth, per-call dispatch
    overhead, and an alpha-beta model per collective class.

    ``collectives`` keys are the engine's traffic classes — ``all_gather``
    (S2 migrate / pull), ``all_to_all`` (S2 remote-write / push), ``psum``
    (reductions). ``source`` records how the numbers were obtained
    (``measured`` | ``derived`` | ``default``).

    ``gather_bw`` / ``scatter_bw`` are the random-access bandwidths — the
    paper's central measurement: irregular access sustains a fraction of
    STREAM, and the two directions differ. Cost models declare which class
    their memory sweep belongs to; :meth:`access_bw` maps the class to a
    rate, falling back to conservative STREAM fractions for old files and
    the bundled default."""

    stream_bw: float  # sustained bytes/s, sequential (STREAM)
    dispatch_overhead: float  # seconds per synchronized call
    collectives: dict[str, AlphaBeta]
    source: str = "default"
    gather_bw: "float | None" = None  # bytes/s, random reads (x[idx])
    scatter_bw: "float | None" = None  # bytes/s, random read-modify-writes

    def access_bw(self, access: str = "gather") -> float:
        """Bytes/s for one memory-access class: ``stream`` (sequential
        sweeps), ``gather`` (random reads), ``scatter`` (random
        read-modify-writes — frontier expansion, remote-write lowering).
        Unmeasured classes fall back to STREAM/4 (gather) and STREAM/16
        (scatter)."""
        if access == "stream":
            return self.stream_bw
        if access == "scatter":
            if self.scatter_bw is not None and self.scatter_bw > 0:
                return self.scatter_bw
            return self.stream_bw / 16.0
        if self.gather_bw is not None and self.gather_bw > 0:
            return self.gather_bw
        return self.stream_bw / 4.0

    def collective(self, kind: str) -> AlphaBeta:
        """The alpha-beta model for one collective class, falling back to a
        stream-derived model (one dispatch of latency, stream-rate bytes)."""
        ab = self.collectives.get(kind)
        if ab is not None:
            return ab
        return AlphaBeta(alpha=self.dispatch_overhead, beta=1.0 / self.stream_bw)

    def to_dict(self) -> dict[str, Any]:
        return {
            "stream_bw": self.stream_bw,
            "dispatch_overhead": self.dispatch_overhead,
            "collectives": {k: v.to_dict() for k, v in self.collectives.items()},
            "source": self.source,
            "gather_bw": self.gather_bw,
            "scatter_bw": self.scatter_bw,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SubstrateProfile":
        gather = d.get("gather_bw")
        scatter = d.get("scatter_bw")
        return cls(
            stream_bw=float(d["stream_bw"]),
            dispatch_overhead=float(d["dispatch_overhead"]),
            collectives={
                str(k): AlphaBeta.from_dict(v)
                for k, v in dict(d.get("collectives", {})).items()
            },
            source=str(d.get("source", "default")),
            gather_bw=float(gather) if gather is not None else None,
            scatter_bw=float(scatter) if scatter is not None else None,
        )


@dataclasses.dataclass(frozen=True)
class MachineProfile:
    """One machine file: fingerprinted topology + per-substrate sustained
    rates + roofline peaks + host parallel capacity.

    ``calibrated=False`` marks the bundled default (and any profile whose
    numbers were not measured on this topology); the autotuner only ranks
    in predicted seconds when ``calibrated`` is true."""

    fingerprint: "dict[str, Any] | None"
    peaks: Peaks
    substrates: dict[str, SubstrateProfile]
    host_parallel_capacity: float = 1.0
    calibrated: bool = False
    quick: bool = False
    created: str = ""
    version: int = SCHEMA_VERSION

    def substrate(self, name: str) -> SubstrateProfile:
        """Profile for a substrate name, falling back to ``local`` and then
        to any profile present — prediction never fails on an unknown
        backend, it just degrades to the local numbers."""
        prof = self.substrates.get(name)
        if prof is not None:
            return prof
        prof = self.substrates.get("local")
        if prof is not None:
            return prof
        return next(iter(self.substrates.values()))

    def stale(self, fp: "dict[str, Any] | None" = None) -> bool:
        """True when this profile was calibrated on a different topology
        than ``fp`` (default: this host's, :func:`machine_fingerprint`).
        The bundled default (``fingerprint=None``) is never stale — it
        claims no topology."""
        if self.fingerprint is None:
            return False
        current = fp if fp is not None else machine_fingerprint()
        return fingerprint_key(self.fingerprint) != fingerprint_key(current)

    def to_dict(self) -> dict[str, Any]:
        return {
            "version": self.version,
            "created": self.created,
            "fingerprint": self.fingerprint,
            "calibrated": self.calibrated,
            "quick": self.quick,
            "host_parallel_capacity": self.host_parallel_capacity,
            "peaks": self.peaks.to_dict(),
            "substrates": {k: v.to_dict() for k, v in self.substrates.items()},
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "MachineProfile":
        return cls(
            version=int(d.get("version", SCHEMA_VERSION)),
            created=str(d.get("created", "")),
            fingerprint=d.get("fingerprint"),
            calibrated=bool(d.get("calibrated", False)),
            quick=bool(d.get("quick", False)),
            host_parallel_capacity=float(d.get("host_parallel_capacity", 1.0)),
            peaks=Peaks.from_dict(d["peaks"]),
            substrates={
                str(k): SubstrateProfile.from_dict(v)
                for k, v in dict(d.get("substrates", {})).items()
            },
        )

    def save(self, path: "str | os.PathLike | None" = None) -> Path:
        """Atomic spill (tmp + rename), mirroring the ProbeStore policy."""
        out = Path(path) if path is not None else default_machine_path()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(self.to_dict(), indent=2, sort_keys=True))
        tmp.replace(out)
        return out


def _default_profile() -> MachineProfile:
    """The bundled default: the H100 SXM's published peaks (NVIDIA's data
    sheet: 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM,
    900 GB/s of NVLink over all links) plus deliberately pessimistic
    host-side substrate terms. Everything works against it; nothing
    *ranks* by it."""
    local = SubstrateProfile(
        stream_bw=8e9,  # ~1 DDR channel — conservative for any host
        dispatch_overhead=50e-6,
        collectives={},  # derived from stream on demand
        source="default",
    )
    return MachineProfile(
        fingerprint=None,
        peaks=Peaks(flops=67e12, hbm_bw=3.35e12, ici_bw=900e9),
        substrates={"local": local, "cuda": local},
        host_parallel_capacity=1.0,
        calibrated=False,
    )


DEFAULT_PROFILE = _default_profile()


def default_machine_path() -> Path:
    """``experiments/torch_machine.json``; ``REPRO_TORCH_MACHINE_PATH`` overrides."""
    return Path(os.environ.get("REPRO_TORCH_MACHINE_PATH", str(DEFAULT_MACHINE_PATH)))


def load_machine(
    path: "str | os.PathLike | None" = None, *, allow_stale: bool = False
) -> "MachineProfile | None":
    """Load a machine file, or None when it is absent, unreadable, corrupt,
    from a newer schema, or (unless ``allow_stale``) calibrated on a
    different topology. Every non-absent rejection warns — a stale
    calibration silently ranking strategies is exactly the bug this
    detection exists for."""
    p = Path(path) if path is not None else default_machine_path()
    try:
        blob = p.read_bytes()
    except FileNotFoundError:
        return None
    except OSError as exc:
        warnings.warn(
            f"unreadable machine file at {p} ({exc!r}); using the bundled default",
            RuntimeWarning, stacklevel=2,
        )
        return None
    try:
        profile = MachineProfile.from_dict(json.loads(blob))
    except (ValueError, KeyError, TypeError, AttributeError) as exc:
        warnings.warn(
            f"corrupt machine file at {p} ({exc!r}); using the bundled default",
            RuntimeWarning, stacklevel=2,
        )
        return None
    if profile.version > SCHEMA_VERSION:
        warnings.warn(
            f"machine file at {p} has schema v{profile.version} > "
            f"supported v{SCHEMA_VERSION}; using the bundled default",
            RuntimeWarning, stacklevel=2,
        )
        return None
    if not allow_stale and profile.stale():
        warnings.warn(
            f"machine file at {p} was calibrated on a different topology "
            f"({profile.fingerprint} != {machine_fingerprint()}); "
            "re-run `python -m repro_torch.machine.microbench` — using the bundled default",
            RuntimeWarning, stacklevel=2,
        )
        return None
    return profile


# -- cached default lookup -----------------------------------------------------
# engine.run consults the machine file on every call; cache the load keyed
# by (path, mtime) so the steady-state cost is one os.stat.

_cache_lock = threading.Lock()
_cached: "tuple[str, float | None, MachineProfile] | None" = None


def default_machine() -> MachineProfile:
    """The process-wide machine profile: the file at
    :func:`default_machine_path` when present and fresh, else
    :data:`DEFAULT_PROFILE` (``calibrated=False``). Reloads automatically
    when the file's mtime changes."""
    global _cached
    path = default_machine_path()
    try:
        mtime: "float | None" = path.stat().st_mtime
    except OSError:
        mtime = None
    key = str(path)
    with _cache_lock:
        if _cached is not None and _cached[0] == key and _cached[1] == mtime:
            return _cached[2]
    profile = (load_machine(path) if mtime is not None else None) or DEFAULT_PROFILE
    with _cache_lock:
        _cached = (key, mtime, profile)
    return profile


def reset_default_machine_cache() -> None:
    """Drop the cached default profile (tests repoint ``REPRO_TORCH_MACHINE_PATH``)."""
    global _cached
    with _cache_lock:
        _cached = None
