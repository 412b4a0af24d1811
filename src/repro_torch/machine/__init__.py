"""Machine-model calibration plane.

``microbench`` measures what a device sustains, ``machine`` persists it as
a versioned fingerprinted machine file, ``perfmodel`` turns per-op traffic
counts into predicted wall seconds. The autotuner ranks in predicted
seconds only against a *calibrated* profile; everything else works (and
stays bit-identical) against the bundled default.
"""
from .machine import (
    DEFAULT_PROFILE,
    DTYPE_BYTES,
    SCHEMA_VERSION,
    AlphaBeta,
    MachineProfile,
    Peaks,
    SubstrateProfile,
    default_machine,
    default_machine_path,
    fingerprint_key,
    load_machine,
    machine_fingerprint,
    reset_default_machine_cache,
)
from .perfmodel import COMM_CLASS, PerformanceModel, maybe_predict_plan_seconds


def __getattr__(name):
    # lazy: ``python -m repro_torch.machine.microbench`` must not find the
    # module pre-imported by this package (runpy would warn)
    if name in ("calibrate", "fit_latency_rate"):
        from . import microbench

        return getattr(microbench, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DEFAULT_PROFILE",
    "DTYPE_BYTES",
    "SCHEMA_VERSION",
    "AlphaBeta",
    "MachineProfile",
    "Peaks",
    "SubstrateProfile",
    "default_machine",
    "default_machine_path",
    "fingerprint_key",
    "load_machine",
    "machine_fingerprint",
    "reset_default_machine_cache",
    "calibrate",
    "fit_latency_rate",
    "COMM_CLASS",
    "PerformanceModel",
    "maybe_predict_plan_seconds",
]
