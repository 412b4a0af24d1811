"""Engine API types: the ``MigratoryOp`` protocol, ``ExecutionPlan``, and the
unified ``RunReport`` record.

The paper's thesis is that one set of strategies (S1 replication, S2
migrate-vs-remote-write, S3 layout) applies uniformly to SpMV, BFS, and
graph alignment. The engine makes that uniformity structural: every
distributed op is a :class:`MigratoryOp` planned onto a
:class:`~repro_torch.engine.substrate.Substrate`, its executor cached per
shape/strategy/substrate signature, and every run yields one serializable
:class:`RunReport` combining wall time, the paper's traffic model, effective
bandwidth, and first-call-vs-steady-state accounting. ``RunReport.to_dict``
has the JAX package's row schema.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Protocol, runtime_checkable

from ..core.strategies import MigratoryStrategy, TrafficStats


class OpNotSupportedError(NotImplementedError):
    """Raised when a substrate cannot execute an op: ``Substrate.kernel``
    raises it when no kernel is registered for ``(op_name, substrate_kind)``
    (at plan time), and kernels may raise it for unsupported task shapes."""


def strategy_dict(strategy: MigratoryStrategy) -> dict[str, Any]:
    """Flatten a strategy into plain-JSON form for reports."""
    return {
        "comm": strategy.comm.value,
        "replicate_x": strategy.replicate_x,
        "layout": strategy.layout.value,
        "scheme": strategy.scheme.value,
        "grain": strategy.grain,
    }


def _structure(obj: Any, leaves: list) -> Any:
    """Walk dataclasses, tuples, lists and dicts (in key order); tensors and
    arrays become leaves (appended to ``leaves``), every other value stays
    in the structure."""
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):  # tensors and arrays
        leaves.append(obj)
        return "*"
    if isinstance(obj, dict):
        return ("dict",) + tuple((k, _structure(obj[k], leaves)) for k in sorted(obj))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, _structure(getattr(obj, f.name), leaves)) for f in dataclasses.fields(obj)
        )
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__,) + tuple(_structure(o, leaves) for o in obj)
    return repr(obj)


def args_signature(args: Any) -> tuple:
    """Shape/dtype (never value) signature of a plan's arguments.

    Two argument sets with equal signatures can share an executor: tensor
    fields of the input dataclasses contribute ``(shape, dtype)``, every
    other field its repr, and the structure pins the container types
    (including static fields such as matrix shapes and bucket grids).
    """
    leaves: list = []
    structure = _structure(args, leaves)
    return (str(structure), tuple((tuple(t.shape), str(t.dtype)) for t in leaves))


def plan_key(
    op: str, substrate, strategy: MigratoryStrategy, args: Any,
    static: tuple = (),
) -> tuple:
    """The plan-cache key: op name x substrate fingerprint x full strategy x
    static scalars x argument shape/dtype signature."""
    return (
        op,
        substrate.cache_fingerprint(),
        strategy.cache_key(),
        static,
        args_signature(args),
    )


@dataclasses.dataclass
class ExecutionPlan:
    """A strategy + substrate bound to concrete inputs, ready to run.

    ``executor`` is a function of ``args`` only — it closes over statics
    (strategy, substrate, scalar parameters), all of which are pinned by
    ``key``, so the plan cache may hand the same executor to any later plan
    with an equal ``key``. ``meta`` holds static facts about the inputs plus
    anything the op caches between :meth:`MigratoryOp.traffic` and metric
    computation. ``key=None`` marks a plan as uncacheable.
    """

    op: str
    strategy: MigratoryStrategy
    substrate: str
    inputs: Any
    executor: Callable[..., Any]
    args: tuple = ()
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)
    key: tuple | None = None

    def run(self) -> Any:
        """Execute this plan's own executor on its own arguments."""
        return self.executor(*self.args)


@runtime_checkable
class MigratoryOp(Protocol):
    """A distributed operation the engine knows how to run and account for."""

    name: str

    def plan(self, inputs: Any, strategy: MigratoryStrategy, substrate) -> ExecutionPlan:
        """Bind inputs + strategy to a substrate-specific executor."""

    def traffic(self, plan: ExecutionPlan) -> TrafficStats:
        """Paper-model communication traffic for this plan."""

    def bytes_moved(self, plan: ExecutionPlan) -> int:
        """Bytes the paper's effective-bandwidth formula charges one run."""

    def metrics(self, plan: ExecutionPlan, result: Any, seconds: float) -> dict[str, Any]:
        """Op-specific derived metrics (MTEPS, recall, modeled makespan, ...)."""


@dataclasses.dataclass
class RunReport:
    """One run, one record: wall time, TrafficStats, the per-op stats (BFS
    rounds / GSANA plan model), effective bandwidth, and the plan cache's
    first-call accounting (``cache_hit``, ``compile_seconds``: the first
    call of a new executor, kernel builds included).

    ``predicted_seconds``/``model_error`` are the calibration plane's
    model-honesty columns: the perf model's prediction for this plan and
    its ratio to the measured seconds (predicted / measured, 1.0 =
    perfect). Both stay None — and absent from ``to_dict`` — unless a
    calibrated machine file is present."""

    op: str
    strategy: dict[str, Any]
    substrate: str
    seconds: float
    traffic: TrafficStats
    bytes_moved: int
    effective_gbps: float
    cache_hit: bool = False
    compile_seconds: float = 0.0
    metrics: dict[str, Any] = dataclasses.field(default_factory=dict)
    predicted_seconds: "float | None" = None
    model_error: "float | None" = None

    def to_dict(self) -> dict[str, Any]:
        """Flat, JSON-ready form — the unified benchmark row schema.

        Op metrics may not shadow schema columns.
        """
        row = {
            "op": self.op,
            **{f"strategy_{k}": v for k, v in self.strategy.items()},
            "substrate": self.substrate,
            "seconds": self.seconds,
            "us_per_call": self.seconds * 1e6,
            "cache_hit": self.cache_hit,
            "compile_seconds": self.compile_seconds,
            "migrations": self.traffic.migrations,
            "remote_writes": self.traffic.remote_writes,
            "collective_bytes": self.traffic.collective_bytes,
            "traffic_bytes": self.traffic.total_bytes,
            "bytes_moved": self.bytes_moved,
            "effective_gbps": self.effective_gbps,
        }
        if self.predicted_seconds is not None:
            row["predicted_seconds"] = self.predicted_seconds
        if self.model_error is not None:
            row["model_error"] = self.model_error
        clash = sorted(set(row) & set(self.metrics))
        if clash:
            raise ValueError(
                f"op metrics {clash} collide with RunReport schema columns; "
                "rename the op metric"
            )
        row.update(self.metrics)
        return row

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), default=str)

    @classmethod
    def from_parts(
        cls,
        op: str,
        strategy: MigratoryStrategy,
        substrate: str,
        seconds: float,
        traffic: TrafficStats,
        bytes_moved: int,
        metrics: dict[str, Any] | None = None,
        cache_hit: bool = False,
        compile_seconds: float = 0.0,
        predicted_seconds: "float | None" = None,
    ) -> "RunReport":
        return cls(
            op=op,
            strategy=strategy_dict(strategy),
            substrate=substrate,
            seconds=seconds,
            traffic=traffic,
            bytes_moved=bytes_moved,
            effective_gbps=bytes_moved / max(seconds, 1e-12) / 1e9,
            cache_hit=cache_hit,
            compile_seconds=compile_seconds,
            metrics=metrics or {},
            predicted_seconds=predicted_seconds,
            model_error=(
                None if predicted_seconds is None
                else predicted_seconds / max(seconds, 1e-12)
            ),
        )
