"""PerformanceModel: machine file x traffic model -> predicted wall seconds.

The calibration plane's top layer. The per-op cost models
(:mod:`repro_torch.core.cost`) already know *how many bytes move in which
class* (migrations, remote-write packets, collective payloads); the machine
file (:mod:`repro_torch.machine.machine`) knows *what a byte costs here*. This module
multiplies them:

    t(strategy) = dispatch_overhead                    # per-call floor
                + sweep_bytes / access_bw              # memory term
                + flops / peak_flops                   # compute term
                + launches * alpha(comm)               # collective latency
                + Sigma_class beta(class) * bytes(class)  # wire terms

    The memory term charges the cost model's declared per-launch working
    set (``detail["memory_bytes_per_launch"]``, padding included — skewed
    matrices execute their padding) at the substrate's rate for the
    declared access class (``detail["memory_access"]``: stream / gather /
    scatter). The class matters as much as the byte count: irregular
    access sustains a fraction of the sequential rate, which is the source
    paper's central measurement transplanted to this backend.

where the migration bytes of a strategy are charged at the ``all_gather``
rate (S2 migrate lowers to a pull), remote-write bytes at the
``all_to_all`` rate (push), and explicit collective payloads at the
strategy's own comm-axis rate. ``launches`` comes from the cost model's
``detail["collective_launches"]`` — BFS pays one dispatch per frontier
round, which is exactly what makes migrate-vs-write latency-bound on
high-diameter graphs — unless the substrate's own declaration gives its
launches (BFS on ``cuda``: one a search).

Predictions are *attached*, never substituted: ranking by them is the
autotuner's decision and only happens against a ``calibrated`` profile, so
an uncalibrated process stays bit-identical to traffic-unit ranking.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Any, Callable, Iterable, Sequence

from ..core.cost import CostEstimate, cost_model_for
from ..core.strategies import Comm, MigratoryStrategy, TrafficStats
from .machine import MachineProfile, default_machine

# S2 axis -> collective class: migrate lowers to a pull (all_gather),
# remote write to a push (all_to_all). Mirrors the substrate kernels.
COMM_CLASS = {Comm.MIGRATE: "all_gather", Comm.REMOTE_WRITE: "all_to_all"}


class PerformanceModel:
    """Predicts wall seconds per (op, strategy, substrate) from a machine
    profile. Construct with an explicit profile or let it pick up the
    process-wide :func:`~repro_torch.machine.machine.default_machine`."""

    def __init__(self, profile: "MachineProfile | None" = None):
        self.profile = profile if profile is not None else default_machine()

    @property
    def calibrated(self) -> bool:
        return self.profile.calibrated

    def predict_parts(
        self,
        estimate: CostEstimate,
        substrate: str = "local",
        *,
        bytes_moved: float = 0.0,
        flops: float = 0.0,
    ) -> dict[str, float]:
        """The prediction's additive terms, for report honesty and tests."""
        sub = self.profile.substrate(substrate)
        traffic = estimate.traffic
        comm = COMM_CLASS.get(estimate.strategy.comm, "all_gather")
        ab_comm = sub.collective(comm)
        launches = float(estimate.detail.get("collective_launches", 1))
        # memory term: the cost model's own per-launch sweep accounting
        # (e.g. BFS scatter-mins over the padded adjacency every round)
        # supersedes the generic useful-bytes count when present — it knows
        # the execution shape *and* the access class (stream / gather /
        # scatter, whose sustained rates differ); ``bytes_moved`` charges
        # one gather-rate pass otherwise. A substrate-targeted declaration
        # (``detail["substrate_memory"]``, keyed by the substrate's name)
        # beats both: it describes what that backend's kernel reads and
        # writes.
        per_launch = estimate.detail.get("memory_bytes_per_launch")
        access = estimate.detail.get("memory_access", "gather")
        targeted = (estimate.detail.get("substrate_memory") or {}).get(substrate)
        if targeted is not None:
            per_launch = targeted.get("bytes_per_launch", per_launch)
            access = targeted.get("access", access)
            launches = float(targeted.get("launches", launches))
        mem_bytes = (
            max(1.0, launches) * float(per_launch)
            if per_launch is not None
            else float(bytes_moved)
        )
        if traffic is None:
            # cost model predates the split: charge everything at the
            # comm-axis wire rate so prediction still works
            wire = ab_comm.beta * float(estimate.traffic_bytes)
        else:
            wire = (
                sub.collective("all_gather").beta * traffic.migration_bytes
                + sub.collective("all_to_all").beta * traffic.remote_write_bytes
                + ab_comm.beta * traffic.collective_bytes
            )
        return {
            "dispatch": sub.dispatch_overhead,
            "memory": mem_bytes / sub.access_bw(access),
            "compute": float(flops) / self.profile.peaks.flops,
            "collective_latency": launches * ab_comm.alpha,
            "wire": wire,
        }

    def predict_estimate(
        self,
        estimate: CostEstimate,
        substrate: str = "local",
        *,
        bytes_moved: float = 0.0,
        flops: float = 0.0,
    ) -> float:
        """Predicted wall seconds for one candidate."""
        return sum(
            self.predict_parts(
                estimate, substrate, bytes_moved=bytes_moved, flops=flops
            ).values()
        )

    def attach(
        self,
        estimates: Sequence[CostEstimate],
        substrate: str = "local",
        *,
        bytes_moved: float = 0.0,
    ) -> list[CostEstimate]:
        """Return copies of ``estimates`` with ``predicted_seconds`` filled.
        The shared ``bytes_moved`` term is a constant across candidates of
        one op, so it shifts predictions without reordering them."""
        return [
            dataclasses.replace(
                e,
                predicted_seconds=self.predict_estimate(
                    e, substrate, bytes_moved=bytes_moved
                ),
            )
            for e in estimates
        ]

    def predict_plan_seconds(self, op: Any, plan: Any) -> "float | None":
        """Predicted seconds for a concrete :class:`ExecutionPlan`, or None
        when the op has no cost model. Uses the op's own ``bytes_moved``
        accounting (already memoized per plan)."""
        try:
            estimator = _estimator_for(op.name, plan.inputs)
            estimate = estimator(plan.strategy)
            moved = float(op.bytes_moved(plan))
        except (ValueError, NotImplementedError):
            return None
        return self.predict_estimate(estimate, plan.substrate, bytes_moved=moved)


def maybe_predict_plan_seconds(op: Any, plan: Any) -> "float | None":
    """The runner's hook: a prediction for this plan when (and only when) a
    calibrated machine file is present, else None. The uncalibrated fast
    path is one cached profile lookup and a bool — RunReports stay
    bit-identical without a machine file."""
    profile = default_machine()
    if not profile.calibrated:
        return None
    return PerformanceModel(profile).predict_plan_seconds(op, plan)


# -- per-inputs estimator memo -------------------------------------------------
# cost_model_for does one full pass over the inputs (nnz ownership, BFS edge
# replay); autotune already amortizes that across its grid, but the runner
# predicts once per run_plan call, so memoize the estimator per concrete
# inputs object (weakref-validated identity, the policy of the ops-layer
# _derived_cached memo).

_ESTIMATOR_MEMO: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_ESTIMATOR_MEMO_MAX = 64


def _estimator_for(
    op_name: str, inputs: Any
) -> Callable[[MigratoryStrategy], CostEstimate]:
    key = (op_name, id(inputs))
    hit = _ESTIMATOR_MEMO.get(key)
    if hit is not None and hit[0]() is inputs:
        _ESTIMATOR_MEMO.move_to_end(key)
        return hit[1]
    estimator = cost_model_for(op_name, inputs)
    try:
        ref: Callable[[], Any] = weakref.ref(inputs)
    except TypeError:  # inputs type without weakref support
        ref = lambda obj=inputs: obj  # noqa: E731 - tiny closure, same shape as weakref
    _ESTIMATOR_MEMO[key] = (ref, estimator)
    while len(_ESTIMATOR_MEMO) > _ESTIMATOR_MEMO_MAX:
        _ESTIMATOR_MEMO.popitem(last=False)
    return estimator
