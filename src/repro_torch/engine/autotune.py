"""Strategy autotuner: rank the S1 x S2 x S3 x grain grid with the paper's
traffic model, optionally confirm the top-k with measured probes.

The paper's central claim is that picking the *right* strategy is what makes
irregular algorithms fast on migratory hardware — and the right choice is
workload-dependent (Rolinger & Krieger, 1812.05955). The autotuner makes
that choice an engine feature instead of a caller obligation:

    strategy = choose_strategy("spmv", inputs, sub)                 # analytic
    result, report = run(Request("spmv", inputs, "auto", sub))      # same, inline

    tuned = autotune("bfs", inputs, sub, probe_top_k=3)  # + measured probes
    best = tuned.best                                    # probes warm the plan
    rows = tuned.table()                                 # cache for the real run

Ranking is analytic (core/cost.py): with no machine file the primary key is
the modeled traffic in bytes — identical to what a measured sweep's
RunReports would carry — tie-broken by the per-op balance model. With a
*calibrated* machine file the same estimates are converted to predicted
wall seconds by the :class:`~repro_torch.machine.perfmodel.PerformanceModel`
and ranked in those, with the traffic key demoted to tie-break;
``AutotuneResult.ranked_by`` records which key ordered the table.
Precedence is probe > model > traffic units: ``probe_top_k`` executes the
leading candidates through the plan cache (so the eventual production run
of the winner is a cache hit) and a decisively faster probe overrides
either analytic ranking. Pass a :class:`~repro_torch.engine.probes.ProbeStore`
to persist measured probe seconds — repeat sessions on the same machine
fingerprint reuse the stored timing instead of re-probing.

A substrate given by name is built on the default device, the card; pass
an instance (``LocalSubstrate("cpu")``) to rank or probe on the CPU.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any

from ..core.cost import CostEstimate, cost_model_for
from ..core.strategies import MigratoryStrategy, strategy_grid
from ..machine.machine import MachineProfile, default_machine
from ..machine.perfmodel import PerformanceModel
from .api import ExecutionPlan, RunReport, strategy_dict
from .cache import PlanCache
from .probes import ProbeStore
from .registry import default_registry
from .request import Request
from .runner import build_plan, resolve_op, run
from .substrate import Substrate, get_substrate


def candidate_grid(
    op_name: str, substrate: "Substrate | str | None" = None
) -> list[MigratoryStrategy]:
    """The autotuner's search space for one op: the op's registered
    ``OpSpec.grid`` (e.g. SpMV populates the grain axis), else the default
    S1 x S2 x S3 cross product.

    ``substrate`` targets the grid at a backend: grid callables that accept
    an argument receive the substrate's kind and may widen a kernel-tuning
    axis for it (SpMV/BFS enumerate the CUDA kernels' grains); zero-arg
    grids are called as is."""
    spec = default_registry().op_spec(op_name)
    if spec.grid is None:
        return strategy_grid()
    if inspect.signature(spec.grid).parameters:
        kind = None if substrate is None else get_substrate(substrate).kind
        return spec.grid(kind)
    return spec.grid()


@dataclasses.dataclass
class RankedCandidate:
    """One grid point: its analytic estimate + optional measured probe.
    ``probe_persisted`` marks a probe whose seconds came from the
    :class:`~repro_torch.engine.probes.ProbeStore` instead of a fresh run."""

    rank: int
    estimate: CostEstimate
    probe: RunReport | None = None
    probe_persisted: bool = False

    @property
    def predicted_seconds(self) -> "float | None":
        """Modeled wall seconds (calibrated machine file only, else None)."""
        return self.estimate.predicted_seconds

    def to_row(self) -> dict[str, Any]:
        row = {
            "rank": self.rank,
            **{f"strategy_{k}": v for k, v in strategy_dict(self.estimate.strategy).items()},
            "traffic_bytes": self.estimate.traffic_bytes,
            "balance_penalty": self.estimate.balance_penalty,
            **self.estimate.detail,
        }
        if self.predicted_seconds is not None:
            row["predicted_seconds"] = self.predicted_seconds
        if self.probe is not None:
            row["probe_seconds"] = self.probe.seconds
            row["probe_compile_seconds"] = self.probe.compile_seconds
            row["probe_cache_hit"] = self.probe.cache_hit
            row["probe_persisted"] = self.probe_persisted
        return row


@dataclasses.dataclass
class AutotuneResult:
    op: str
    substrate: str
    best: MigratoryStrategy
    candidates: list[RankedCandidate]
    ranked_by: str = "traffic_bytes"  # or "predicted_seconds" when calibrated

    def table(self) -> list[dict[str, Any]]:
        """The ranking table (JSON rows)."""
        return [
            {"op": self.op, "substrate": self.substrate,
             "chosen": c.estimate.strategy == self.best, **c.to_row()}
            for c in self.candidates
        ]


def _substrate_name(substrate: "Substrate | str") -> str:
    return substrate.name if isinstance(substrate, Substrate) else str(substrate)


def rank_strategies(
    op,
    inputs,
    candidates: "list[MigratoryStrategy] | None" = None,
    *,
    substrate: "Substrate | str" = "local",
    machine: "MachineProfile | None" = None,
) -> list[CostEstimate]:
    """Analytically rank candidate strategies for ``op`` on ``inputs``
    (best first). No execution — shapes and static structure only.

    With a calibrated machine profile (``machine`` when given, else the
    process-wide :func:`~repro_torch.machine.machine.default_machine`), each
    estimate gains ``predicted_seconds`` for ``substrate`` and the sort key
    becomes (predicted seconds, traffic key); uncalibrated, estimates are
    untouched and the ordering is bit-identical to the traffic units."""
    op = resolve_op(op)
    model = cost_model_for(op.name, inputs)
    cands = candidates if candidates is not None else candidate_grid(op.name, substrate)
    estimates = [model(st) for st in cands]
    profile = machine if machine is not None else default_machine()
    if profile.calibrated:
        estimates = PerformanceModel(profile).attach(
            estimates, _substrate_name(substrate)
        )
        return sorted(estimates, key=lambda e: (e.predicted_seconds, *e.rank_key()))
    return sorted(estimates, key=lambda e: e.rank_key())


def choose_strategy(
    op, inputs, substrate: "Substrate | str" = "local",
    machine: "MachineProfile | None" = None,
) -> MigratoryStrategy:
    """The model-optimal strategy — what ``strategy="auto"`` runs. Ranked
    in predicted seconds when a calibrated machine file is present, in the
    paper's traffic units otherwise."""
    return rank_strategies(op, inputs, substrate=substrate, machine=machine)[0].strategy


def _persisted_probe_report(op, plan: ExecutionPlan, seconds: float) -> RunReport:
    """A RunReport standing in for a probe served from the persisted store:
    measured seconds from a prior session, analytic traffic from the plan.
    No execution happened, so the plan cache was not warmed —
    ``cache_hit=False`` stays truthful; ``probe_persisted`` in the ranking
    row carries the provenance."""
    return RunReport.from_parts(
        op=op.name,
        strategy=plan.strategy,
        substrate=plan.substrate,
        seconds=seconds,
        traffic=op.traffic(plan),
        bytes_moved=op.bytes_moved(plan),
        metrics={},
        cache_hit=False,
        compile_seconds=0.0,
    )


def autotune(
    op,
    inputs,
    substrate: "Substrate | str" = "local",
    *,
    probe_top_k: int = 0,
    iters: int = 3,
    warmup: int = 1,
    cache: PlanCache | None = None,
    override_margin: float = 0.2,
    probe_store: "ProbeStore | None" = None,
    machine: "MachineProfile | None" = None,
) -> AutotuneResult:
    """Rank the grid; optionally execute the top ``probe_top_k`` candidates
    through the plan cache and let measured seconds pick among them.

    A probe overrides the model's pick only when it is decisively faster
    (by ``override_margin``): on substrates where a strategy axis is
    execution-inert (e.g. S2 on one device) probe timings are pure noise,
    and the model's choice stands. Probes run each probed candidate's plan,
    so the subsequent production run of ``result.best`` is a cache hit.
    A probe that fails raises: nothing is skipped or swapped.

    With a ``probe_store``, candidates whose plan key already has a stored
    measurement *from this machine fingerprint* skip execution and reuse
    the persisted seconds (those candidates do *not* warm the plan cache);
    entries recorded on a different topology read as absent and are pruned
    when the store is spilled to disk before returning.
    """
    op = resolve_op(op)
    sub = get_substrate(substrate)
    profile = machine if machine is not None else default_machine()
    estimates = rank_strategies(op, inputs, substrate=sub, machine=profile)
    candidates = [RankedCandidate(rank=i + 1, estimate=e) for i, e in enumerate(estimates)]
    best = candidates[0].estimate.strategy
    if probe_top_k > 0:
        # probe only cost-distinct candidates: grid points whose estimates tie
        # exactly differ in axes the op never reads, so one probe covers them.
        # The substrate-targeted working set (and predicted seconds, when
        # calibrated) join the signature, so candidates that tie in traffic
        # units but not in what the target's kernel moves get their own probes.
        probed: list[RankedCandidate] = []
        seen_costs: set[tuple] = set()
        for cand in candidates:
            targeted = (cand.estimate.detail.get("substrate_memory") or {}).get(sub.kind)
            cost_sig = (
                cand.estimate.traffic_bytes,
                cand.estimate.balance_penalty,
                cand.estimate.predicted_seconds,
                targeted.get("bytes_per_launch") if targeted else None,
            )
            if cost_sig in seen_costs:
                continue
            seen_costs.add(cost_sig)
            plan = build_plan(op, inputs, cand.estimate.strategy, sub)
            stored = probe_store.get(plan.key) if probe_store is not None else None
            if stored is not None:
                cand.probe = _persisted_probe_report(op, plan, stored)
                cand.probe_persisted = True
            else:
                _, report = run(
                    Request(op, inputs, cand.estimate.strategy, sub),
                    iters=iters, warmup=warmup, cache=cache,
                )
                cand.probe = report
                if probe_store is not None:
                    probe_store.record(plan.key, report.seconds)
            probed.append(cand)
            if len(probed) >= probe_top_k:
                break
        fastest = min(probed, key=lambda c: c.probe.seconds)
        model_pick = probed[0]  # rank 1 is always probed first
        if fastest.probe.seconds < model_pick.probe.seconds * (1.0 - override_margin):
            best = fastest.estimate.strategy
        if probe_store is not None:
            probe_store.save()
    return AutotuneResult(
        op=op.name,
        substrate=sub.name,
        best=best,
        candidates=candidates,
        ranked_by="predicted_seconds" if profile.calibrated else "traffic_bytes",
    )
