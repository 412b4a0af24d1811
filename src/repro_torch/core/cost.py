"""Analytic strategy cost model: the paper's traffic units from shapes alone.

Rolinger & Krieger (1812.05955) show the right sparse optimization is
workload-dependent; this module systematizes the paper's §5 per-workload
analysis so the engine can *rank* the S1 x S2 x S3 x grain grid without
executing anything. Costs are expressed in the same units the engine's
RunReports carry — ``TrafficStats.total_bytes`` under the Emu model
(CONTEXT_BYTES per migration, WRITE_PACKET_BYTES per remote write) — so an
exhaustive measured sweep and the analytic ranking are directly
cross-checkable.

Each ``*_cost_model`` factory precomputes the shared structure statistics
once (nnz ownership, the BFS edge replay, the GSANA placements) in numpy
and returns a cheap per-strategy estimator, so ranking a grid of candidates
costs one pass over the inputs, not one per candidate.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from ..device import to_numpy
from .strategies import (
    CONTEXT_BYTES,
    Comm,
    Layout,
    MigratoryStrategy,
    TrafficStats,
)
from .util import ceil_div

# dynamic_grain's task-count target: the machine-saturation point the grain
# tie-break scores distance from (paper Fig. 4)
GRAIN_TARGET_TASKS = 512


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """One candidate strategy's modeled cost.

    ``traffic_bytes`` is the primary key and matches the engine's reported
    ``report.traffic.total_bytes`` exactly; ``balance_penalty`` breaks ties
    among traffic-equal candidates (modeled makespan for GSANA, grain/task
    mismatch for SpMV, 0 where the axis is inert).

    ``traffic`` is the same cost split by class (migrations / remote writes
    / collective bytes) — the calibration plane's perf model charges each
    class a different alpha-beta rate. ``predicted_seconds`` is attached by
    :class:`~repro_torch.machine.perfmodel.PerformanceModel` when a
    calibrated machine file is present; it stays None (and ranking stays
    bit-identical to the traffic units) otherwise.
    ``detail["collective_launches"]`` counts the dispatches the strategy
    issues (BFS pays one per round), feeding the alpha term.

    ``detail["substrate_memory"]`` maps a substrate kind to that backend's
    *own* per-launch working set + access class (and, where it differs,
    its launch count: BFS on ``cuda`` is one launch a search) where its
    kernel moves a different memory shape than the generic path. The perf
    model prefers the targeted declaration over the generic one.
    """

    strategy: MigratoryStrategy
    traffic_bytes: int
    balance_penalty: float
    detail: dict[str, Any] = dataclasses.field(default_factory=dict)
    traffic: "TrafficStats | None" = None
    predicted_seconds: "float | None" = None

    def rank_key(self) -> tuple:
        return (
            self.traffic_bytes,
            self.balance_penalty,
            str(self.strategy.cache_key()),  # deterministic final tie-break
        )


CostModel = Callable[[MigratoryStrategy], CostEstimate]


def spmv_cost_model(inputs) -> CostModel:
    """S1 + grain model (paper §5.1): striping x costs one migration per
    nonzero whose column lives on a different nodelet; replication costs
    none. Grain is scored by task-count distance from the dynamic-grain
    saturation target."""
    a = inputs.a
    cols = to_numpy(a.cols)
    p = a.P
    p_idx = np.arange(p)[:, None, None]
    remote_nnz = int(((cols >= 0) & ((cols % p) != p_idx)).sum())
    rp = a.rows_per_nodelet
    n_cols = a.shape[1]
    # what one launch streams: the *padded* ELL slab (vals f32 + cols i32,
    # padding included — skewed matrices execute their padding) plus x
    # gathered and y written; random reads dominate, so this is charged at
    # the machine file's gather rate
    sweep_bytes = cols.size * 8 + 2 * 4 * p * rp
    # csrc/spmv_ell.cu, as the cuda adapter launches it (planes flattened to
    # p*rp rows, one CTA a grain of rows): a thread walks its row's K slots,
    # so the padded column and value planes are read once, in row order;
    # x is read from device memory once and its random reads are then
    # served by L2 (one copy for every CTA: nothing is replicated per
    # block while x fits the 50 MB L2, as the main path's 16.8 MB does);
    # y is written once. Sequential sweeps: the stream class. No term
    # depends on the grain.
    cuda_bytes = cols.size * 8 + n_cols * 4 + p * rp * 4

    def estimate(st: MigratoryStrategy) -> CostEstimate:
        migrations = 0 if st.replicate_x else remote_nnz
        grain = st.dynamic_grain(rp, target_tasks=GRAIN_TARGET_TASKS)
        tasks = ceil_div(rp, max(1, min(grain, rp))) * p
        target = min(GRAIN_TARGET_TASKS, rp) * p
        balance = abs(tasks - target) / max(target, 1)
        return CostEstimate(
            strategy=st,
            traffic_bytes=migrations * CONTEXT_BYTES,
            balance_penalty=balance,
            detail={
                "migrations": migrations, "tasks": tasks, "grain": grain,
                "collective_launches": 1,
                "memory_bytes_per_launch": sweep_bytes,
                "memory_access": "gather",
                "substrate_memory": {
                    "cuda": {
                        "bytes_per_launch": cuda_bytes,
                        "access": "stream",
                        "ctas": ceil_div(p * rp, max(1, min(grain, p * rp))),
                    },
                },
            },
            traffic=TrafficStats(migrations=migrations),
        )

    return estimate


def bfs_cost_model(inputs) -> CostModel:
    """S2 model (paper §5.2): one numpy edge replay yields the remote-edge
    count; migrate charges 2 context moves per remote edge (the §7
    ping-pong), remote write one small packet."""
    from .bfs import bfs_traffic

    stats = bfs_traffic(inputs.g, inputs.root, MigratoryStrategy(comm=Comm.MIGRATE))
    remote_edges = stats.traffic.migrations // 2
    # per-round dense working set: level-synchronous kernels scatter-min
    # over the full padded adjacency every round — index + read + write per
    # (N_pad, K) slot, charged at the machine file's *scatter* rate (the
    # serialized read-modify-write path, not the triad), times rounds
    p, vp, k = inputs.g.adj.shape
    sweep_bytes = 12 * p * vp * k
    n_pad = p * vp
    # csrc/bfs_expand.cu's bfs_search: the whole search in one launch, on
    # the graph's (P, V_p, K) planes in place. Each level reads the frontier
    # mask (1 B a vertex) and the proposals, and writes them back reset for
    # the next level (8 B a vertex); only frontier rows are walked, and over
    # a whole BFS every reached row is a frontier row once, so the search
    # reads each traversed edge's slot once (4 B) and issues one atomicMin
    # for it into the one parent array (4 B). The atomics are scattered
    # read-modify-writes: the scatter class. The grid is the kernel's
    # occupancy times the SMs, known only on the card; no term depends on
    # it or on the grain.
    cuda_bytes = 9 * n_pad * stats.rounds + 8 * stats.edges_traversed

    def estimate(st: MigratoryStrategy) -> CostEstimate:
        if st.comm == Comm.MIGRATE:
            split = TrafficStats(migrations=2 * remote_edges)
        else:
            split = TrafficStats(remote_writes=remote_edges)
        return CostEstimate(
            strategy=st,
            traffic_bytes=split.total_bytes,
            balance_penalty=0.0,
            detail={
                "remote_edges": remote_edges,
                "edges_traversed": stats.edges_traversed,
                "rounds": stats.rounds,
                # one collective dispatch per frontier round — the alpha
                # term is what separates migrate from remote-write on
                # latency-bound rounds
                "collective_launches": stats.rounds,
                "memory_bytes_per_launch": sweep_bytes,
                "memory_access": "scatter",
                "substrate_memory": {
                    "cuda": {"launches": 1, "bytes_per_launch": cuda_bytes, "access": "scatter"},
                },
            },
            traffic=split,
        )

    return estimate


def gsana_cost_model(inputs) -> CostModel:
    """S3 model (paper §5.3): replay the task schedule per (layout, scheme)
    with the paper's placement/traffic model; migrations drive traffic,
    modeled makespan breaks the ALL-vs-PAIR tie (schemes share traffic)."""
    from .gsana import DEFAULT_VOCAB, layout_blk, layout_hcb, plan_stats

    # one σ comparison materializes the (A, B, T) histogram-minimum
    # intermediates over the three overlap vocabularies (T = Σ DEFAULT_VOCAB
    # f32 lanes, ~2 passes each: broadcast-min write + reduce read) — dense
    # sequential work, charged at the machine file's stream rate
    cmp_bytes = 2 * 4 * sum(DEFAULT_VOCAB)

    placements = {
        Layout.BLK: layout_blk(
            inputs.b1, inputs.b2, inputs.vs1.n, inputs.vs2.n, inputs.nodelets
        ),
        Layout.HCB: layout_hcb(inputs.b1, inputs.b2, inputs.nodelets),
    }
    memo: dict[tuple, Any] = {}

    def estimate(st: MigratoryStrategy) -> CostEstimate:
        key = (st.layout, st.scheme)
        if key not in memo:
            memo[key] = plan_stats(
                inputs.vs1, inputs.vs2, inputs.b1, inputs.b2,
                placements[st.layout], st.scheme, inputs.nodelets,
                threads_per_nodelet=inputs.threads_per_nodelet,
                migration_penalty=inputs.migration_penalty,
            )
        ps = memo[key]
        return CostEstimate(
            strategy=st,
            traffic_bytes=ps.traffic.total_bytes,
            balance_penalty=ps.makespan,
            detail={
                "migrations": ps.traffic.migrations,
                "model_makespan": ps.makespan,
                "model_speedup": ps.speedup_model,
                "collective_launches": 1,
                "memory_bytes_per_launch": ps.total_comparisons * cmp_bytes,
                "memory_access": "stream",
            },
            traffic=ps.traffic,
        )

    return estimate


COST_MODELS: dict[str, Callable[[Any], CostModel]] = {
    "spmv": spmv_cost_model,
    "bfs": bfs_cost_model,
    "gsana": gsana_cost_model,
}


def register_cost_model(op_name: str, factory: Callable[[Any], CostModel]) -> None:
    """Install an op's analytic cost-model factory so ``cost_model_for``
    serves it. The engine's kernel registry calls this when an
    :class:`~repro_torch.engine.registry.OpSpec` carries a ``cost_model``.
    Re-registering the same op replaces the factory."""
    COST_MODELS[op_name] = factory


def cost_model_for(op_name: str, inputs) -> CostModel:
    """Build the per-strategy estimator for one op's concrete inputs."""
    try:
        factory = COST_MODELS[op_name]
    except KeyError:
        raise ValueError(
            f"no cost model for op {op_name!r}; known: {sorted(COST_MODELS)}"
        ) from None
    return factory(inputs)
