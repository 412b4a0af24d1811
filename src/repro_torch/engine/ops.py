"""MigratoryOp adapters over the core algorithms.

Each adapter owns three things for its algorithm: how to bind inputs to a
substrate (``plan``), the paper's traffic model (``traffic``), and the
paper's useful-bytes accounting (``bytes_moved``), plus derived metrics
(MTEPS, recall, modeled makespan) for the RunReport. ``plan`` binds the
executor by *kernel lookup* (``substrate.kernel(self.name)``), so an
unsupported pair fails at plan time with
:class:`~repro_torch.engine.api.OpNotSupportedError`.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Any, Callable

import numpy as np
import torch

from .. import trace
from ..core.bfs import bfs_bytes_moved, bfs_traffic, teps
from ..core.cost import bfs_cost_model, gsana_cost_model, spmv_cost_model
from ..core.gsana import gsana_rw_bytes, layout_blk, layout_hcb, plan_stats, recall_at_k
from ..core.gsana_data import Buckets, VertexSet
from ..core.spmv import PartitionedELL, spmv_bytes_moved, spmv_traffic, stripe_vector
from ..core.strategies import Layout, MigratoryStrategy, TrafficStats, strategy_grid
from ..sparse.graph import PartitionedGraph
from .api import ExecutionPlan, plan_key
from .registry import OpSpec, register_op
from .substrate import Substrate

# grain values worth distinguishing for row-grained ops (None = dynamic);
# SpMV's autotune grid sweeps them, the other ops' grids pin grain=None
GRAIN_CANDIDATES = (None, 16, 64, 256)

# the cuda kernels' tuning axis: grain = rows one CTA owns. Taken from the
# kernels' launch shapes: csrc/spmv_ell.cu gives a CTA min(256, roundup32(
# grain)) threads, so 256 is the least grain that fills a CTA; a bfs_expand
# CTA fills its 16 warps at 512 rows; the main path's dynamic grains (None)
# are 1024 for SpMV and 2048 for BFS; 4096 halves the CTAs once more. The
# grain sweep of chip_smoke.py on an H100 (PERF.md) keeps all six: the two
# kernels' fastest grains lie at opposite ends of the set (spmv_ell at 4096,
# bfs_expand at 256-512, where 8 CTAs of 256 rows fit an SM).
CUDA_BLOCK_CANDIDATES = (None, 256, 512, 1024, 2048, 4096)


def _spmv_grid(substrate_kind: "str | None" = None) -> list[MigratoryStrategy]:
    grains = CUDA_BLOCK_CANDIDATES if substrate_kind == "cuda" else GRAIN_CANDIDATES
    return strategy_grid(grains=grains)


def _bfs_grid(substrate_kind: "str | None" = None) -> list[MigratoryStrategy]:
    # the default grid pins grain=None (the local kernel never reads it); on
    # cuda the grain is the rows a CTA of the frontier-expansion kernel owns
    if substrate_kind == "cuda":
        return strategy_grid(grains=CUDA_BLOCK_CANDIDATES)
    return strategy_grid()


# Cross-plan memo for host-side derived stats (traffic replays, placement
# models, nnz scans): every run builds a fresh plan, so ``plan.meta`` alone
# would rerun the numpy work for each run of the same inputs. Keyed by inputs
# object identity + a static discriminator, validated with a weakref so a
# recycled id of a collected object can never alias.
_DERIVED_MEMO: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_DERIVED_MEMO_MAX = 256


def _derived_cached(kind: str, anchor: Any, extra: Any, compute: Callable[[], Any]) -> Any:
    key = (kind, id(anchor), extra)
    hit = _DERIVED_MEMO.get(key)
    if hit is not None and hit[0]() is anchor:
        _DERIVED_MEMO.move_to_end(key)
        trace.count(f"memo.hit.{kind}")
        return hit[1]
    trace.count(f"memo.miss.{kind}")
    with trace.span("engine.derive"):
        value = compute()
    _DERIVED_MEMO[key] = (weakref.ref(anchor), value)
    while len(_DERIVED_MEMO) > _DERIVED_MEMO_MAX:
        _DERIVED_MEMO.popitem(last=False)  # LRU: never drop the hot entries
    return value


# -- SpMV ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpMVInputs:
    """``x`` is always the full (N,) vector; the engine stripes it when the
    strategy keeps it distributed (S1 off)."""

    a: PartitionedELL
    x: torch.Tensor


class SpMVOp:
    name = "spmv"

    def plan(self, inputs: SpMVInputs, strategy: MigratoryStrategy, substrate: Substrate):
        substrate.check_inputs(inputs.a.cols, inputs.a.vals, inputs.x)
        x = inputs.x if strategy.replicate_x else stripe_vector(inputs.x, inputs.a.P)
        args = (inputs.a, x)
        kern = substrate.kernel(self.name)
        return ExecutionPlan(
            op=self.name,
            strategy=strategy,
            substrate=substrate.name,
            inputs=inputs,
            executor=lambda a, xv: kern(a, xv, strategy=strategy),
            args=args,
            meta={"n_cols": inputs.a.shape[1], "n_rows": inputs.a.shape[0]},
            key=plan_key(self.name, substrate, strategy, args),
        )

    def traffic(self, plan: ExecutionPlan) -> TrafficStats:
        inputs, strategy = plan.inputs, plan.strategy
        # the count reads only S1, so one memo entry serves every grain
        return _derived_cached(
            "spmv_traffic", inputs, strategy.replicate_x,
            lambda: spmv_traffic(inputs.a, strategy),
        )

    def bytes_moved(self, plan: ExecutionPlan) -> int:
        inputs, n_cols = plan.inputs, plan.meta["n_cols"]
        return _derived_cached(
            "spmv_bytes", inputs, n_cols, lambda: spmv_bytes_moved(inputs.a, n_cols),
        )

    def metrics(self, plan: ExecutionPlan, result: Any, seconds: float) -> dict[str, Any]:
        return {
            "grain": plan.strategy.dynamic_grain(plan.inputs.a.rows_per_nodelet),
            "nodelets": plan.inputs.a.P,
        }


# -- BFS -----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BFSInputs:
    g: PartitionedGraph
    root: int
    max_rounds: int | None = None


class BFSOp:
    name = "bfs"

    def plan(self, inputs: BFSInputs, strategy: MigratoryStrategy, substrate: Substrate):
        substrate.check_inputs(inputs.g.adj)
        args = (inputs.g,)
        # close over the scalars, not `inputs`: the plan cache keeps the
        # executor closure alive, and it must not pin the graph tensors
        root, max_rounds = inputs.root, inputs.max_rounds
        kern = substrate.kernel(self.name)
        return ExecutionPlan(
            op=self.name,
            strategy=strategy,
            substrate=substrate.name,
            inputs=inputs,
            executor=lambda g: kern(g, root, strategy=strategy, max_rounds=max_rounds),
            args=args,
            key=plan_key(
                self.name, substrate, strategy, args, static=(inputs.root, inputs.max_rounds),
            ),
        )

    def _stats(self, plan: ExecutionPlan):
        """The numpy traffic replay: O(edges), computed once per
        (inputs, root, comm) — the only strategy axis it reads — and shared
        across every plan built for them."""
        if "run_stats" not in plan.meta:
            inputs, strategy = plan.inputs, plan.strategy
            plan.meta["run_stats"] = _derived_cached(
                "bfs_replay", inputs, (inputs.root, strategy.comm),
                lambda: bfs_traffic(inputs.g, inputs.root, strategy),
            )
        return plan.meta["run_stats"]

    def traffic(self, plan: ExecutionPlan) -> TrafficStats:
        return self._stats(plan).traffic

    def bytes_moved(self, plan: ExecutionPlan) -> int:
        return bfs_bytes_moved(self._stats(plan).edges_traversed)

    def metrics(self, plan: ExecutionPlan, result: Any, seconds: float) -> dict[str, Any]:
        stats = self._stats(plan)
        reached = 0
        if result is not None:
            trace.count("sync.bfs_reached")
            reached = int((result >= 0).sum())
        return {
            "rounds": stats.rounds,
            "edges_traversed": stats.edges_traversed,
            "mteps": teps(stats.edges_traversed, seconds) / 1e6,
            "reached": reached,
        }


# -- GSANA ---------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GSANAInputs:
    vs1: VertexSet
    vs2: VertexSet
    b1: Buckets
    b2: Buckets
    k: int = 4
    nodelets: int = 8
    threads_per_nodelet: int = 32
    migration_penalty: float = 0.3
    ground_truth: np.ndarray | None = None  # optional π for recall@k


class GSANAOp:
    name = "gsana"

    def plan(self, inputs: GSANAInputs, strategy: MigratoryStrategy, substrate: Substrate):
        substrate.check_inputs(inputs.vs1.deg, inputs.vs2.deg, inputs.b1.vid, inputs.b2.vid)
        args = (inputs.vs1, inputs.vs2, inputs.b1, inputs.b2)
        # close over the scalar k, not `inputs`: cached executors must not
        # pin the vertex-set/bucket tensors of the first request
        k = inputs.k
        kern = substrate.kernel(self.name)
        return ExecutionPlan(
            op=self.name,
            strategy=strategy,
            substrate=substrate.name,
            inputs=inputs,
            executor=lambda vs1, vs2, b1, b2: kern(vs1, vs2, b1, b2, k, strategy=strategy),
            args=args,
            key=plan_key(self.name, substrate, strategy, args, static=(inputs.k,)),
        )

    def _plan_stats(self, plan: ExecutionPlan):
        """S3 placement/traffic model for (layout x scheme), computed once
        per (inputs, layout, scheme) and shared across plans."""
        if "plan_stats" not in plan.meta:
            i = plan.inputs
            strategy = plan.strategy

            def compute():
                if strategy.layout == Layout.HCB:
                    placement = layout_hcb(i.b1, i.b2, i.nodelets)
                else:
                    placement = layout_blk(i.b1, i.b2, i.vs1.n, i.vs2.n, i.nodelets)
                return plan_stats(
                    i.vs1, i.vs2, i.b1, i.b2, placement, strategy.scheme,
                    i.nodelets, threads_per_nodelet=i.threads_per_nodelet,
                    migration_penalty=i.migration_penalty,
                )

            plan.meta["plan_stats"] = _derived_cached(
                "gsana_plan_stats", i, (strategy.layout.value, strategy.scheme.value), compute,
            )
        return plan.meta["plan_stats"]

    def traffic(self, plan: ExecutionPlan) -> TrafficStats:
        return self._plan_stats(plan).traffic

    def bytes_moved(self, plan: ExecutionPlan) -> int:
        i = plan.inputs
        return _derived_cached(
            "gsana_rw_bytes", i, None, lambda: gsana_rw_bytes(i.vs1, i.vs2, i.b1, i.b2),
        )

    def metrics(self, plan: ExecutionPlan, result: Any, seconds: float) -> dict[str, Any]:
        ps = self._plan_stats(plan)
        out = {
            "total_comparisons": ps.total_comparisons,
            "model_makespan": ps.makespan,
            "model_speedup": ps.speedup_model,
            "rw_words": ps.rw_total,
        }
        if plan.inputs.ground_truth is not None and result is not None:
            cand, _ = result
            out["recall_at_k"] = recall_at_k(cand, plan.inputs.ground_truth)
        return out


# -- registration --------------------------------------------------------------

register_op(OpSpec(
    name="spmv", factory=SpMVOp, inputs_type=SpMVInputs, cost_model=spmv_cost_model,
    grid=_spmv_grid,
))
register_op(OpSpec(
    name="bfs", factory=BFSOp, inputs_type=BFSInputs, cost_model=bfs_cost_model, grid=_bfs_grid,
))
register_op(OpSpec(
    name="gsana", factory=GSANAOp, inputs_type=GSANAInputs, cost_model=gsana_cost_model,
))
