"""The engine's plan -> compile -> execute pipeline behind ``engine.run``.

    result, report = run(Request("spmv", SpMVInputs(a, x), strategy, "cuda"))

The stages are individually exposed:

- :func:`build_plan`   — bind op + inputs + strategy to a substrate executor
  (``strategy="auto"`` routes through the autotuner).
- :func:`compile_plan` — resolve the executor through a
  :class:`~repro_torch.engine.cache.PlanCache`; a hit reuses it.
- :func:`execute` / :func:`run` — timed execution. Defaults
  (``iters=3, warmup=1``) report *steady-state* medians with the first call
  of a new executor (kernel builds included) split into
  ``RunReport.compile_seconds``; ``iters=1, warmup=0`` times one cold call.
- :func:`single_call` — one timed call through the cache: the unit of work
  of the service's pipeline stages.

A timed call ends in a synchronize of the *current stream* when its result
lies on the card, so ``seconds`` is the call's device time plus host
overhead, never just the time to enqueue — and never another stream's
work: the service runs each pool slot on a stream of its own, and a slot's
``seconds`` must not include the kernels of the other slots.
"""
from __future__ import annotations

import time
from typing import Any

import torch

from .. import trace
from ..core.strategies import MigratoryStrategy
from ..machine.perfmodel import maybe_predict_plan_seconds
from . import decode_op as _decode_op  # noqa: F401  (imports register the built-in OpSpecs)
from . import moe_op as _moe_op  # noqa: F401
from . import ops as _ops  # noqa: F401
from .api import ExecutionPlan, MigratoryOp, RunReport
from .cache import CompiledPlan, PlanCache, default_cache
from .registry import default_registry
from .request import Request
from .substrate import Substrate, get_substrate


def resolve_op(op: "MigratoryOp | str") -> MigratoryOp:
    """Name -> MigratoryOp via the registry's OpSpec; instances pass through."""
    if isinstance(op, str):
        return default_registry().op_spec(op).factory()
    return op


def resolve_strategy(
    op: MigratoryOp,
    inputs: Any,
    strategy: "MigratoryStrategy | str | None",
    substrate: Substrate,
) -> MigratoryStrategy:
    """None -> paper defaults; ``"auto"`` -> autotuner pick (ranked in
    predicted seconds for ``substrate`` when a calibrated machine file is
    present, in traffic units otherwise)."""
    if strategy is None:
        return MigratoryStrategy()
    if isinstance(strategy, str):
        if strategy != "auto":
            raise ValueError(f"unknown strategy {strategy!r}; expected 'auto'")
        from .autotune import choose_strategy

        return choose_strategy(op, inputs, substrate)
    if not isinstance(strategy, MigratoryStrategy):
        raise ValueError(f"strategy must be a MigratoryStrategy, 'auto' or None, got {strategy!r}")
    return strategy


def build_plan(
    op: "MigratoryOp | str",
    inputs: Any,
    strategy: "MigratoryStrategy | str | None" = None,
    substrate: "Substrate | str" = "local",
) -> ExecutionPlan:
    """Stage 1: plan. Resolve op/strategy/substrate and bind the inputs."""
    with trace.span("engine.plan"):
        op, sub = resolve_op(op), get_substrate(substrate)
        return op.plan(inputs, resolve_strategy(op, inputs, strategy, sub), sub)


def compile_plan(
    plan: ExecutionPlan, cache: PlanCache | None = None, *, slot: "int | None" = None,
) -> CompiledPlan:
    """Stage 2: resolve the plan's executor through the cache. ``slot``
    tags the entry with the executor-pool slot doing the resolving
    (placement pinning)."""
    with trace.span("engine.lookup"):
        return (default_cache() if cache is None else cache).get(plan, slot=slot)


def _block(result: Any) -> Any:
    """Wait for the current stream when the result lies on the card (the
    counterpart of ``jax.block_until_ready``). Only that stream: other
    streams' work is not this call's."""
    first = result[0] if isinstance(result, tuple) else result
    trace.count("sync.block")
    if isinstance(first, torch.Tensor) and first.is_cuda:
        torch.cuda.current_stream(first.device).synchronize()
    return result


def _timed_call(compiled: CompiledPlan, times: list[float]) -> Any:
    t0 = time.perf_counter()
    result = _block(compiled())
    times.append(time.perf_counter() - t0)
    return result


def execute(
    compiled: "CompiledPlan | ExecutionPlan",
    *,
    iters: int = 3,
    warmup: int = 1,
    cache: PlanCache | None = None,
) -> tuple[Any, float, float]:
    """Stage 3: execute. Returns ``(result, seconds, compile_seconds)``.

    ``seconds`` is the median of ``iters`` timed calls after ``warmup``
    unmeasured ones. On a cache miss the first call is recorded as
    ``compile_seconds`` and doubles as the first warmup call — or, with
    ``warmup=0``, lands inside the timed set.
    """
    cache = default_cache() if cache is None else cache
    if isinstance(compiled, ExecutionPlan):
        compiled = compile_plan(compiled, cache)
    timed: list[float] = []
    compile_seconds = 0.0
    result = None
    n_warm = warmup
    with trace.span("engine.execute"):
        if not compiled.cache_hit:
            first: list[float] = []
            result = _timed_call(compiled, first)
            compile_seconds = first[0]
            cache.note_compiled(compiled, compile_seconds)
            if warmup > 0:
                n_warm = warmup - 1  # the first call was the first warmup
            else:
                timed.append(compile_seconds)  # cold-timing mode
        for _ in range(n_warm):
            result = _timed_call(compiled, [])
        for _ in range(max(1, iters) - len(timed)):
            result = _timed_call(compiled, timed)
    timed.sort()
    return result, timed[len(timed) // 2], compile_seconds


def single_call(
    plan: ExecutionPlan,
    op: MigratoryOp,
    *,
    cache: PlanCache | None = None,
    slot: "int | None" = None,
) -> tuple[Any, RunReport]:
    """One timed call through the cache — the unit of work of the
    service's pipeline stages.

    On a *cold* plan this call is the **compile** stage: its one timed call
    is the executor's first (kernel builds included), and the report
    carries ``cache_hit=False, seconds == compile_seconds``. On a *warm*
    plan it is the **execute** stage: a steady-state call with
    ``cache_hit=True, compile_seconds=0.0``. Each request still runs
    exactly the call sequence the synchronous path would have run, so the
    service's results equal ``run``'s.

    ``slot`` is the placement tag: the executor-pool worker making the
    call. A first call pins the cache entry to it; a stolen execution
    passes its own slot but the pin stays where it was.
    """
    return run_plan(plan, op, iters=1, warmup=0, cache=cache, slot=slot)


def run_plan(
    plan: ExecutionPlan,
    op: MigratoryOp,
    *,
    iters: int = 3,
    warmup: int = 1,
    cache: PlanCache | None = None,
    slot: "int | None" = None,
) -> tuple[Any, RunReport]:
    """Compile + execute an already-built plan and assemble its RunReport."""
    compiled = compile_plan(plan, cache, slot=slot)
    result, seconds, compile_seconds = execute(compiled, iters=iters, warmup=warmup, cache=cache)
    with trace.span("engine.account"):
        report = RunReport.from_parts(
            op=op.name,
            strategy=plan.strategy,
            substrate=plan.substrate,
            seconds=seconds,
            traffic=op.traffic(plan),
            bytes_moved=op.bytes_moved(plan),
            metrics=op.metrics(plan, result, seconds),
            cache_hit=compiled.cache_hit,
            compile_seconds=compile_seconds,
            # None (and absent from to_dict) unless a calibrated machine file exists
            predicted_seconds=maybe_predict_plan_seconds(op, plan),
        )
    return result, report


def run(
    request: Request,
    *,
    iters: int = 3,
    warmup: int = 1,
    cache: PlanCache | None = None,
) -> tuple[Any, RunReport]:
    """Execute one :class:`~repro_torch.engine.request.Request`; return
    ``(result, RunReport)``.

    ``iters``/``warmup``: the defaults time steady state (median of 3 after
    1 warmup) with the first call split out; ``iters=1, warmup=0`` times one
    cold call. ``cache``: plan cache override (default: the process-wide one).
    """
    if not isinstance(request, Request):
        raise TypeError(f"run takes a Request, got {type(request).__name__}")
    with trace.request("engine.run"):
        op = resolve_op(request.op)
        substrate = request.substrate if request.substrate is not None else "local"
        plan = build_plan(op, request.inputs, request.strategy, substrate)
        return run_plan(plan, op, iters=iters, warmup=warmup, cache=cache)


run_request = run
