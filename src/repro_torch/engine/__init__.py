"""The port's engine: one substrate-dispatched entry point for the paper's
three irregular algorithms, with the paper's traffic and bandwidth
accounting and an explicit plan -> compile -> execute pipeline.

    from repro_torch.engine import Request, run, SpMVInputs
    y, report = run(Request("spmv", SpMVInputs(a, x), strategy, "cuda"))
    y, report = run(Request("spmv", SpMVInputs(a, x), "auto", "cuda"))  # autotuned
    print(report.to_json())

Ops and substrates meet only in the kernel registry
(:mod:`repro_torch.engine.registry`); :func:`capabilities` is the table of
who runs what.
"""
from .api import (
    ExecutionPlan,
    MigratoryOp,
    OpNotSupportedError,
    RunReport,
    args_signature,
    plan_key,
    strategy_dict,
)
from .autotune import (
    AutotuneResult,
    RankedCandidate,
    autotune,
    candidate_grid,
    choose_strategy,
    rank_strategies,
)
from .cache import CompiledPlan, PlanCache, default_cache
from .ops import (
    CUDA_BLOCK_CANDIDATES,
    GRAIN_CANDIDATES,
    BFSInputs,
    BFSOp,
    GSANAInputs,
    GSANAOp,
    SpMVInputs,
    SpMVOp,
)
from .probes import ProbeStore, default_probe_store
from .registry import KernelRegistry, OpSpec, capabilities, default_registry, kernel, register_op
from .request import Request
from .runner import build_plan, compile_plan, execute, resolve_op, run, run_plan, run_request
from .substrate import (
    CudaSubstrate,
    LocalSubstrate,
    Substrate,
    get_substrate,
    list_substrates,
    register_substrate,
)

__all__ = [
    "AutotuneResult", "BFSInputs", "BFSOp", "CUDA_BLOCK_CANDIDATES", "CompiledPlan",
    "CudaSubstrate", "ExecutionPlan", "GRAIN_CANDIDATES", "GSANAInputs", "GSANAOp",
    "KernelRegistry", "LocalSubstrate", "MigratoryOp", "OpNotSupportedError", "OpSpec",
    "PlanCache", "ProbeStore", "RankedCandidate", "Request", "RunReport", "SpMVInputs",
    "SpMVOp", "Substrate", "args_signature", "autotune", "build_plan", "candidate_grid",
    "capabilities", "choose_strategy", "compile_plan", "default_cache", "default_probe_store",
    "default_registry", "execute", "get_substrate", "kernel", "list_substrates", "plan_key",
    "rank_strategies", "register_op", "register_substrate", "resolve_op", "run", "run_plan",
    "run_request", "strategy_dict",
]
