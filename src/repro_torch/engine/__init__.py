"""The port's engine: one substrate-dispatched entry point for the paper's
three irregular algorithms and the MoE ops (``moe_dispatch``,
``moe_decode``, served in continuous batches by :class:`DecodeServer`), with
the paper's traffic and bandwidth accounting and an explicit plan -> compile
-> execute pipeline.

    from repro_torch.engine import Request, run, SpMVInputs
    y, report = run(Request("spmv", SpMVInputs(a, x), strategy, "cuda"))
    y, report = run(Request("spmv", SpMVInputs(a, x), "auto", "cuda"))  # autotuned
    print(report.to_json())

    svc = EngineService(substrate="cuda", workers=2).start()   # the serving plane
    resp = svc.submit(Request("spmv", SpMVInputs(a, x))).result(timeout=60)
    svc.stop()

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
from .decode import DecodeServer
from .decode_op import (
    MoEDecodeInputs,
    MoEDecodeOp,
    moe_decode_cost_model,
    moe_decode_reference,
    moe_decode_traffic,
)
from .moe_op import (
    MoEDispatchInputs,
    MoEDispatchOp,
    moe_dispatch_cost_model,
    moe_dispatch_grid,
    moe_dispatch_reference,
    moe_dispatch_traffic,
)
from .probes import ProbeStore, default_probe_store
from .registry import (
    KernelRegistry, OpSpec, capabilities, default_registry, kernel, placement_table, register_op,
)
from .request import Request
from .runner import (
    build_plan, compile_plan, execute, resolve_op, run, run_plan, run_request, single_call,
)
from .service import (
    AdmissionError,
    EngineService,
    ServiceFuture,
    ServiceRequest,
    ServiceResponse,
    ServiceStats,
    ServiceStopped,
    ServiceTimeout,
)
from .substrate import (
    CudaSubstrate,
    LocalSubstrate,
    MeshSubstrate,
    Substrate,
    get_substrate,
    list_substrates,
    register_substrate,
    substrate_for_mesh,
)
from .wire import (
    WIRE_VERSION,
    SegmentTable,
    WireError,
    canonical_bytes,
    collect_blob_digests,
    content_digest,
    decode_value,
    encode_value,
)

__all__ = [
    "AdmissionError", "AutotuneResult", "BFSInputs", "BFSOp", "CUDA_BLOCK_CANDIDATES",
    "CompiledPlan", "CudaSubstrate", "DecodeServer", "EngineService", "ExecutionPlan",
    "GRAIN_CANDIDATES", "GSANAInputs", "GSANAOp", "KernelRegistry", "LocalSubstrate",
    "MeshSubstrate", "MigratoryOp", "MoEDecodeInputs", "MoEDecodeOp", "MoEDispatchInputs",
    "MoEDispatchOp",
    "OpNotSupportedError", "OpSpec", "PlanCache", "ProbeStore", "RankedCandidate", "Request",
    "RunReport", "SegmentTable", "ServiceFuture", "ServiceRequest", "ServiceResponse",
    "ServiceStats", "ServiceStopped", "ServiceTimeout", "SpMVInputs", "SpMVOp", "Substrate",
    "WIRE_VERSION", "WireError", "args_signature", "autotune", "build_plan", "candidate_grid",
    "canonical_bytes", "capabilities", "choose_strategy", "collect_blob_digests",
    "compile_plan", "content_digest", "decode_value", "default_cache", "default_probe_store",
    "default_registry", "encode_value", "execute", "get_substrate", "kernel",
    "list_substrates", "moe_decode_cost_model", "moe_decode_reference", "moe_decode_traffic",
    "moe_dispatch_cost_model", "moe_dispatch_grid", "moe_dispatch_reference",
    "moe_dispatch_traffic", "placement_table", "plan_key", "rank_strategies", "register_op",
    "register_substrate", "resolve_op", "run", "run_plan", "run_request", "single_call",
    "strategy_dict", "substrate_for_mesh",
]
