"""One MoE decode step as an engine op (``moe_decode``).

``moe_decode`` runs a compact one-block MoE LM decode step for a continuous
batch of sequences: embed the current token of every batch slot, one
single-head attention sublayer over each slot's KV cache (each slot carries
its own ``positions`` write cursor, so sequences at different depths share
one step), then the MoE sublayer through the ``moe_dispatch`` machinery
(routing, capacity binning, the S2 exchanges and the experts' SwiGLU), and
the lm_head. The steps outside the dispatch are :func:`_decode_pre` and
:func:`_decode_post`, the same functions in every route (on the mesh they
run on the caller, the dispatch on the ranks), so a served step is
bit-identical to :func:`moe_decode_reference` in all three dispatch modes.

Params come from :func:`repro_torch.models.transformer.moe_decode_params`
for a :class:`~repro_torch.models.config.ModelConfig` (``serve-moe``). The
op returns ``(logits (B, V), new_k (B, S, D), new_v (B, S, D))``: the
caches are new tensors and the inputs stay as they were, so the caller (the
:class:`~repro_torch.engine.decode.DecodeServer`) threads them back in on
the next submit. A ``local`` and a ``mesh`` kernel are registered (the JAX
package's ``pallas`` has none either): ``CudaSubstrate`` raises
:class:`~repro_torch.engine.api.OpNotSupportedError`, and on the card the
op runs on ``LocalSubstrate("cuda")`` or ``MeshSubstrate("cuda")``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.cost import CostEstimate
from ..core.strategies import MigratoryStrategy, TrafficStats
from ..models.layers import rmsnorm
from ..models.moe import dispatch_from_strategy
from ..models.transformer import MOE_DECODE_PARAM_KEYS
from .api import ExecutionPlan, plan_key
from .moe_op import _dispatch_local, _dispatch_mesh, moe_dispatch_grid
from .registry import OpSpec, kernel, register_op
from .substrate import MeshSubstrate, Substrate



@dataclasses.dataclass(frozen=True)
class MoEDecodeInputs:
    """One continuous-batched decode step. ``tokens``/``positions`` are
    (B,) integer tensors — the current token and KV write cursor of every
    batch slot (padded slots decode garbage that the server ignores; they
    must be deterministic so the oracle replay stays bit-identical).
    ``k_cache``/``v_cache`` are (B, S, D). ``nodelets`` is the
    expert-parallel width the dispatch maps onto; B must divide by it."""

    params: dict
    tokens: torch.Tensor
    k_cache: torch.Tensor
    v_cache: torch.Tensor
    positions: torch.Tensor
    nodelets: int = 1
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    norm_eps: float = 1e-5

    @property
    def num_experts(self) -> int:
        return int(self.params["router"].shape[-1])


def derive_decode_mode(inputs: MoEDecodeInputs, strategy: MigratoryStrategy) -> str:
    """Same strategy -> dispatch-mode mapping as ``moe_dispatch``."""
    return dispatch_from_strategy(
        strategy, num_experts=inputs.num_experts, data_axis=inputs.nodelets
    )


# -- the decode math (dispatch-agnostic) ---------------------------------------------


def _decode_pre(p, tokens, k_cache, v_cache, positions, *, norm_eps):
    """Embed -> attention over the cache -> residual + pre-MoE norm. The
    caches come back as new tensors holding this step's k and v."""
    B, S, D = k_cache.shape
    x = p["embed"][tokens.long()]  # (B, D)
    h = rmsnorm(x, p["ln1"], norm_eps)
    q = h @ p["wq"]
    b, pos = torch.arange(B, device=x.device), positions.long()
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    k_cache[b, pos] = (h @ p["wk"]).to(k_cache.dtype)
    v_cache[b, pos] = (h @ p["wv"]).to(v_cache.dtype)
    s = torch.einsum("bd,bsd->bs", q.float(), k_cache.float()) * D ** -0.5
    mask = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    att = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1).to(x.dtype)
    x = x + torch.einsum("bs,bsd->bd", att, v_cache) @ p["wo"]
    return x, rmsnorm(x, p["ln2"], norm_eps), k_cache, v_cache


def _decode_post(p, x, expert_out, *, norm_eps):
    """MoE residual -> final norm -> lm_head."""
    x = x + expert_out
    return rmsnorm(x, p["ln_f"], norm_eps) @ p["lm_head"]


@torch.inference_mode()
def _decode_step(
    params, tokens, k_cache, v_cache, positions, *,
    mode, nodelets, experts_per_token, capacity_factor, norm_eps, mesh=None,
):
    """One step: the attention and the head here, the dispatch emulated
    here too, or on ``mesh``'s ranks when given."""
    x, h2, k_cache, v_cache = _decode_pre(
        params, tokens, k_cache, v_cache, positions, norm_eps=norm_eps
    )
    args = (h2, params["router"], params["w_gate"], params["w_up"], params["w_down"])
    kw = dict(mode=mode, nodelets=nodelets, experts_per_token=experts_per_token,
              capacity_factor=capacity_factor)
    out = _dispatch_local(*args, **kw) if mesh is None else _dispatch_mesh(*args, **kw, mesh=mesh)
    return _decode_post(params, x, out, norm_eps=norm_eps), k_cache, v_cache


# -- kernels ---------------------------------------------------------------------------


@kernel("moe_decode", "local")
def _moe_decode_local(
    sub: Substrate, params, tokens, k_cache, v_cache, positions, *,
    strategy, nodelets, experts_per_token, capacity_factor, norm_eps,
):
    mode = dispatch_from_strategy(
        strategy, num_experts=int(params["router"].shape[-1]), data_axis=nodelets
    )
    return _decode_step(
        params, tokens, k_cache, v_cache, positions, mode=mode,
        nodelets=nodelets, experts_per_token=experts_per_token,
        capacity_factor=capacity_factor, norm_eps=norm_eps,
    )


@kernel("moe_decode", "mesh")
def _moe_decode_mesh(
    sub: MeshSubstrate, params, tokens, k_cache, v_cache, positions, *,
    strategy, nodelets, experts_per_token, capacity_factor, norm_eps,
):
    mode = dispatch_from_strategy(
        strategy, num_experts=int(params["router"].shape[-1]), data_axis=nodelets
    )
    return _decode_step(
        params, tokens, k_cache, v_cache, positions, mode=mode,
        nodelets=nodelets, experts_per_token=experts_per_token,
        capacity_factor=capacity_factor, norm_eps=norm_eps,
        mesh=sub.mesh_of_width(nodelets, "moe_decode"),
    )


def moe_decode_reference(
    inputs: MoEDecodeInputs, strategy: MigratoryStrategy | None = None
) -> tuple:
    """The single-process oracle: the decode math with the local dispatch,
    which every served decode step must bit-match."""
    strategy = strategy if strategy is not None else MigratoryStrategy()
    return _decode_step(
        inputs.params, inputs.tokens, inputs.k_cache, inputs.v_cache,
        inputs.positions, mode=derive_decode_mode(inputs, strategy),
        nodelets=inputs.nodelets, experts_per_token=inputs.experts_per_token,
        capacity_factor=inputs.capacity_factor, norm_eps=inputs.norm_eps,
    )


# -- traffic model ------------------------------------------------------------------


def moe_decode_traffic(inputs: MoEDecodeInputs, strategy: MigratoryStrategy) -> TrafficStats:
    """Analytic dispatch traffic of one decode step (T = B tokens). Unlike
    ``moe_dispatch`` there is no host routing replay — the serving plane
    submits a fresh step every few milliseconds, so the model uses the
    uniform-routing expectation for push mode: of the T*k kept slots, a
    (P-1)/P fraction lands off-shard. Pull mode is exact (routing-free)."""
    P, k = inputs.nodelets, inputs.experts_per_token
    T = int(inputs.tokens.shape[0])
    D = int(inputs.k_cache.shape[-1])
    itemsize = inputs.k_cache.element_size()
    mode = derive_decode_mode(inputs, strategy)
    if mode == "tp":
        return TrafficStats(0, 0, 0)
    if mode == "ep_push":
        remote = int(T * k * (P - 1) / P)
        return TrafficStats(
            migrations=0,
            remote_writes=remote,
            collective_bytes=remote * (2 * D * itemsize + 4),
        )
    gather = T * (P - 1) * D * itemsize + T * k * (P - 1) * 4
    ret = T * k * (P - 1) * D * itemsize
    return TrafficStats(migrations=T * (P - 1), remote_writes=0, collective_bytes=gather + ret)


def moe_decode_cost_model(inputs: MoEDecodeInputs):
    """Autotuner factory: rank S2 modes by modeled dispatch traffic (the
    rest of the step is mode-invariant compute)."""
    T = int(inputs.tokens.shape[0])
    B, S, D = inputs.k_cache.shape
    # mode-invariant working set: both caches read + written, activations
    stage_bytes = 4 * int(B) * int(S) * int(D) * inputs.k_cache.element_size()

    def estimate(st: MigratoryStrategy) -> CostEstimate:
        traffic = moe_decode_traffic(inputs, st)
        mode = derive_decode_mode(inputs, st)
        launches = {"tp": 0, "ep_push": 3, "ep_pull": 2}[mode]
        return CostEstimate(
            strategy=st,
            traffic_bytes=traffic.total_bytes,
            balance_penalty=0.0,
            detail={
                "dispatch_mode": mode,
                "migrations": traffic.migrations,
                "batch": T,
                "collective_launches": launches,
                "memory_bytes_per_launch": stage_bytes,
                "memory_access": "stream",
            },
            traffic=traffic,
        )

    return estimate


# -- the op ---------------------------------------------------------------------------


class MoEDecodeOp:
    """MigratoryOp adapter: one continuous-batched MoE decode step."""

    name = "moe_decode"

    def plan(
        self, inputs: MoEDecodeInputs, strategy: MigratoryStrategy, substrate: Substrate,
    ) -> ExecutionPlan:
        B = int(inputs.tokens.shape[0])
        if B % inputs.nodelets != 0:
            raise ValueError(
                f"moe_decode needs B % nodelets == 0, got B={B}, nodelets={inputs.nodelets}"
            )
        missing = [k for k in MOE_DECODE_PARAM_KEYS if k not in inputs.params]
        if missing:
            raise ValueError(
                f"moe_decode params missing {missing}; build them with "
                "repro_torch.models.transformer.moe_decode_params(cfg, seed, device)"
            )
        substrate.check_inputs(inputs.tokens, inputs.k_cache, inputs.v_cache, inputs.positions,
                               *(inputs.params[k] for k in MOE_DECODE_PARAM_KEYS))
        kern = substrate.kernel(self.name)
        args = (inputs.params, inputs.tokens, inputs.k_cache, inputs.v_cache, inputs.positions)
        statics = (inputs.nodelets, inputs.experts_per_token, inputs.capacity_factor,
                   inputs.norm_eps)
        nodelets, k, cf, eps = statics
        return ExecutionPlan(
            op=self.name,
            strategy=strategy,
            substrate=substrate.name,
            inputs=inputs,
            executor=lambda p, t, kc, vc, pos: kern(
                p, t, kc, vc, pos, strategy=strategy, nodelets=nodelets,
                experts_per_token=k, capacity_factor=cf, norm_eps=eps,
            ),
            args=args,
            meta={"mode": derive_decode_mode(inputs, strategy)},
            key=plan_key(self.name, substrate, strategy, args, static=statics),
        )

    def traffic(self, plan: ExecutionPlan) -> TrafficStats:
        return moe_decode_traffic(plan.inputs, plan.strategy)

    def bytes_moved(self, plan: ExecutionPlan) -> int:
        """Useful bytes of one step: full param read + caches read/written
        + logits written."""
        i = plan.inputs
        B, S, D = i.k_cache.shape
        it = i.k_cache.element_size()
        params_bytes = sum(w.numel() * w.element_size() for w in i.params.values())
        V = int(i.params["lm_head"].shape[-1])
        return params_bytes + 4 * int(B) * int(S) * int(D) * it + int(B) * V * it

    def metrics(self, plan: ExecutionPlan, result: Any, seconds: float) -> dict[str, Any]:
        i = plan.inputs
        B, S, D = i.k_cache.shape
        return {
            "dispatch_mode": plan.meta["mode"],
            "experts": i.num_experts,
            "nodelets": i.nodelets,
            "batch": int(B),
            "cache_len": int(S),
            "tokens_per_second": int(B) / seconds if seconds > 0 else 0.0,
        }


register_op(OpSpec(
    name="moe_decode",
    factory=MoEDecodeOp,
    inputs_type=MoEDecodeInputs,
    cost_model=moe_decode_cost_model,
    grid=moe_dispatch_grid,
))
