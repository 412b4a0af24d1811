"""Mixture-of-Experts: top-k routing, capacity binning and the experts'
SwiGLU, single device.

The token -> expert routing problem is the Emu's irregular-access problem: a
token has to reach its expert's weights. The JAX package realizes three
dispatch modes on a mesh (``ep_push``, ``ep_pull``, ``tp``); the port has no
mesh yet, so :func:`moe_sublayer` always runs the single-shard semantics,
which is what the JAX package runs when the mesh's model axis is 1. An
explicit ``dispatch=`` or ``strategy=`` is accepted and gives that result.

Capacity-factor dropping keeps every shape static: a routed slot whose rank
within its expert reaches the capacity is dropped. :func:`capacity_buffers`
bins the slots without a host sync and without float atomics, so decode
does not sync once a layer and the buffers are the same on every run.

Under grad, gradients flow through the gates (softmax, the stable top-k's
values, the renormalization), :func:`capacity_buffers` and
:func:`gather_rows`. The backward of a row gather is an accumulating index
put, which on the card adds with float atomics in no fixed order: the
forward is the same on every run, the gradients only to rounding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.gsana import topk_first
from ..core.strategies import Comm, MigratoryStrategy
from ..core.util import round_up
from .config import ModelConfig
from .layers import Ctx, _normal


def dispatch_from_strategy(
    strategy: MigratoryStrategy | None, *, num_experts: int, data_axis: int
) -> str | None:
    """Map a paper strategy onto an MoE dispatch mode: S2 remote_write ->
    ep_push (all_to_all packets), S2 migrate -> ep_pull (all_gather the
    token set), and the S1-flavored ``tp`` replication fallback whenever
    expert parallelism cannot divide the data axis."""
    if strategy is None:
        return None
    if data_axis > 1 and num_experts % data_axis == 0:
        return "ep_pull" if strategy.comm == Comm.MIGRATE else "ep_push"
    return "tp"


class MoE(nn.Module):
    """``router`` (D, E) float32; ``w_gate``, ``w_up`` (E, D, F) and
    ``w_down`` (E, F, D) in the config's type, each drawn in place from
    N(0, 0.02) (the JAX package's ``moe_params`` layout)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        d, e = cfg.d_model, cfg.num_experts
        f = cfg.moe_d_ff or cfg.d_ff
        self.router = _normal((d, e), cfg, gen, device, dtype=torch.float32)
        self.w_gate = _normal((e, d, f), cfg, gen, device)
        self.w_up = _normal((e, d, f), cfg, gen, device)
        self.w_down = _normal((e, f, d), cfg, gen, device)


def _route(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor):
    """Top-k softmax gates. xt (T, D) -> gates (T, k) in xt's type, experts
    (T, k) int64."""
    return route(xt, router, cfg.experts_per_token)


def route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """Routing shared with the engine's ``moe_dispatch``: float32 logits,
    softmax, the first k of a stable descending sort (``jax.lax.top_k``'s
    order among ties, which ``torch.topk`` does not promise), gates
    renormalized."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gates, experts = topk_first(probs, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates.to(xt.dtype), experts


def _positions_in_expert(experts_flat: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Rank of each routed slot within its expert, in slot order: the
    occurrences of the same expert before it (the JAX package's cumulative
    one-hot counts). Computed from a stable sort — a slot's rank is its
    place in the sorted run of its expert — since a cumulative sum down a
    (T*k, E) one-hot is a slow outer-dimension scan on the card (13 ms a
    moonshot prefill layer). No host sync, no atomics. Returns int64."""
    del num_experts  # the ranks need only the ids
    ef = experts_flat.long()
    sorted_e, order = torch.sort(ef, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e)  # start of each slot's run
    ranks = torch.empty_like(ef)
    ranks[order] = torch.arange(ef.numel(), device=ef.device) - first
    return ranks


def _expert_ffn(w_gate, w_up, w_down, xs: torch.Tensor) -> torch.Tensor:
    """xs (E, C, D) -> (E, C, D) through each expert's SwiGLU."""
    h = F.silu(torch.bmm(xs, w_gate)) * torch.bmm(xs, w_up)
    return torch.bmm(h, w_down)


def expert_ffn(params: dict, xs: torch.Tensor) -> torch.Tensor:
    """Public expert-stack entry: each expert's SwiGLU over its capacity
    buffer. ``params`` holds ``w_gate``/``w_up`` (E, D, F) and ``w_down``
    (E, F, D); ``xs`` is (E, C, D). The engine's ``moe_dispatch`` applies
    this at the owner stage, so engine-served experts and the LM stack share
    one definition. Zero rows map to zero rows (no biases)."""
    return _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], xs)


def capacity_buffers(rows: torch.Tensor, bins: torch.Tensor, pos: torch.Tensor,
                     keep: torch.Tensor, n_bins: int, cap: int, per_row: int = 1):
    """Capacity buffers (n_bins, cap, D): routed slot i, which is row
    ``i // per_row`` of ``rows``, sits at ``(bins[i], pos[i])`` where
    ``keep[i]``; every other entry is zero. Returns (buffers, ``src``), with
    ``src`` (n_bins*cap,) the slot that fills each buffer row, -1 where none
    does.

    The buffers are a gather: each buffer row looks up its slot, so the
    work follows the buffer's size, not the slot count, and no slot row is
    repeated k times. Kept (bin, pos) pairs are unique, so a plain index
    assignment builds ``src``; every dropped slot writes one spare entry
    past the end, which is sliced off: no host sync (a boolean mask's
    ``nonzero``) and no float atomics."""
    flat = torch.where(keep, bins * cap + pos, n_bins * cap)
    src = torch.full((n_bins * cap + 1,), -1, dtype=torch.long, device=bins.device)
    src[flat] = torch.arange(bins.shape[0], device=bins.device)
    src = src[:-1]
    buf = torch.where((src >= 0)[:, None], rows[src.clamp_min(0) // per_row], 0)
    return buf.view(n_bins, cap, rows.shape[-1]), src


def gather_rows(buf: torch.Tensor, bins: torch.Tensor, pos: torch.Tensor,
                keep: torch.Tensor) -> torch.Tensor:
    """The way back from :func:`capacity_buffers`: row i is
    ``buf[bins[i], pos[i]]`` where ``keep[i]``, else zeros."""
    n_bins, cap, d = buf.shape
    rows = buf.reshape(n_bins * cap, d)[torch.where(keep, bins * cap + pos, 0)]
    return torch.where(keep[:, None], rows, 0)


def _local_dispatch(cfg: ModelConfig, xt, gates, experts, capacity):
    """Bin local tokens into per-expert buffers (drop past capacity).
    Returns (buffers (E, C, D), slot experts (T*k,), slot positions, kept)."""
    del gates
    ef = experts.reshape(-1)
    pos = _positions_in_expert(ef, cfg.num_experts)
    keep = pos < capacity
    buf, _ = capacity_buffers(xt, ef, pos, keep, cfg.num_experts, capacity, cfg.experts_per_token)
    return buf, ef, pos, keep


def _local_combine(cfg, out_buf, gates, ef, pos, keep, t, d):
    """Gather per-expert outputs back to token order, weighted by gates."""
    vals = gather_rows(out_buf, ef, pos, keep)
    return (vals * gates.reshape(-1, 1)).reshape(t, cfg.experts_per_token, d).sum(1)


def _cap(capacity_factor: float, expected_slots: float) -> int:
    """Static buffer capacity: expected slot count x factor, 8-aligned. The
    engine's ``moe_dispatch`` sizes its buffers with it too."""
    return max(8, round_up(int(capacity_factor * expected_slots), 8))


def _capacity(cfg: ModelConfig, tokens: int, experts: int) -> int:
    # the product in the JAX package's order, cf * tokens * k / E: at some
    # ratios cf * (tokens * k / E) rounds to one less before the truncation
    return _cap(1.0, cfg.capacity_factor * tokens * cfg.experts_per_token / experts)


def moe_sublayer(
    ctx: Ctx,
    p,
    x: torch.Tensor,
    *,
    dispatch: str | None = None,
    strategy: MigratoryStrategy | None = None,
) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D) through the experts of ``p`` (an object with
    ``router``, ``w_gate``, ``w_up``, ``w_down``). ``dispatch`` and
    ``strategy`` name a mode of the JAX package's mesh path; on one device
    every mode gives this single-shard result."""
    del dispatch, strategy  # one shard: every mode is the single-shard path
    cfg = ctx.cfg
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, experts = _route(cfg, xt, p.router)
    cap = _capacity(cfg, b * s, cfg.num_experts)
    buf, ef, pos, keep = _local_dispatch(cfg, xt, gates, experts, cap)
    out = _expert_ffn(p.w_gate, p.w_up, p.w_down, buf)
    return _local_combine(cfg, out, gates, ef, pos, keep, b * s, d).reshape(b, s, d)
