"""Mixture-of-Experts: top-k routing, capacity binning and the experts'
SwiGLU, on one device or on the LM's ``(data, model)`` mesh.

The token -> expert routing problem is the Emu's irregular-access problem: a
token has to reach its expert's weights. Three dispatch modes realize the
paper's strategies on the mesh, as the JAX package's ``shard_map`` bodies
do, each rank running the body on its block of tokens:

- ``ep_push`` (S2 remote-write): experts over ``data``; each rank bins its
  tokens by the owner of their expert, ``cap_pair`` slots per source ->
  owner pair, and pushes them with one ``all_to_all`` there and one back;
- ``ep_pull`` (S2 migrate): every owner ``all_gather``s all tokens, gates
  and ids over ``data``, runs its experts on the whole set, and the
  combine returns with a ``reduce_scatter`` (``psum_scatter``);
- ``tp`` (S1 replication of the expert set): every rank holds an F-slice of
  every expert; dispatch stays local and the only collective is one
  ``all_reduce`` over ``model`` per token chunk of at most 8192.

The ep modes slice the tokens (replicated over ``model``) so that each
model rank dispatches 1/ms of them, gathered back over ``model`` at the end.
With no mesh, or a model axis of 1, every mode is the single-shard path over
all tokens. The experts are stored as the rules say (EP or the tp layout)
and relaid for the mode at use.

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
from . import sharding as sh
from .config import ModelConfig
from .layers import RES, Ctx, _normal, remat, whole_positions


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


# the experts' logical storage (the JAX package's param_specs, no layer dim)
EXPERT_SPECS = {
    "w_gate": ("experts", "expert_inner", "moe_d_ff"),
    "w_up": ("experts", "expert_inner", "moe_d_ff"),
    "w_down": ("experts", "moe_d_ff", "expert_inner"),
}


def _count(ctx: Ctx, routed: int, kept: torch.Tensor) -> None:
    """Tally a mesh rank's routed and kept slots (its drop share; the
    caller sums the ranks). Not under grad: a remat recompute would count
    twice. The kept count goes to the mesh as a tensor: a rank's mesh reads
    it, a traced rank's (``launch/roofline.py``) has nothing to read."""
    if torch.is_grad_enabled():
        return
    ctx.mesh.tally("moe_routed", routed)
    ctx.mesh.tally("moe_kept", kept.sum())


def _single_shard(ctx: Ctx, router, wg, wu, wd, x: torch.Tensor, count: bool) -> torch.Tensor:
    cfg = ctx.cfg
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, experts = _route(cfg, xt, router)
    cap = _capacity(cfg, b * s, cfg.num_experts)
    buf, ef, pos, keep = _local_dispatch(cfg, xt, gates, experts, cap)
    if count:
        _count(ctx, ef.numel(), keep)
    out = _expert_ffn(wg, wu, wd, buf)
    return _local_combine(cfg, out, gates, ef, pos, keep, b * s, d).reshape(b, s, d)


def moe_sublayer(
    ctx: Ctx,
    p,
    x: torch.Tensor,
    *,
    dispatch: str | None = None,
    strategy: MigratoryStrategy | None = None,
) -> torch.Tensor:
    """x (B, S, D) in the residual layout -> (B, S, D) through the experts
    of ``p`` (an object with ``router``, ``w_gate``, ``w_up``, ``w_down``,
    stored as the rules lay them out). The mode: an explicit ``dispatch``,
    else the one ``strategy`` maps to, else ``cfg.moe_dispatch``, else the
    default strategy's (ep_push where the experts divide ``data``). With
    no mesh or a model axis of 1, the single-shard path (on a mesh over the
    gathered global batch, as the JAX package's global program computes)."""
    cfg = ctx.cfg
    ms, ds = ctx.size("model"), ctx.size("data")
    if dispatch is None:
        dispatch = dispatch_from_strategy(strategy, num_experts=cfg.num_experts, data_axis=ds)
    if dispatch is None:
        dispatch = cfg.moe_dispatch
    if dispatch is None:
        dispatch = dispatch_from_strategy(MigratoryStrategy(), num_experts=cfg.num_experts,
                                          data_axis=ds)
    if ctx.mesh is None:
        return _single_shard(ctx, p.router, p.w_gate, p.w_up, p.w_down, x, count=False)
    stored = {name: ctx.rules.spec(*spec) for name, spec in EXPERT_SPECS.items()}
    x = whole_positions(ctx, x)
    if ms == 1:
        ws = [sh.relayout(ctx.mesh, getattr(p, n), stored[n], (None, None, None))
              for n in ("w_gate", "w_up", "w_down")]
        xg = ctx.cs(x, None, None, None, src=("batch", None, None))
        out = _single_shard(ctx, p.router, *ws, xg, count=ctx.index("data") == 0)
        out = ctx.cs(out, "batch", None, None, src=(None, None, None))
    elif dispatch == "tp":
        out = _moe_tp(ctx, p, x, stored)
    elif dispatch in ("ep_push", "ep_pull"):
        out = _moe_ep(ctx, p, x, stored, push=dispatch == "ep_push")
    else:
        raise ValueError(f"unknown dispatch {dispatch}")
    return ctx.cs(out, *RES, src=("batch", None, None))


def _moe_tp(ctx: Ctx, p, x: torch.Tensor, stored: dict) -> torch.Tensor:
    """Every rank: all experts, F-sliced. Local dispatch of its tokens in
    chunks of at most 8192 and one ``all_reduce`` over ``model`` a chunk."""
    cfg, mesh = ctx.cfg, ctx.mesh
    fsl = {"w_gate": (None, None, "model"), "w_up": (None, None, "model"),
           "w_down": (None, "model", None)}
    wg, wu, wd = (sh.relayout(mesh, getattr(p, n), stored[n], fsl[n])
                  for n in ("w_gate", "w_up", "w_down"))
    bl, sl, d = x.shape
    t = bl * sl
    tcc = min(8192, t)  # token chunk: bounds dispatch buffers (grain size)
    cap_c = _capacity(cfg, tcc, cfg.num_experts)
    count = ctx.index("model") == 0

    def chunk_fn(xc):
        gates, experts = _route(cfg, xc, p.router)
        buf, ef, pos, keep = _local_dispatch(cfg, xc, gates, experts, cap_c)
        if count:
            _count(ctx, ef.numel(), keep)
        h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
        out_p = sh.psum(mesh, torch.bmm(h, wd), ("model",))  # TP reduce (dense-MLP-like)
        return _local_combine(cfg, out_p, gates, ef, pos, keep, xc.shape[0], d)

    xt = x.reshape(t, d)
    if t > tcc:
        if t % tcc:
            raise ValueError(f"tp dispatch: {t} local tokens do not split into chunks of {tcc}")
        run = remat(chunk_fn) if torch.is_grad_enabled() else chunk_fn
        out = torch.cat([run(xt[i:i + tcc]) for i in range(0, t, tcc)])
    else:
        out = chunk_fn(xt)
    return out.reshape(bl, sl, d)


def _moe_ep(ctx: Ctx, p, x: torch.Tensor, stored: dict, *, push: bool) -> torch.Tensor:
    """Expert parallelism over ``data`` (full-F experts), the tokens split
    over ``model`` when they divide (module docstring)."""
    cfg, mesh = ctx.cfg, ctx.mesh
    ds, ms = ctx.size("data"), ctx.size("model")
    e_local = cfg.num_experts // ds
    k = cfg.experts_per_token
    ep = {"w_gate": ("data", None, None), "w_up": ("data", None, None),
          "w_down": ("data", None, None)}
    wg, wu, wd = (sh.relayout(mesh, getattr(p, n), stored[n], ep[n])
                  for n in ("w_gate", "w_up", "w_down"))
    bl, sl, d = x.shape
    t_full = bl * sl
    xt = x.reshape(t_full, d)
    model_slice = ms > 1 and t_full % ms == 0 and t_full >= ms
    if model_slice:
        t = t_full // ms
        xt = xt[ctx.index("model") * t:(ctx.index("model") + 1) * t]
    else:
        t = t_full
    count = model_slice or ctx.index("model") == 0
    gates, experts = _route(cfg, xt, p.router)
    ef = experts.reshape(-1)
    owner = ef // e_local  # destination "data" shard
    shard = ctx.index("data")
    cap_e = _capacity(cfg, t * ds, cfg.num_experts)
    if push:
        cap_pair = _capacity(cfg, t, ds)  # slots per (src -> dst) pair
        pos = _positions_in_expert(owner, ds)
        keep = pos < cap_pair
        send, src = capacity_buffers(xt, owner, pos, keep, ds, cap_pair, k)
        send_e = torch.where(src >= 0, ef[src.clamp_min(0)], -1).view(ds, cap_pair)
        recv = sh.all_to_all(mesh, send, "data")  # (ds, cap_pair, d) for my experts
        recv_e = sh.all_to_all(mesh, send_e, "data").reshape(-1)
        rf = torch.where(recv_e >= 0, recv_e - shard * e_local, e_local)
        rpos = _positions_in_expert(rf, e_local + 1)
        rkeep = (rf < e_local) & (rpos < cap_e)
        if count:
            _count(ctx, ef.numel(), rkeep)
        buf, _ = capacity_buffers(recv.reshape(-1, d), rf, rpos, rkeep, e_local, cap_e)
        out_buf = _expert_ffn(wg, wu, wd, buf)
        out_slots = gather_rows(out_buf, rf, rpos, rkeep).view(ds, cap_pair, d)
        back = sh.all_to_all(mesh, out_slots, "data")
        vals = gather_rows(back, owner, pos, keep)
        out = (vals * gates.reshape(-1, 1)).reshape(t, k, d).sum(1)
    else:
        xg = sh.all_gather(mesh, xt, ("data",))  # (t*ds, d)
        gg = sh.all_gather(mesh, gates.reshape(-1), ("data",))
        eg = sh.all_gather(mesh, ef, ("data",))
        mine = (eg // e_local) == shard
        le = torch.where(mine, eg - shard * e_local, e_local)
        pos = _positions_in_expert(le, e_local + 1)
        keep = mine & (pos < cap_e)
        if count:
            _count(ctx, ef.numel(), keep)
        buf, _ = capacity_buffers(xg, le, pos, keep, e_local, cap_e, k)
        out_buf = _expert_ffn(wg, wu, wd, buf)
        vals = gather_rows(out_buf, le, pos, keep) * gg[:, None]
        contrib = vals.reshape(ds, t, k, d).sum(2)  # (ds, t, d) per source
        out = sh.reduce_scatter(mesh, contrib, ("data",), 0)[0]
    if model_slice:
        out = sh.all_gather(mesh, out, ("model",))  # the model ranks' token slices
    return out.reshape(bl, sl, d)
