"""RWKV-6 "Finch": data-dependent-decay linear attention (attention-free).

The recurrence S_t = diag(w_t) S_{t-1} + k_t v_t^T runs in chunks of
``cfg.ssm_chunk`` tokens at prefill and in training: within a chunk a
strictly lower (c x c) matrix of decay ratios exp(L_{t-1} - L_i) (float32,
L the cumulative log decay), across chunks the carried (M x M) state a
head. Decode takes the exact one-token recurrence.

Functions take ``(ctx, params, ...)`` with ``params`` an :class:`RWKV6`;
``prefill`` and ``decode_step`` run under ``torch.inference_mode()``.

On the ``(data, model)`` mesh (``models/layers.py``) the residual stream is
in the residual layout between sublayers. Each sublayer gathers its input's
positions (the token shift and the scan run along the whole sequence), and
its weights are gathered to their layout at use. The time mix projects
column-parallel: a rank computes its ``d / model`` columns of r, k, v, g and
of the decay (the ``heads`` layout), and runs the scan over a block of
``ceil(H / model)`` whole heads, the heads padded with zero heads at the end
where ``model`` does not divide them, as GSPMD splits an uneven dim
(:func:`_to_heads`; the block is the ``heads`` layout itself where it does
divide). Over a sequence the decay LoRA's down-projection runs over the
rank's block of the rows (gathered before the up-projection); one token's
runs on every row. Where the heads are padded the decode state holds every
head on every ``model`` rank (``heads4d`` unsharded, the reference's
``state_specs``): a decode step takes its block and gathers it back. The
mixes ``mu_*`` and ``cmu_*`` are stored sharded over d but multiply the
whole input, so they are gathered whole. ``w_o`` and the channel mix's
``cw_v`` are row-parallel: their partial sums are reduced into the residual
layout, and the channel mix's gate ``sigmoid(xr @ cw_r)`` is relaid there
from its columns before the product.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from . import sharding as sh
from .config import ModelConfig
from .layers import (
    RES, Ctx, RMSNorm, _normal, dtype_of, generator, remat, rmsnorm, whole_positions,
)
from .losses import chunked_cross_entropy
from .transformer import _embed, _last_position, _unembed

HEAD = 64  # rwkv6 head size M
LORA = 32  # rank of the decay LoRA
#: the token-shift mixes: stored sharded over d, used whole
MIXES = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "cmu_k", "cmu_r")


class RWKVState(NamedTuple):
    s: torch.Tensor  # (L, B, H, M, M) wkv state, float32
    tm_x: torch.Tensor  # (L, B, D) last input seen by time-mix (token shift)
    cm_x: torch.Tensor  # (L, B, D) last input seen by channel-mix


class Block(nn.Module):
    """One layer: ``ln1``, the time-mix (``mu_*`` at 0.5, ``w_r/k/v/g/o``
    (D, D), the decay ``w_decay`` at -1 and its LoRA ``w_lora_a`` (D, 32)
    and ``w_lora_b`` (32, D), the bonus ``u_bonus`` at 0, ``ln_x``), ``ln2``
    and the channel-mix (``cmu_k``, ``cmu_r``, ``cw_k`` (D, F), ``cw_v``
    (F, D), ``cw_r`` (D, D)). ``w_decay``, ``w_lora_b`` and ``u_bonus`` are
    float32 whatever the config's type."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, dtype_of(cfg)

        def full(value, dtype=dt):
            return nn.Parameter(torch.full((d,), value, dtype=dtype, device=device))

        self.ln1 = RMSNorm(cfg, d, device)
        self.ln2 = RMSNorm(cfg, d, device)
        for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
            setattr(self, name, full(0.5))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, _normal((d, d), cfg, gen, device))
        self.w_decay = full(-1.0, torch.float32)  # base log-decay
        self.w_lora_a = _normal((d, LORA), cfg, gen, device)
        self.w_lora_b = _normal((LORA, d), cfg, gen, device, dtype=torch.float32)
        self.u_bonus = full(0.0, torch.float32)
        self.ln_x = RMSNorm(cfg, d, device)  # per-head group norm (rms)
        self.cmu_k = full(0.5)
        self.cmu_r = full(0.5)
        self.cw_k = _normal((d, f), cfg, gen, device)
        self.cw_v = _normal((f, d), cfg, gen, device)
        self.cw_r = _normal((d, d), cfg, gen, device)


class RWKV6(nn.Module):
    """The weights: ``embed`` (V, D), ``blocks.<i>`` (:class:`Block`),
    ``final_norm``, ``lm_head`` (D, V); matrices from N(0, 0.02) by a
    generator seeded with ``seed`` on ``device``."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.d_model % HEAD:
            raise ValueError(f"{cfg.name}: d_model {cfg.d_model} is not a multiple of {HEAD}")
        dev = resolve_device(device)
        gen = generator(dev, seed)
        self.cfg = cfg
        self.embed = _normal((cfg.vocab_size, cfg.d_model), cfg, gen, dev)
        self.blocks = nn.ModuleList(Block(cfg, gen, dev) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg, cfg.d_model, dev)
        self.lm_head = _normal((cfg.d_model, cfg.vocab_size), cfg, gen, dev)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> RWKV6:
    return RWKV6(cfg, seed=seed, device=device)


def _shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """Token shift: the x_{t-1} stream, after ``last`` (the previous call's
    last input, zeros at the start)."""
    head = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :].to(x.dtype)
    return torch.cat([head, x[:, :-1]], dim=1)


def _chunk(state, rr, kk, vv, ll, u, strict):
    """One chunk of the WKV recurrence. state (B, H, M, M); rr, kk, vv, ll
    (B, c, H, M) float32 (ll the log decays); u (H, M). Returns (o (B, c,
    H, M), the state after the chunk)."""
    L_inc = torch.cumsum(ll, dim=1)
    L_exc = L_inc - ll  # L_{t-1}
    q_dec = (rr * L_exc.exp()).permute(0, 2, 1, 3)  # (B, H, c, M)
    k_dec = (kk * (-L_inc).exp()).permute(0, 2, 3, 1)  # (B, H, M, c)
    vh = vv.permute(0, 2, 1, 3)  # (B, H, c, M)
    A = torch.matmul(q_dec, k_dec).masked_fill(~strict, 0.0)  # (B, H, t, i), i < t
    diag = torch.linalg.vecdot(rr * u, kk).permute(0, 2, 1)  # (B, H, t): the bonus term
    o = torch.matmul(A, vh) + diag[..., None] * vh + torch.matmul(q_dec, state)
    last = L_inc[:, -1]  # (B, H, M)
    k_tail = (kk * (last[:, None] - L_inc).exp()).permute(0, 2, 3, 1)  # (B, H, M, c)
    state = state * last.exp()[..., None] + torch.matmul(k_tail, vh)
    return o.permute(0, 2, 1, 3), state


def _weights(ctx: Ctx, p: Block):
    """The block's weights in their layout at use (``p`` itself without a
    mesh); on a mesh the mixes gathered whole, in one collective."""
    if ctx.mesh is None:
        return p
    w = ctx.gathered(p, block_param_specs())
    mixes = ctx.cols(torch.stack([getattr(w, n) for n in MIXES]), None, "heads")
    for name, t in zip(MIXES, mixes):
        setattr(w, name, t)
    return w


def _blocks(ctx: Ctx) -> tuple[int, int, int]:
    """(H, n, ch): the heads, the ranks of the ``heads`` axes (1 without a
    mesh), and the heads a rank's scan runs, ``ceil(H / n)``."""
    h = ctx.cfg.d_model // HEAD
    n = 1 if ctx.mesh is None else sh.axis_size(ctx.mesh, ctx.axes("heads"))
    return h, n, -(-h // n)


def _padded(ctx: Ctx) -> bool:
    """Whether the scan's heads are padded: ``n`` does not divide them, so a
    rank's block of whole heads is not its ``heads`` columns."""
    h, n, _ = _blocks(ctx)
    return h % n != 0


def _to_heads(ctx: Ctx, t: torch.Tensor, src: "str | None" = "heads") -> torch.Tensor:
    """t's last dim (the d channels, laid out as ``src``) as this rank's
    block of the scan's heads: its ``heads`` columns where ``n`` divides the
    heads, else every channel, padded with zero heads to ``n * ch`` and the
    rank's ``ch`` kept (GSPMD's split of an uneven dim)."""
    if not _padded(ctx):
        return ctx.cols(t, "heads", src)
    h, n, ch = _blocks(ctx)
    whole = F.pad(ctx.cols(t, None, src), (0, (n * ch - h) * HEAD))
    return whole.narrow(-1, ctx.index(ctx.axes("heads")) * ch * HEAD, ch * HEAD)


def _from_heads(ctx: Ctx, t: torch.Tensor) -> torch.Tensor:
    """t's last dim from the scan's block of heads to the ``heads`` columns
    (:func:`_to_heads` undone)."""
    if not _padded(ctx):
        return t
    whole = sh.all_gather(ctx.mesh, t, ctx.axes("heads"), -1)[..., :ctx.cfg.d_model]
    return ctx.cols(whole, "heads", None)


def _state_in(ctx: Ctx, s: torch.Tensor) -> torch.Tensor:
    """A wkv state (B, H_local, M, M) as the decode state holds it (every
    head where the scan's heads are padded) -> the scan's block."""
    if not _padded(ctx):
        return s
    h, n, ch = _blocks(ctx)
    return F.pad(s, (0, 0, 0, 0, 0, n * ch - h)).narrow(1, ctx.index(ctx.axes("heads")) * ch, ch)


def _state_out(ctx: Ctx, s: torch.Tensor) -> torch.Tensor:
    """The scan's block of a wkv state -> the decode state's layout."""
    if not _padded(ctx):
        return s
    return sh.all_gather(ctx.mesh, s, ctx.axes("heads"), 1)[:, :_blocks(ctx)[0]]


def _time_mix_out(ctx: Ctx, p, o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The normed output (the scan's heads) gated and through ``w_o``: on a
    mesh this rank's ``heads`` rows, the partial sums reduced into the
    residual layout (``("batch", None)`` for one token)."""
    out = (_from_heads(ctx, o) * F.silu(g)) @ p.w_o
    return ctx.reduce(out, *(RES if out.dim() == 3 else ("batch", None)))


def _lora(ctx: Ctx, p, wx: torch.Tensor) -> torch.Tensor:
    """The decay's LoRA ``(wx @ w_lora_a) @ w_lora_b`` in float32, its
    columns laid out as ``w_lora_b``'s. On a mesh a sequence's (B, S, D)
    down-projection runs over this rank's block of the rows (every position
    of every row, padded to a multiple of the ``heads`` ranks, as GSPMD
    pads), whose results are gathered for the up-projection; one token's
    (B, D) rows run whole, where the gather would cost more than the
    product."""
    a = p.w_lora_a.float()
    axes = ctx.axes("heads")
    if wx.dim() == 2 or not axes:
        return (wx.float() @ a) @ p.w_lora_b
    rows = wx.reshape(-1, wx.shape[-1])
    n = sh.axis_size(ctx.mesh, axes)
    nb = -(-rows.shape[0] // n)
    blk = F.pad(rows, (0, 0, 0, nb * n - rows.shape[0])).narrow(0, ctx.index(axes) * nb, nb)
    down = sh.all_gather(ctx.mesh, blk.float() @ a, axes, 0)[:rows.shape[0]]
    return (down @ p.w_lora_b).reshape(*wx.shape[:-1], -1)


def _projections(ctx: Ctx, p, mix):
    """r, k, v (float32, the scan's heads), g (the ``heads`` columns) and
    the log-decay exponent (base + LoRA, float32, the scan's heads). Each
    ``mix(mu) @ w`` is projected column-parallel, the LoRA by
    :func:`_lora`. Where the scan's heads are padded, r, k, v and the decay
    reach them in one collective."""
    r, k, v, g = (mix(mu) @ w for mu, w in (
        (p.mu_r, p.w_r), (p.mu_k, p.w_k), (p.mu_v, p.w_v), (p.mu_g, p.w_g)))
    w_log = p.w_decay + _lora(ctx, p, mix(p.mu_w))
    r, k, v = r.float(), k.float(), v.float()
    if _padded(ctx):
        r, k, v, w_log = _to_heads(ctx, torch.stack([r, k, v, w_log]))
    return r, k, v, g, w_log


def _time_mix_chunked(ctx: Ctx, p: Block, x: torch.Tensor, s0: torch.Tensor,
                      tm_last: torch.Tensor | None):
    """x (B, S, D), every position -> (out (B, S, D) in the residual layout,
    the final state (B, H, M, M) of the scan's heads, x's last row). The
    sequence is zero-padded to a chunk multiple: r, k and v pads add nothing
    and log-decay pads of 0 leave the state as it is. Under grad each chunk
    is checkpointed."""
    cfg = ctx.cfg
    b, s, _ = x.shape
    c = min(cfg.ssm_chunk, s)
    xs = _shift(x, tm_last)

    def mix(mu):
        return x * mu + xs * (1 - mu)

    r, k, v, g, w_log = _projections(ctx, p, mix)
    d = r.shape[-1]  # the scan's heads' width
    h = d // HEAD
    r, k, v = (t.reshape(b, s, h, HEAD) for t in (r, k, v))
    log_w = -w_log.reshape(b, s, h, HEAD).exp()  # in (-inf, 0)
    u = _to_heads(ctx, p.u_bonus).reshape(h, HEAD)

    s_pad = -(-s // c) * c
    r, k, v, log_w = (F.pad(t, (0, 0, 0, 0, 0, s_pad - s)) for t in (r, k, v, log_w))
    strict = torch.ones((c, c), dtype=torch.bool, device=x.device).tril(-1)
    step = remat(_chunk) if torch.is_grad_enabled() else _chunk
    state, outs = s0.float(), []
    for lo in range(0, s_pad, c):
        sl = slice(lo, lo + c)
        o, state = step(state, r[:, sl], k[:, sl], v[:, sl], log_w[:, sl], u, strict)
        outs.append(o.to(x.dtype))
    o = torch.cat(outs, dim=1).float()[:, :s]
    # per-head group norm, gate, output projection
    o = rmsnorm(o, torch.ones(HEAD, dtype=torch.float32, device=x.device), cfg.norm_eps)
    o = (o.reshape(b, s, d) * _to_heads(ctx, p.ln_x.w, None)).to(x.dtype)
    return _time_mix_out(ctx, p, o, g), state, x[:, -1, :]


def _time_mix_step(ctx: Ctx, p: Block, x1: torch.Tensor, s0: torch.Tensor, tm_last: torch.Tensor):
    """The exact one-token recurrence (decode). x1 (B, D) whole; s0 the
    state of the scan's heads."""
    cfg = ctx.cfg
    b = x1.shape[0]
    xs = tm_last.to(x1.dtype)

    def mix(mu):
        return x1 * mu + xs * (1 - mu)

    r, k, v, g, w_log = _projections(ctx, p, mix)
    d = r.shape[-1]
    h = d // HEAD
    r, k, v = (t.reshape(b, h, HEAD) for t in (r, k, v))
    w = (-w_log.reshape(b, h, HEAD).exp()).exp()
    u = _to_heads(ctx, p.u_bonus).reshape(h, HEAD)
    s0 = s0.float()
    kv = k[..., :, None] * v[..., None, :]  # (B, H, M, M)
    o = torch.matmul(r[:, :, None, :], s0 + u[None, :, :, None] * kv)[:, :, 0]  # (B, H, M)
    s_new = s0 * w[..., None] + kv
    o = rmsnorm(o, torch.ones(HEAD, dtype=torch.float32, device=x1.device), cfg.norm_eps)
    o = (o.reshape(b, d) * _to_heads(ctx, p.ln_x.w, None)).to(x1.dtype)
    return _time_mix_out(ctx, p, o, g), s_new, x1


def _channel_mix(ctx: Ctx, p: Block, x: torch.Tensor, cm_last: torch.Tensor | None):
    """Channel-mix of x (B, S, D), every position, shifted after
    ``cm_last``, or of one token x (B, D) after ``cm_last`` (decode).
    Returns (out in the residual layout, x's last row). On a mesh ``cw_k``
    holds this rank's ``d_ff`` columns and ``cw_v`` its rows: the partial
    sums are reduced into the residual layout, and the gate meets them
    there."""
    xs = _shift(x, cm_last) if x.dim() == 3 else cm_last.to(x.dtype)
    xk = x * p.cmu_k + xs * (1 - p.cmu_k)
    xr = x * p.cmu_r + xs * (1 - p.cmu_r)
    k = F.relu(xk @ p.cw_k).square()
    res, cols = (RES, ("batch", None, "heads")) if x.dim() == 3 else (("batch", None), ("batch", "heads"))
    out = ctx.reduce(k @ p.cw_v, *res) * ctx.cs(torch.sigmoid(xr @ p.cw_r), *res, src=cols)
    return out, (x[:, -1, :] if x.dim() == 3 else x)


def _block(ctx: Ctx, p: Block, x: torch.Tensor, s0: torch.Tensor):
    """One layer over a whole sequence from state ``s0`` (no token carried
    in), x in the residual layout. Returns (x, (the wkv state, time-mix last
    input, channel-mix last input))."""
    eps = ctx.cfg.norm_eps
    p = _weights(ctx, p)
    h, s_new, tm_new = _time_mix_chunked(ctx, p, whole_positions(ctx, rmsnorm(x, p.ln1.w, eps)), s0, None)
    x = x + h
    h2, cm_new = _channel_mix(ctx, p, whole_positions(ctx, rmsnorm(x, p.ln2.w, eps)), None)
    return x + h2, (s_new, tm_new, cm_new)


def _block_out(ctx: Ctx, p: Block, x, s0):
    return _block(ctx, p, x, s0)[0]


def _zero_state(ctx: Ctx, b: int, device) -> torch.Tensor:
    """The zero wkv state of ``b`` rows over the scan's heads."""
    return torch.zeros((b, _blocks(ctx)[2], HEAD, HEAD), dtype=torch.float32, device=device)


def backbone(ctx: Ctx, params: RWKV6, tokens: torch.Tensor) -> torch.Tensor:
    """Embed + layers + final norm, in the residual layout; each layer
    checkpointed under grad when ``cfg.remat``."""
    x = _embed(ctx, params, tokens, None)
    s0 = _zero_state(ctx, tokens.shape[0], x.device)
    run = remat(_block_out) if ctx.cfg.remat and torch.is_grad_enabled() else _block_out
    for blk in params.blocks:
        x = run(ctx, blk, x, s0)
    return rmsnorm(x, params.final_norm.w, ctx.cfg.norm_eps)


def forward(ctx: Ctx, params: RWKV6, tokens: torch.Tensor) -> torch.Tensor:
    """Scoring forward: (B, S) tokens -> (B, S, V) logits (on a mesh the
    rank's rows and vocab block)."""
    return _unembed(ctx, params, whole_positions(ctx, backbone(ctx, params, tokens)))


def loss_fn(ctx: Ctx, params: RWKV6, batch: dict) -> torch.Tensor:
    """Next-token CE of ``batch["tokens"]`` (B, S + 1)."""
    tokens = batch["tokens"].long()
    x = whole_positions(ctx, backbone(ctx, params, tokens[:, :-1]))
    return chunked_cross_entropy(ctx, x, ctx.weight(params.lm_head, ("fsdp", "vocab")),
                                 tokens[:, 1:])


def init_state(cfg: ModelConfig, batch: int, device="cuda") -> RWKVState:
    dev = resolve_device(device)
    h = cfg.d_model // HEAD
    x_shape = (cfg.num_layers, batch, cfg.d_model)
    return RWKVState(
        s=torch.zeros((cfg.num_layers, batch, h, HEAD, HEAD), dtype=torch.float32, device=dev),
        tm_x=torch.zeros(x_shape, dtype=torch.float32, device=dev),
        cm_x=torch.zeros(x_shape, dtype=torch.float32, device=dev),
    )


@torch.inference_mode()
def prefill(ctx: Ctx, params: RWKV6, tokens: torch.Tensor, max_len: int = 0):
    """Absorb the prompt into the recurrent state (an SSM's cache; ``max_len``
    is not needed). Returns (last-token logits (B, 1, V), state)."""
    del max_len
    x = _embed(ctx, params, tokens, None)
    s0 = _zero_state(ctx, tokens.shape[0], x.device)
    states = []
    for blk in params.blocks:
        x, (s_new, tm_new, cm_new) = _block(ctx, blk, x, s0)
        states.append((_state_out(ctx, s_new), tm_new, cm_new))
    x = rmsnorm(_last_position(ctx, x), params.final_norm.w, ctx.cfg.norm_eps)
    return _unembed(ctx, params, x), RWKVState(*(torch.stack(f) for f in zip(*states)))


@torch.inference_mode()
def decode_step(ctx: Ctx, params: RWKV6, token: torch.Tensor, state: RWKVState):
    """(B, 1) token -> (B, 1, V) logits and the state advanced one token."""
    eps = ctx.cfg.norm_eps
    x = _embed(ctx, params, token, None)[:, 0]  # (B, D)
    states = []
    for i, blk in enumerate(params.blocks):
        blk = _weights(ctx, blk)
        h, s_new, tm_new = _time_mix_step(ctx, blk, rmsnorm(x, blk.ln1.w, eps),
                                          _state_in(ctx, state.s[i]), state.tm_x[i])
        x = x + h
        h2, cm_new = _channel_mix(ctx, blk, rmsnorm(x, blk.ln2.w, eps), state.cm_x[i])
        x = x + h2
        states.append((_state_out(ctx, s_new), tm_new, cm_new))
    x = rmsnorm(x, params.final_norm.w, eps)
    return _unembed(ctx, params, x)[:, None, :], RWKVState(*(torch.stack(f) for f in zip(*states)))


# -- sharding specs (the JAX package's tables) -------------------------------------


def block_param_specs() -> dict:
    """One layer's logical specs, keyed by the layer-relative names (the
    JAX package's ``blocks`` subtree without the layer dim)."""
    vec = ("heads",)  # (d,) vectors shard with the head dim
    return {
        "ln1.w": (None,), "ln2.w": (None,), **{name: vec for name in MIXES},
        "w_r": ("fsdp", "heads"), "w_k": ("fsdp", "heads"),
        "w_v": ("fsdp", "heads"), "w_g": ("fsdp", "heads"),
        "w_o": ("heads", "fsdp"),
        "w_decay": vec, "w_lora_a": ("fsdp", None), "w_lora_b": (None, "heads"),
        "u_bonus": vec, "ln_x.w": (None,),
        "cw_k": ("fsdp", "d_ff"), "cw_v": ("d_ff", "fsdp"),
        "cw_r": ("fsdp", "heads"),
    }


def param_specs(cfg: ModelConfig) -> dict:
    """Logical specs keyed by the parameter names (one tensor a layer)."""
    return sh.expand_layers(
        {"embed": ("vocab", "fsdp"), "blocks": block_param_specs(), "final_norm": {"w": (None,)},
         "lm_head": ("fsdp", "vocab")},
        {"blocks": cfg.num_layers})


def state_specs(cfg: ModelConfig) -> RWKVState:
    return RWKVState(
        s=(None, "batch", "heads4d", None, None),
        tm_x=(None, "batch", None),
        cm_x=(None, "batch", None),
    )
