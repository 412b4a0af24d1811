"""Mamba-2 (SSD) block: chunked selective-state-space scan.

A scalar decay per head, a_t = exp(-softplus(dt_t) * exp(A_log)), over a
(N x P) state per head: h_t = a_t h_{t-1} + dt_t * B_t x_t^T,
y_t = C_t^T h_t + D x_t; behind a depthwise causal conv and SiLU gating.
Prefill and training run the scan in chunks of ``cfg.ssm_chunk`` tokens
(the sequence zero-padded to a chunk multiple); decode runs one token as
one chunk from the carried state and conv tail.

The contractions are batched matmuls over (B, H): the reference's
``"bti,btih,bihp->bthp"`` would form a (B, c, c, H, P) tensor (5.4 GB a
chunk at zamba2-2.7b's widths and B = 4).

On the ``(data, model)`` mesh (``models/layers.py``) ``in_proj`` holds this
rank's block of the concatenated ``[z | xBC | dt]`` columns, a block that
straddles their boundaries, so the projection is gathered whole before the
split. The depthwise conv runs over this rank's block of the xBC channels,
as ``conv_w``, ``conv_b`` and the conv tail hold them, and the conv's output
is gathered whole (B and C are shared by every head). The scan, the D skip,
the gate and the output norm run over this rank's heads (every head when the
rules do not shard 4-D heads, :func:`_heads_layout`); the norm's mean
square is summed over ``model``, and ``out_proj``'s partial sums are
reduced into the residual layout.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import RES, Ctx, _normal, dtype_of, remat, rmsnorm, whole_positions

P_HEAD = 64  # head dim (P) of the inner stream
CONV_W = 4


class MambaLayerState(NamedTuple):
    h: torch.Tensor  # (B, H, N, P) ssm state, float32
    conv: torch.Tensor  # (B, CONV_W - 1, D_conv) conv tail


def dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(inner dim, state size N, heads H, conv channels) of the config."""
    di = 2 * cfg.d_model
    return di, cfg.ssm_state, di // P_HEAD, di + 2 * cfg.ssm_state


class Mamba(nn.Module):
    """``in_proj`` (D, Di + Dconv + H: z, xBC, dt), ``conv_w`` (CONV_W,
    Dconv), ``conv_b``, ``out_norm`` (Di), ``out_proj`` (Di, D) in the
    config's type; ``a_log`` (zeros), ``d_skip`` (ones) and ``dt_bias``
    (zeros), one a head, in float32 whatever the config's type."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        d = cfg.d_model
        di, _, h, dconv = dims(cfg)
        dt = dtype_of(cfg)
        self.in_proj = _normal((d, di + dconv + h), cfg, gen, device)
        self.conv_w = _normal((CONV_W, dconv), cfg, gen, device)
        self.conv_b = nn.Parameter(torch.zeros(dconv, dtype=dt, device=device))
        self.a_log = nn.Parameter(torch.zeros(h, dtype=torch.float32, device=device))
        self.d_skip = nn.Parameter(torch.ones(h, dtype=torch.float32, device=device))
        self.dt_bias = nn.Parameter(torch.zeros(h, dtype=torch.float32, device=device))
        self.out_norm = nn.Parameter(torch.ones(di, dtype=dt, device=device))
        self.out_proj = _normal((di, d), cfg, gen, device)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tail: torch.Tensor | None):
    """Depthwise causal conv of width CONV_W over x (B, S, C), after the
    previous call's last CONV_W - 1 inputs (zeros at the start). Returns
    (silu(y), the new tail)."""
    bsz, s, c = x.shape
    if tail is None:
        head = torch.zeros((bsz, CONV_W - 1, c), dtype=x.dtype, device=x.device)
    else:
        head = tail.to(x.dtype)
    xp = torch.cat([head, x], dim=1)  # (B, S + W - 1, C)
    y = sum(xp[:, i:i + s] * w[i] for i in range(CONV_W)) + b
    return F.silu(y), xp[:, -(CONV_W - 1):]


def _chunk(hstate, xx, bb, cc, ll, causal_incl):
    """One chunk of the scan. hstate (B, H, N, P); xx (B, c, H, P) the
    dt-scaled input; bb, cc (B, c, N); ll (B, c, H) log decays. Returns
    (y (B, c, H, P), the state after the chunk), both float32."""
    L = torch.cumsum(ll, dim=1)  # (B, c, H), inclusive
    # intra: y_t = sum_{i<=t} exp(L_t - L_i) (C_t . B_i) x_i. Above the
    # diagonal L_t - L_i > 0 and its exp may overflow, so those entries go
    # to exp(-inf) = 0 before the exp, not after: no inf meets a 0 in the
    # backward
    ratio = L[:, :, None, :] - L[:, None, :, :]  # (B, t, i, H)
    decay = ratio.masked_fill(~causal_incl[None, :, :, None], float("-inf")).exp()
    cb = torch.matmul(cc, bb.transpose(1, 2))  # (B, t, i)
    w = (cb[..., None] * decay).permute(0, 3, 1, 2)  # (B, H, t, i)
    xh = xx.permute(0, 2, 1, 3)  # (B, H, c, P)
    y = torch.matmul(w, xh)  # (B, H, t, P)
    # inter: y_t += exp(L_t) C_t . h_0
    y = y + torch.matmul(cc[:, None], hstate) * L.exp().permute(0, 2, 1)[..., None]
    # state: h = exp(L_last) h_0 + sum_i exp(L_last - L_i) B_i x_i^T
    last = L[:, -1]  # (B, H)
    w_tail = (last[:, None] - L).exp()  # (B, c, H)
    xw = xh * w_tail.permute(0, 2, 1)[..., None]  # (B, H, c, P)
    h_new = hstate * last.exp()[:, :, None, None] + torch.matmul(bb.transpose(1, 2)[:, None], xw)
    return y.permute(0, 2, 1, 3), h_new


def _heads_layout(ctx: Ctx) -> "str | None":
    """The inner stream's head layout: ``"heads"`` (this rank's whole heads)
    when the rules shard 4-D heads, else None (every head, the work
    replicated over ``model``)."""
    return "heads" if ctx.axes("heads4d") else None


def _out_norm(ctx: Ctx, y: torch.Tensor, w: torch.Tensor, hs: "str | None") -> torch.Tensor:
    """rmsnorm over the whole inner dim of y, which holds the columns of the
    layout ``hs``: with this rank's heads the mean square is summed over
    ``model``."""
    if hs is None or ctx.mesh is None:
        return rmsnorm(y, w, ctx.cfg.norm_eps)
    y32 = y.float()
    ms = ctx.psum((y32 * y32).sum(dim=-1, keepdim=True), hs) / dims(ctx.cfg)[0]
    return (y32 * torch.rsqrt(ms + ctx.cfg.norm_eps)).to(y.dtype) * w


def mamba_sublayer(ctx: Ctx, p: Mamba, x: torch.Tensor, state: MambaLayerState | None = None):
    """x (B, S, D) in the residual layout -> (out (B, S, D) in the residual
    layout, the state after x). The scan runs in chunks of
    ``min(cfg.ssm_chunk, S)``; under grad each chunk is checkpointed (its
    (c x c) decays recomputed in the backward). On a mesh (module
    docstring) the state holds this rank's heads and conv channels."""
    cfg = ctx.cfg
    hs = _heads_layout(ctx)
    x = whole_positions(ctx, x)
    bsz, s, _ = x.shape
    di, n, h, dconv = dims(cfg)
    z, xbc, dt_raw = ctx.cols(x @ p.in_proj, None, "heads").split([di, dconv, h], dim=-1)
    xbc = ctx.cols(xbc, "heads", None)  # the conv's channels, as conv_w holds them
    xbc, conv_tail = _causal_conv(xbc, p.conv_w, p.conv_b, None if state is None else state.conv)
    xi, b_in, c_in = ctx.cols(xbc, None, "heads").split([di, n, n], dim=-1)
    xi, z, dt_raw = (ctx.cols(t, hs, None) for t in (xi, z, dt_raw))
    dt_bias, a_log, d_skip, out_norm = (ctx.cols(t, hs, "heads") for t in (
        p.dt_bias, p.a_log, p.d_skip, p.out_norm))
    h = dt_raw.shape[-1]  # this rank's heads
    dt = F.softplus(dt_raw.float() + dt_bias)  # (B, S, H)
    log_a = -dt * a_log.exp()  # (B, S, H) scalar decay a head

    xh_raw = xi.reshape(bsz, s, h, P_HEAD).float()
    xh = xh_raw * dt[..., None]  # dt folded into the input
    bmat, cmat = b_in.float(), c_in.float()  # (B, S, N), shared by the heads

    c = min(cfg.ssm_chunk, s)
    s_pad = -(-s // c) * c
    if s_pad != s:
        xh = F.pad(xh, (0, 0, 0, 0, 0, s_pad - s))
        bmat, cmat, log_a = (F.pad(t, (0, 0, 0, s_pad - s)) for t in (bmat, cmat, log_a))
    causal_incl = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()  # i <= t
    if state is None:
        hstate = torch.zeros((bsz, h, n, P_HEAD), dtype=torch.float32, device=x.device)
    else:
        hstate = state.h.float()
    step = remat(_chunk) if torch.is_grad_enabled() else _chunk
    ys = []
    for lo in range(0, s_pad, c):
        sl = slice(lo, lo + c)
        y, hstate = step(hstate, xh[:, sl], bmat[:, sl], cmat[:, sl], log_a[:, sl], causal_incl)
        ys.append(y.to(x.dtype))
    y = torch.cat(ys, dim=1).float()[:, :s]
    y = y + xh_raw * d_skip[None, None, :, None]  # D skip connection
    y = _out_norm(ctx, y.reshape(bsz, s, h * P_HEAD).to(x.dtype), out_norm, hs)
    y = ctx.cols(y * F.silu(z), "heads", hs)
    return ctx.reduce(y @ p.out_proj, *RES), MambaLayerState(h=hstate, conv=conv_tail)


def mamba_param_specs() -> dict:
    """One Mamba-2 layer's logical specs (the JAX package's table, no layer
    dim), keyed by the layer-relative names."""
    return {
        "in_proj": ("fsdp", "heads"),
        "conv_w": (None, "heads"),
        "conv_b": ("heads",),
        "a_log": ("heads",),
        "d_skip": ("heads",),
        "dt_bias": ("heads",),
        "out_norm": ("heads",),
        "out_proj": ("heads", "fsdp"),
    }
