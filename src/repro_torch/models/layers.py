"""Shared transformer layers: norms, RoPE and sinusoidal positions, GQA
attention (training, prefill, cache decode and cross-attention), MLP.

Plain functions do the work, over any object whose attributes hold the
parameters; the ``nn.Module`` classes here only hold them (same names and
``(in, out)`` layouts as the JAX package's parameter dicts). One device and
no mesh: :class:`Ctx` holds the config only. Activations are
``(B, S, H, Dh)`` inside the model and ``(B, H, S, D)`` at
:func:`flash_attention`.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention.ops import flash_attention
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Ctx:
    cfg: ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def generator(device: torch.device, seed: int) -> torch.Generator:
    """The weights' random stream on ``device``, seeded. On the meta device
    (shapes and dtypes only, as :func:`repro_torch.convert` builds a model
    to read its parameters' dtypes) a CPU generator stands in: nothing is
    drawn there."""
    return torch.Generator(device="cpu" if device.type == "meta" else device).manual_seed(seed)


def _normal(shape, cfg: ModelConfig, gen: torch.Generator, device, dtype=None) -> nn.Parameter:
    """N(0, 0.02) in the config's type (or ``dtype``), as the JAX package's
    initializers, drawn in place: no float32 copy of a bf16 tensor is made."""
    t = torch.empty(shape, dtype=dtype or dtype_of(cfg), device=device)
    with torch.no_grad():
        t.normal_(0.0, 0.02, generator=gen)
    return nn.Parameter(t)


def remat(fn):
    """``fn`` under a non-reentrant activation checkpoint: its activations
    are recomputed in the backward pass instead of kept (the JAX package's
    ``jax.checkpoint`` with ``nothing_saveable``). Nothing in the model draws
    random numbers, so no RNG state is kept."""
    return functools.partial(checkpoint, fn, use_reentrant=False, preserve_rng_state=False)


# -- norms ---------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * r).to(x.dtype) * w  # rounds to x's type before the weight


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def norm(ctx: Ctx, p, x: torch.Tensor) -> torch.Tensor:
    if ctx.cfg.norm == "layernorm":
        return layernorm(x, p.w, p.b, ctx.cfg.norm_eps)
    return rmsnorm(x, p.w, ctx.cfg.norm_eps)


class RMSNorm(nn.Module):
    """Norm weights ``w`` (ones), and ``b`` (zeros) when ``cfg.norm`` is
    ``"layernorm"``; :func:`norm` applies the norm the config names."""

    def __init__(self, cfg: ModelConfig, d: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.ones(d, dtype=dtype_of(cfg), device=device))
        if cfg.norm == "layernorm":
            self.b = nn.Parameter(torch.zeros(d, dtype=dtype_of(cfg), device=device))


# -- positions -----------------------------------------------------------------


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float, fraction: float) -> torch.Tensor:
    """x: (B, S, H, Dh); pos: (S,) or (B, S) absolute positions. Rotates the
    first ``rot`` dims only (partial rotary), rotate-half style."""
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    half = rot // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[..., None] * freqs  # (S, half) or (B, S, half)
    if pos.dim() == 1:
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2, rest = x[..., :half], x[..., half:rot], x[..., rot:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos, rest], dim=-1)


def sinusoidal(seq: int, d: int, dtype: torch.dtype, device=None, start: int = 0) -> torch.Tensor:
    """(seq, d) sine/cosine positions of ``start`` .. ``start + seq - 1``
    (sines in the even columns, cosines in the odd), computed in float32
    and cast last."""
    pos = torch.arange(start, start + seq, dtype=torch.float32, device=device)[:, None]
    step = -torch.log(torch.tensor(10000.0, device=device)) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device) * step)
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[: d // 2])
    return pe.to(dtype)


# -- attention -----------------------------------------------------------------


_SCORE_BYTE_BUDGET = 1 << 28  # cap on the materialized float32 score tile


def _attend_dense(q, k, v, *, causal, window, scale, q_offset, sq_total, kv_valid_len):
    """One (B, cq, Hq, Dh) x (B, Skv, Hkv, Dh) attention tile in float32."""
    b, cq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    # q head h reads kv head h // group, as the JAX package's repeat does
    qg = q.float().reshape(b, cq, hkv, group, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    kv_len = kv_valid_len if kv_valid_len is not None else skv
    q_pos = q_offset + torch.arange(cq, device=q.device)[:, None] + (kv_len - sq_total)
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((cq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, cq, hq, dh).to(q.dtype)


def _attend(
    ctx: Ctx,
    q: torch.Tensor,  # (B, Sq, Hq, Dh)
    k: torch.Tensor,  # (B, Skv, Hkv, Dh)
    v: torch.Tensor,
    *,
    causal: bool,
    window: int | None,
    kv_valid_len: int | None = None,  # valid cache entries (decode)
) -> torch.Tensor:
    """Attention dispatch: the flash kernel (prefill: static masks), dense,
    or q-chunked dense (a loop over query blocks whose score tiles each fit
    ``_SCORE_BYTE_BUDGET``; under grad each tile is checkpointed, so the
    backward recomputes its scores instead of keeping every tile's softmax).

    The flash kernel has no backward (neither has the JAX package's), and
    its output carries no ``grad_fn``: with grad enabled and inputs that
    require grad it raises rather than drop the gradients to q, k and v.
    Training takes the reference branch."""
    b, sq, hq, dh = q.shape
    skv = k.shape[1]
    if ctx.cfg.attn_impl == "flash" and kv_valid_len is None:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            raise RuntimeError(
                "attn_impl='flash' under grad: the flash attention kernel has no backward, so "
                "the gradients to q, k and v would be lost; train with attn_impl='reference'"
            )
        o = flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=causal, window=window,
        )
        return o.transpose(1, 2)
    scale = dh ** -0.5
    dense = dict(causal=causal, window=window, scale=scale, sq_total=sq)
    if kv_valid_len is not None or b * hq * sq * skv * 4 <= _SCORE_BYTE_BUDGET or sq <= 128:
        return _attend_dense(q, k, v, q_offset=0, kv_valid_len=kv_valid_len, **dense)
    cq = sq
    while cq > 128 and b * hq * cq * skv * 4 > _SCORE_BYTE_BUDGET:
        cq //= 2
    while sq % cq:
        cq //= 2

    def tile(qi, k, v, off):
        return _attend_dense(qi, k, v, q_offset=off, kv_valid_len=None, **dense)

    run = remat(tile) if torch.is_grad_enabled() else tile
    return torch.cat([run(q[:, off:off + cq], k, v, off) for off in range(0, sq, cq)], dim=1)


class Attention(nn.Module):
    """``wq`` (D, Hq*Dh), ``wk``/``wv`` (D, Hkv*Dh), ``wo`` (Hq*Dh, D), and
    the zero biases ``bq``/``bk``/``bv`` when ``cfg.qkv_bias``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        d, hd, hq, hkv = cfg.d_model, cfg.hd, cfg.num_heads, cfg.num_kv_heads
        self.wq = _normal((d, hq * hd), cfg, gen, device)
        self.wk = _normal((d, hkv * hd), cfg, gen, device)
        self.wv = _normal((d, hkv * hd), cfg, gen, device)
        self.wo = _normal((hq * hd, d), cfg, gen, device)
        if cfg.qkv_bias:
            for name, n in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
                setattr(self, name, nn.Parameter(torch.zeros(n, dtype=dtype_of(cfg), device=device)))


def attn_sublayer(
    ctx: Ctx,
    p,
    x: torch.Tensor,  # (B, S, D)
    *,
    pos_offset: int = 0,
    cache: tuple[torch.Tensor, torch.Tensor] | None = None,  # (B, Smax, Hkv, Dh) x2
    cache_len: int | None = None,  # valid entries in cache before this call
    xkv: torch.Tensor | None = None,  # cross-attention source (B, Skv, D)
    causal: bool = True,
    use_rope: bool = True,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Attention sublayer. Returns (out, the updated cache or the fresh
    (k, v)).

    - prefill: ``cache=None``, returns the (k, v) it computed;
    - decode: ``cache`` and ``cache_len`` given, x is the new token(s);
    - cross-attention: ``xkv`` given, keys and values from it, no rope, no
      causal mask and no window.
    """
    cfg = ctx.cfg
    b, s, _ = x.shape
    hd, hq, hkv = cfg.hd, cfg.num_heads, cfg.num_kv_heads
    src = x if xkv is None else xkv
    q, k, v = x @ p.wq, src @ p.wk, src @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, src.shape[1], hkv, hd)
    v = v.reshape(b, src.shape[1], hkv, hd)
    if use_rope and cfg.pos_emb == "rope" and xkv is None:
        # k takes the query positions too: at decode, the new tokens' own
        qpos = torch.arange(s, device=x.device) + pos_offset
        q = rope(q, qpos, cfg.rope_theta, cfg.rope_fraction)
        k = rope(k, qpos, cfg.rope_theta, cfg.rope_fraction)
    if cache is not None:
        ck, cv = cache
        # written in place, where the JAX package's dynamic_update_slice
        # makes a new array: the caller's cache holds the new entries after
        ck[:, cache_len:cache_len + s] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + s] = v.to(cv.dtype)
        o = _attend(ctx, q, ck, cv, causal=causal, window=cfg.sliding_window,
                    kv_valid_len=cache_len + s)
        new_cache = (ck, cv)
    else:
        self_attn = xkv is None
        o = _attend(ctx, q, k, v, causal=causal and self_attn,
                    window=cfg.sliding_window if self_attn else None)
        new_cache = (k, v)
    return o.reshape(b, s, hq * hd) @ p.wo, new_cache


# -- MLP -----------------------------------------------------------------------


class MLP(nn.Module):
    """SwiGLU ``w_gate``/``w_up`` (D, F) and ``w_down`` (F, D); GELU has no
    gate."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        if cfg.act == "swiglu":
            self.w_gate = _normal((d, f), cfg, gen, device)
        self.w_up = _normal((d, f), cfg, gen, device)
        self.w_down = _normal((f, d), cfg, gen, device)


def mlp_sublayer(ctx: Ctx, p, x: torch.Tensor) -> torch.Tensor:
    if ctx.cfg.act == "swiglu":
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    else:
        h = F.gelu(x @ p.w_up, approximate="tanh")  # jax.nn.gelu's default
    return h @ p.w_down
