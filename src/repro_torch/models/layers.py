"""Shared transformer layers: norms, RoPE and sinusoidal positions, GQA
attention (training, prefill, cache decode and cross-attention), MLP.

Plain functions do the work, over any object whose attributes hold the
parameters; the ``nn.Module`` classes here only hold them (same names and
``(in, out)`` layouts as the JAX package's parameter dicts). Activations are
``(B, S, H, Dh)`` inside the model and ``(B, H, S, D)`` at
:func:`flash_attention`.

Every function is mesh-optional. Without a mesh :class:`Ctx` holds the
config only and the model runs on one device. In a rank process of the
LM's ``(data, model)`` mesh, ``Ctx.mesh`` is the rank's
``launch.mesh.RankMesh`` and ``Ctx.rules`` the sharding rules: the model
then holds the rank's block of every tensor, and the layout changes the
rules name (``Ctx.cs``, ``Ctx.reduce``) are collectives over the axes'
process groups (``models/sharding.py``). The residual stream is
``("batch", "residual_seq", None)`` (:data:`RES`) between sublayers:
seq-sharded over ``model`` in training and prefill (Megatron-SP), whole in
decode. Attention and the MLP gather it, project column-parallel (the
``heads``/``d_ff`` columns this rank holds), and the row-parallel ``wo``
and ``w_down`` leave partial sums that :meth:`Ctx.reduce` reduce-scatters
back into the residual layout (or all-reduces when it is not seq-sharded).
"""
from __future__ import annotations

import contextvars
import dataclasses
import functools
from types import SimpleNamespace
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention.ops import flash_attention
from . import sharding as sh
from .config import ModelConfig
from .sharding import Rules

#: the residual stream's layout between sublayers
RES = ("batch", "residual_seq", None)


@dataclasses.dataclass(frozen=True)
class Ctx:
    """The config, and on a mesh the rank's mesh view and the rules."""

    cfg: ModelConfig
    mesh: Any = None
    rules: "Rules | None" = None

    def axes(self, logical: "str | None") -> tuple[str, ...]:
        """The mesh axes (of size > 1) the rules give ``logical``."""
        if self.mesh is None or self.rules is None or logical is None:
            return ()
        return sh._live(self.mesh, getattr(self.rules, logical))

    def size(self, axis: str) -> int:
        """A mesh axis's size (1 without a mesh)."""
        return 1 if self.mesh is None else self.mesh.shape.get(axis, 1)

    def index(self, axes) -> int:
        """This rank's block index over mesh ``axes`` (0 without a mesh)."""
        return 0 if self.mesh is None else sh.axis_index(self.mesh, axes)

    def cs(self, x: torch.Tensor, *axes, src: tuple = ()) -> torch.Tensor:
        """``x`` from the layout ``src`` (logical axes a dim; missing dims
        whole) to ``axes``: the JAX package's sharding constraint, made with
        collectives. Nothing without a mesh."""
        if self.mesh is None or self.rules is None:
            return x
        return sh.relayout(self.mesh, x, self.rules.spec(*src), self.rules.spec(*axes))

    def cols(self, x: torch.Tensor, dst: "str | None", src: "str | None") -> torch.Tensor:
        """``x``'s last dim from the logical layout ``src`` to ``dst``, the
        other dims as they are: a gather, a block kept, or nothing."""
        lead = (None,) * (x.dim() - 1)
        return self.cs(x, *lead, dst, src=(*lead, src))

    def reduce(self, x: torch.Tensor, *axes, over: str = "model") -> torch.Tensor:
        """``x`` holds partial sums over the mesh axis ``over`` and is laid
        out as ``axes`` elsewhere: the sum, laid out as ``axes``
        (reduce-scatter into the dim that ``axes`` shards over ``over``,
        else all-reduce)."""
        if self.mesh is None or self.size(over) == 1:
            return x
        for d, entry in enumerate(self.rules.spec(*axes)):
            if over in sh.axes_of(entry):
                return sh.reduce_scatter(self.mesh, x, (over,), d)
        return sh.psum(self.mesh, x, (over,))

    def psum(self, x: torch.Tensor, logical: str) -> torch.Tensor:
        """The sum over the mesh axes of ``logical`` (e.g. the batch axes)."""
        if self.mesh is None:
            return x
        return sh.psum(self.mesh, x, self.axes(logical))

    def weight(self, t: torch.Tensor, logical: tuple) -> torch.Tensor:
        """A weight stored as ``logical`` in its layout at use: the FSDP
        dims gathered (their gradient reduce-scattered back)."""
        if self.mesh is None:
            return t
        return self.cs(t, *sh.compute_spec(logical), src=logical)

    def gathered(self, module, specs: dict, keep=()) -> Any:
        """A view of ``module``'s parameters (nested attributes, as the
        module's) with each weight in its layout at use, by its logical
        spec in ``specs`` (keyed by the module-relative name); the
        submodules named in ``keep`` pass as they are stored. ``module``
        itself without a mesh."""
        if self.mesh is None:
            return module
        root = SimpleNamespace()
        for name, t in module.named_parameters():
            parts = name.split(".")
            node = root
            for key in parts[:-1]:
                node = node.__dict__.setdefault(key, SimpleNamespace())
            stored = parts[0] in keep
            setattr(node, parts[-1], t if stored else self.weight(t, specs[name]))
        return root


def whole_positions(ctx: Ctx, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) from the residual layout to every position (the rank's
    batch rows): a gather over the sequence axes, or nothing."""
    return ctx.cs(x, "batch", None, None, src=RES)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def generator(device: torch.device, seed: int) -> torch.Generator:
    """The weights' random stream on ``device``, seeded. On the meta device
    (shapes and dtypes only, as :func:`repro_torch.convert` builds a model
    to read its parameters' dtypes) a CPU generator stands in: nothing is
    drawn there."""
    return torch.Generator(device="cpu" if device.type == "meta" else device).manual_seed(seed)


#: called with each parameter :func:`_normal` draws, in draw order; returns
#: the parameter to keep (a rank keeps its block, ``launch/steps.py``)
DRAW_HOOK: "contextvars.ContextVar[Any]" = contextvars.ContextVar("draw_hook", default=None)


def _normal(shape, cfg: ModelConfig, gen: torch.Generator, device, dtype=None) -> nn.Parameter:
    """N(0, 0.02) in the config's type (or ``dtype``), as the JAX package's
    initializers, drawn in place: no float32 copy of a bf16 tensor is made."""
    t = torch.empty(shape, dtype=dtype or dtype_of(cfg), device=device)
    with torch.no_grad():
        t.normal_(0.0, 0.02, generator=gen)
    p = nn.Parameter(t)
    hook = DRAW_HOOK.get()
    return p if hook is None else hook(p)


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
    # the budget holds per shard: on a mesh q is already the rank's block
    # (its batch rows; its heads when they shard, padded heads included),
    # the JAX package's global score bytes over its batch x head shards
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


def _split_heads(ctx: Ctx, t: torch.Tensor, n: int, rule: str) -> torch.Tensor:
    """(B, S, cols) -> (B, S, heads, Dh). On a mesh ``t`` holds this rank's
    ``heads`` columns: whole heads when ``rule`` (``heads4d`` or
    ``kv_heads4d``) shards over ``model``, else the columns are gathered
    first and every head is kept."""
    b, s, _ = t.shape
    m = ctx.size("model")
    if m > 1 and ctx.axes(rule):
        return t.reshape(b, s, n // m, -1)
    t = ctx.cs(t, None, None, None, src=(None, None, "heads"))
    return t.reshape(b, s, n, -1)


def _kv_for_local_heads(ctx: Ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, hq: int,
                        hkv: int):
    """The k and v heads this rank's q heads read (q head h reads kv head
    h // group). They are k, v as given unless q's heads shard over
    ``model`` and k's do not; then the kv heads of the local q heads, in
    the group map's order (one kv head a q head when the local q heads do
    not split into whole groups)."""
    hq_l = q.shape[2]
    if hq_l == hq or k.shape[2] != hkv:
        return k, v
    group = hq // hkv
    lo = ctx.index("model") * hq_l
    if hq_l % group == 0:
        sl = slice(lo // group, (lo + hq_l) // group)
        return k[:, :, sl], v[:, :, sl]
    if group % hq_l == 0:
        sl = slice(lo // group, lo // group + 1)
        return k[:, :, sl], v[:, :, sl]
    idx = torch.arange(lo, lo + hq_l, device=k.device) // group
    return k.index_select(2, idx), v.index_select(2, idx)


def _wo_columns(ctx: Ctx, o: torch.Tensor, hq: int) -> torch.Tensor:
    """The attention output (B, S, heads, Dh) as the rows of ``wo`` this
    rank holds: its heads' columns as they are, or, where every head is
    here (attention replicated over ``model``), this rank's ``heads``
    block of the columns."""
    b, s, h, dh = o.shape
    o = o.reshape(b, s, h * dh)
    if h == hq:
        o = ctx.cs(o, None, None, "heads", src=(None, None, None))
    return o


def _write_seq(cache: torch.Tensor, new: torch.Tensor, start: int, lo: int) -> None:
    """Write ``new`` (B, s, ...) at global positions ``start`` .. into the
    cache block that holds global positions ``lo`` .. ``lo + len``."""
    n, s = cache.shape[1], new.shape[1]
    a, b = max(start, lo), min(start + s, lo + n)
    if a < b:
        cache[:, a - lo:b - lo] = new[:, a - start:b - start].to(cache.dtype)


def _attend_kv_sharded(ctx: Ctx, q, ck, cv, *, causal, window, kv_valid_len: int, axes):
    """Decode attention over a KV sequence sharded over ``axes``: each rank
    scores its block of positions, then the softmax's max, its sum and the
    weighted values are reduced over ``axes`` (float32 throughout)."""
    b, sq, hq, dh = q.shape
    n, hkv = ck.shape[1], ck.shape[2]
    group = hq // hkv
    lo = sh.axis_index(ctx.mesh, axes) * n
    qg = q.float().reshape(b, sq, hkv, group, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.float()) * dh ** -0.5
    q_pos = kv_valid_len - sq + torch.arange(sq, device=q.device)[:, None]
    k_pos = lo + torch.arange(n, device=q.device)[None, :]
    mask = k_pos < kv_valid_len
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    s = s.masked_fill(~mask, float("-inf"))
    m_loc = s.amax(dim=-1, keepdim=True)
    m = sh.pmax(ctx.mesh, m_loc, axes)
    p = torch.exp(s - m).nan_to_num(0.0)
    den = sh.psum(ctx.mesh, p.sum(dim=-1, keepdim=True), axes)
    num = sh.psum(ctx.mesh, torch.einsum("bhgqk,bkhd->bhgqd", p, cv.float()), axes)
    o = torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh).to(q.dtype)


def attn_sublayer(
    ctx: Ctx,
    p,
    x: torch.Tensor,  # (B, S, D), the residual layout
    *,
    pos_offset: int = 0,
    cache: tuple[torch.Tensor, torch.Tensor] | None = None,  # (B, Smax, Hkv, Dh) x2
    cache_len: int | None = None,  # valid entries in cache before this call
    xkv: torch.Tensor | None = None,  # cross-attention source (B, Skv, D)
    causal: bool = True,
    use_rope: bool = True,
    kv_len: int | None = None,  # the keys' source's valid positions (prefill, training)
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Attention sublayer. Returns (out, the updated cache or the fresh
    (k, v)).

    - prefill: ``cache=None``, returns the (k, v) it computed;
    - decode: ``cache`` and ``cache_len`` given, x is the new token(s);
    - cross-attention: ``xkv`` given (the encoder's states, in the residual
      layout as x is), keys and values from it, no rope, no causal mask and
      no window;
    - ``kv_len``: keys and values from the first ``kv_len`` positions of
      their source only (x, or ``xkv``), whole positions: the encoder's
      frames padded to divide the sequence axes keep their padding out of
      every softmax.

    On a mesh (module docstring) q, k and v are this rank's heads when the
    rules shard them (``heads4d``, ``kv_heads4d``), else every head, and
    attention over every head is replicated over ``model``; with
    ``cfg.tp_pad_heads`` and heads that do not divide ``model``, KV is
    repeated to one head a q head and the heads zero-padded to a multiple of
    ``model``, each rank attending over its block of them (exact: padded
    heads attend over zero K/V and are dropped before ``wo``). A cache
    sharded over ``kv_seq`` is read by :func:`_attend_kv_sharded`. The
    (k, v) returned are laid out ``("batch", None, "kv_heads4d", None)``.
    """
    cfg = ctx.cfg
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    x = whole_positions(ctx, x)
    b, s, _ = x.shape
    src = x if xkv is None else whole_positions(ctx, xkv)
    if kv_len is not None:
        src = src[:, :kv_len]
    q, k, v = x @ p.wq, src @ p.wk, src @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = _split_heads(ctx, q, hq, "heads4d")
    k = _split_heads(ctx, k, hkv, "kv_heads4d")
    v = _split_heads(ctx, v, hkv, "kv_heads4d")
    if use_rope and cfg.pos_emb == "rope" and xkv is None:
        # k takes the query positions too: at decode, the new tokens' own
        qpos = torch.arange(s, device=x.device) + pos_offset
        q = rope(q, qpos, cfg.rope_theta, cfg.rope_fraction)
        k = rope(k, qpos, cfg.rope_theta, cfg.rope_fraction)
    m = ctx.size("model")
    if cache is not None:
        ck, cv = cache
        seq_axes = ctx.axes("kv_seq")
        if seq_axes:
            lo = sh.axis_index(ctx.mesh, seq_axes) * ck.shape[1]
            _write_seq(ck, k, cache_len, lo)
            _write_seq(cv, v, cache_len, lo)
            if q.shape[2] * hkv != hq * ck.shape[2]:  # q's heads shard, the cache's do not
                q = ctx.cs(q, None, None, None, None, src=(None, None, "heads4d", None))
            o = _attend_kv_sharded(ctx, q, ck, cv, causal=causal, window=cfg.sliding_window,
                                   kv_valid_len=cache_len + s, axes=seq_axes)
        else:
            # written in place, where the JAX package's dynamic_update_slice
            # makes a new array: the caller's cache holds the new entries after
            ck[:, cache_len:cache_len + s] = k.to(ck.dtype)
            cv[:, cache_len:cache_len + s] = v.to(cv.dtype)
            kl, vl = _kv_for_local_heads(ctx, q, ck, cv, hq, hkv)
            o = _attend(ctx, q, kl, vl, causal=causal, window=cfg.sliding_window,
                        kv_valid_len=cache_len + s)
        new_cache = (ck, cv)
    else:
        self_attn = xkv is None
        mask = dict(causal=causal and self_attn, window=cfg.sliding_window if self_attn else None)
        if cfg.tp_pad_heads and m > 1 and hq % m != 0 and not ctx.axes("heads4d"):
            hq_pad = -(-hq // m) * m
            pad = (0, 0, 0, hq_pad - hq)
            qp, kp, vp = (F.pad(t, pad) for t in (
                q, k.repeat_interleave(hq // hkv, dim=2), v.repeat_interleave(hq // hkv, dim=2)))
            full = ("batch", None, None, None)
            padded = ("batch", None, "heads_pad", None)
            qp, kp, vp = (ctx.cs(t, *padded, src=full) for t in (qp, kp, vp))
            o = ctx.cs(_attend(ctx, qp, kp, vp, **mask), *full, src=padded)[:, :, :hq]
        else:
            kl, vl = _kv_for_local_heads(ctx, q, k, v, hq, hkv)
            o = _attend(ctx, q, kl, vl, **mask)
        new_cache = (k, v)
    out = _wo_columns(ctx, o, hq) @ p.wo
    return ctx.reduce(out, *RES), new_cache


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
    """x in the residual layout; on a mesh ``d_ff`` is this rank's block
    (column-parallel ``w_gate``/``w_up``, row-parallel ``w_down``)."""
    x = whole_positions(ctx, x)
    if ctx.cfg.act == "swiglu":
        h = F.silu(x @ p.w_gate) * (x @ p.w_up)
    else:
        h = F.gelu(x @ p.w_up, approximate="tanh")  # jax.nn.gelu's default
    return ctx.reduce(h @ p.w_down, *RES)
