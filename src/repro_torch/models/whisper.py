"""Whisper-small backbone: encoder-decoder transformer.

The conv/mel frontend is a stub: the encoder takes precomputed frame
embeddings (B, frames, D) and runs bidirectional self-attention over them;
the decoder runs causal self-attention and cross-attention to the encoder's
states. LayerNorm with bias, tanh-GELU MLPs, sinusoidal positions (no
rope).

Serving: ``prefill`` encodes the frames, runs the prompt and caches every
decoder layer's cross K/V once; ``decode_step`` reads them through
:func:`_cross_from_cache`, which calls ``_attend`` without a valid length,
so under ``attn_impl="flash"`` every decode step launches the flash kernel
once a layer (q of one row over all the frames), as the reference does.

On the ``(data, model)`` mesh (``models/layers.py``) the encoder's and the
decoder's streams are both in the residual layout, each layer's weights are
gathered to their layout at use, and attention runs over this rank's heads
(the encoder's non-causal). The cross-attention gathers the encoder's
states' positions before its keys and values. Where the sequence axes do
not divide the frames (1500 over 16), the encoder pads them to a multiple
(as GSPMD pads an uneven dim) and every attention over the encoder's states
reads the first ``frames`` keys only, so the padded positions change
nothing. The vocab (51,865) does not
divide ``model``, so the rules replicate the embedding, ``lm_head`` and the
loss over it. The cross caches hold this rank's rows and kv heads over
every frame.
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
    MLP, RES, Attention, Ctx, RMSNorm, _attend, _kv_for_local_heads, _normal, _split_heads,
    _wo_columns, _write_seq, attn_sublayer, dtype_of, generator, mlp_sublayer, norm, remat,
    sinusoidal, whole_positions,
)
from .losses import chunked_cross_entropy
from .transformer import _cache_block, _embed, _last_position, _local_kv_heads, _unembed


class WhisperCaches(NamedTuple):
    self_k: torch.Tensor  # (L, B, Smax, Hkv, Dh)
    self_v: torch.Tensor
    cross_k: torch.Tensor  # (L, B, F, Hkv, Dh), written at prefill
    cross_v: torch.Tensor
    length: int  # valid prefix of the self-attention caches


class EncBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg, cfg.d_model, device)
        self.ln2 = RMSNorm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, gen, device)
        self.mlp = MLP(cfg, gen, device)


class DecBlock(EncBlock):
    """An encoder block's weights and the cross-attention's: ``ln_x``,
    ``xattn``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__(cfg, gen, device)
        self.ln_x = RMSNorm(cfg, cfg.d_model, device)
        self.xattn = Attention(cfg, gen, device)


class Whisper(nn.Module):
    """The weights: ``embed`` (V, D), ``enc_blocks.<i>`` (``encoder_layers``
    of them), ``enc_norm``, ``dec_blocks.<i>`` (``num_layers``),
    ``final_norm``, ``lm_head`` (D, V); matrices from N(0, 0.02) by a
    generator seeded with ``seed`` on ``device``."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = generator(dev, seed)
        self.cfg = cfg
        self.embed = _normal((cfg.vocab_size, cfg.d_model), cfg, gen, dev)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, gen, dev) for _ in range(cfg.encoder_layers))
        self.enc_norm = RMSNorm(cfg, cfg.d_model, dev)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, gen, dev) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg, cfg.d_model, dev)
        self.lm_head = _normal((cfg.d_model, cfg.vocab_size), cfg, gen, dev)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Whisper:
    return Whisper(cfg, seed=seed, device=device)


def _enc_block(ctx: Ctx, p: EncBlock, x, frames: int):
    p = ctx.gathered(p, enc_block_specs())
    h, _ = attn_sublayer(ctx, p.attn, norm(ctx, p.ln1, x), causal=False, use_rope=False,
                         kv_len=frames)
    x = x + h
    return x + mlp_sublayer(ctx, p.mlp, norm(ctx, p.ln2, x))


def _layers(ctx: Ctx, fn):
    """``fn``, checkpointed under grad when ``cfg.remat``."""
    return remat(fn) if ctx.cfg.remat and torch.is_grad_enabled() else fn


def _positions(ctx: Ctx, b: int, s: int, dtype, device, start: int = 0) -> torch.Tensor:
    """The sinusoidal positions ``start`` .. of ``s`` tokens for ``b`` rows,
    (b, s, D) in the residual layout (a view)."""
    pe = sinusoidal(s, ctx.cfg.d_model, dtype, device, start=start)
    return ctx.cs(pe.expand(b, -1, -1), *RES, src=("batch", None, None))


def _frame_pad(ctx: Ctx, f: int) -> int:
    """Positions that pad ``f`` frames to a multiple of the residual
    stream's sequence axes (0 without a mesh)."""
    if ctx.mesh is None:
        return 0
    return -f % sh.axis_size(ctx.mesh, ctx.axes("residual_seq"))


def encode(ctx: Ctx, params: Whisper, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, D) stub embeddings -> the encoder's states, in the
    residual layout (padded past F on a mesh whose sequence axes do not
    divide F; the padded states are read by nothing)."""
    dt = dtype_of(ctx.cfg)
    b, f, _ = frames.shape
    fp = f + _frame_pad(ctx, f)
    x = F.pad(frames.to(dt), (0, 0, 0, fp - f))
    x = ctx.cs(x, *RES, src=("batch", None, None)) + _positions(ctx, b, fp, dt, frames.device)
    run = _layers(ctx, _enc_block)
    for blk in params.enc_blocks:
        x = run(ctx, blk, x, f)
    return norm(ctx, params.enc_norm, x)


def _dec_block(ctx: Ctx, p: DecBlock, x, enc, frames: "int | None"):
    """A decoder layer over a whole sequence (training, prefill), its
    cross-attention against the first ``frames`` of ``enc`` (all when
    None). Returns (x, its self (k, v), its cross (k, v))."""
    p = ctx.gathered(p, dec_block_specs())
    h, kv = attn_sublayer(ctx, p.attn, norm(ctx, p.ln1, x), use_rope=False)
    x = x + h
    h, xkv = attn_sublayer(ctx, p.xattn, norm(ctx, p.ln_x, x), xkv=enc, use_rope=False,
                           kv_len=frames)
    x = x + h
    return x + mlp_sublayer(ctx, p.mlp, norm(ctx, p.ln2, x)), kv, xkv


def _dec_block_out(ctx: Ctx, p: DecBlock, x, enc, frames: "int | None"):
    return _dec_block(ctx, p, x, enc, frames)[0]


def _embed_tokens(ctx: Ctx, params: Whisper, tokens: torch.Tensor, start: int = 0) -> torch.Tensor:
    """The tokens' embeddings and positions, in the residual layout."""
    x = _embed(ctx, params, tokens, None)
    return x + _positions(ctx, x.shape[0], tokens.shape[1], x.dtype, x.device, start)


def _decoder(ctx: Ctx, params: Whisper, tokens: torch.Tensor, enc: torch.Tensor,
             frames: "int | None") -> torch.Tensor:
    """Teacher-forced decoder pass to the final norm, every position."""
    x = _embed_tokens(ctx, params, tokens)
    run = _layers(ctx, _dec_block_out)
    for blk in params.dec_blocks:
        x = run(ctx, blk, x, enc, frames)
    return whole_positions(ctx, norm(ctx, params.final_norm, x))


def decode_tokens(ctx: Ctx, params: Whisper, tokens: torch.Tensor, enc: torch.Tensor,
                  frames: "int | None" = None) -> torch.Tensor:
    """Teacher-forced decoder pass: (B, S) tokens -> (B, S, V) logits,
    attending to the first ``frames`` of the encoder's states (all when
    None)."""
    return _unembed(ctx, params, _decoder(ctx, params, tokens, enc, frames))


def forward(ctx: Ctx, params: Whisper, tokens: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    return decode_tokens(ctx, params, tokens, encode(ctx, params, frames), frames.shape[1])


def loss_fn(ctx: Ctx, params: Whisper, batch: dict) -> torch.Tensor:
    """Next-token CE of ``batch["tokens"]`` (B, S + 1) given
    ``batch["frames"]``."""
    tokens, frames = batch["tokens"].long(), batch["frames"]
    x = _decoder(ctx, params, tokens[:, :-1], encode(ctx, params, frames), frames.shape[1])
    return chunked_cross_entropy(ctx, x, ctx.weight(params.lm_head, ("fsdp", "vocab")),
                                 tokens[:, 1:])


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
                kv_heads: "int | None" = None) -> WhisperCaches:
    """Zero caches; on a mesh the rank's block (its batch rows, positions
    and ``kv_heads``)."""
    dev, dt = resolve_device(device), dtype_of(cfg)
    hkv = kv_heads or cfg.num_kv_heads
    shape = (cfg.num_layers, batch, max_len, hkv, cfg.hd)
    xshape = (cfg.num_layers, batch, cfg.encoder_frames, hkv, cfg.hd)
    return WhisperCaches(
        self_k=torch.zeros(shape, dtype=dt, device=dev), self_v=torch.zeros(shape, dtype=dt, device=dev),
        cross_k=torch.zeros(xshape, dtype=dt, device=dev), cross_v=torch.zeros(xshape, dtype=dt, device=dev),
        length=0,
    )


@torch.inference_mode()
def prefill(ctx: Ctx, params: Whisper, tokens: torch.Tensor, max_len: int, frames: torch.Tensor):
    """Encode the frames and run the prompt; the self caches (sized
    ``max_len`` or the prompt's length if longer) hold the prompt's keys and
    values, the cross caches every layer's keys and values of the encoder's
    states. Returns (last-token logits (B, 1, V), caches)."""
    enc = encode(ctx, params, frames)
    b, s = tokens.shape
    n, lo = _cache_block(ctx, max(max_len, s))
    caches = init_caches(ctx.cfg, b, n, device=tokens.device, kv_heads=_local_kv_heads(ctx))
    x = _embed_tokens(ctx, params, tokens)
    for i, blk in enumerate(params.dec_blocks):
        x, (k, v), (xk, xv) = _dec_block(ctx, blk, x, enc, frames.shape[1])
        _write_seq(caches.self_k[i], k, 0, lo)
        _write_seq(caches.self_v[i], v, 0, lo)
        caches.cross_k[i] = xk
        caches.cross_v[i] = xv
    x = norm(ctx, params.final_norm, _last_position(ctx, x))
    return _unembed(ctx, params, x), caches._replace(length=s)


def _cross_from_cache(ctx: Ctx, p: Attention, x, xk, xv):
    """Cross-attention over cached K/V (this rank's kv heads): only the q
    and o projections run. x and the result in the residual layout."""
    cfg = ctx.cfg
    x = whole_positions(ctx, x)
    q = _split_heads(ctx, x @ p.wq, cfg.num_heads, "heads4d")
    kl, vl = _kv_for_local_heads(ctx, q, xk, xv, cfg.num_heads, cfg.num_kv_heads)
    o = _attend(ctx, q, kl, vl, causal=False, window=None)
    return ctx.reduce(_wo_columns(ctx, o, cfg.num_heads) @ p.wo, *RES)


@torch.inference_mode()
def decode_step(ctx: Ctx, params: Whisper, token: torch.Tensor, caches: WhisperCaches):
    """One decoder step: (B, 1) token -> (B, 1, V) logits; the new self
    entries are written into ``caches``' own tensors."""
    ln = caches.length
    x = _embed_tokens(ctx, params, token, start=ln)
    for i, blk in enumerate(params.dec_blocks):
        blk = ctx.gathered(blk, dec_block_specs())
        h, _ = attn_sublayer(ctx, blk.attn, norm(ctx, blk.ln1, x), cache=(caches.self_k[i], caches.self_v[i]),
                             cache_len=ln, use_rope=False)
        x = x + h
        x = x + _cross_from_cache(ctx, blk.xattn, norm(ctx, blk.ln_x, x), caches.cross_k[i],
                                  caches.cross_v[i])
        x = x + mlp_sublayer(ctx, blk.mlp, norm(ctx, blk.ln2, x))
    x = norm(ctx, params.final_norm, x)
    return _unembed(ctx, params, x), caches._replace(length=ln + token.shape[1])


# -- sharding specs (the JAX package's tables) -------------------------------------


def _attn_specs(prefix: str) -> dict:
    return {f"{prefix}.wq": ("fsdp", "heads"), f"{prefix}.wk": ("fsdp", "heads"),
            f"{prefix}.wv": ("fsdp", "heads"), f"{prefix}.wo": ("heads", "fsdp")}


def enc_block_specs() -> dict:
    """An encoder layer's logical specs, keyed by the layer-relative names."""
    return {**{f"{ln}.{n}": (None,) for ln in ("ln1", "ln2") for n in ("w", "b")},
            **_attn_specs("attn"), "mlp.w_up": ("fsdp", "d_ff"), "mlp.w_down": ("d_ff", "fsdp")}


def dec_block_specs() -> dict:
    """A decoder layer's: the encoder layer's and the cross-attention's."""
    return {**enc_block_specs(), "ln_x.w": (None,), "ln_x.b": (None,), **_attn_specs("xattn")}


def param_specs(cfg: ModelConfig) -> dict:
    """Logical specs keyed by the parameter names (one tensor a layer)."""
    nrm = {"w": (None,), "b": (None,)}
    return sh.expand_layers(
        {"embed": ("vocab", "fsdp"), "enc_blocks": enc_block_specs(), "enc_norm": nrm,
         "dec_blocks": dec_block_specs(), "final_norm": nrm, "lm_head": ("fsdp", "vocab")},
        {"enc_blocks": cfg.encoder_layers, "dec_blocks": cfg.num_layers})


def cache_specs(cfg: ModelConfig) -> WhisperCaches:
    s = (None, "batch", "kv_seq", "kv_heads4d", None)
    x = (None, "batch", None, "kv_heads4d", None)
    return WhisperCaches(self_k=s, self_v=s, cross_k=x, cross_v=x, length=())
