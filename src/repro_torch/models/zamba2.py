"""Zamba2 hybrid: a Mamba-2 backbone and ONE shared attention block applied
after every group of ``shared_attn_period`` Mamba layers (54 layers, period
6: 9 application points). The shared block's weights are read at every
point; each point keeps its own KV cache.

Functions take ``(ctx, params, ...)`` with ``params`` a :class:`Zamba2`;
``prefill`` and ``decode_step`` run under ``torch.inference_mode()``.

On the ``(data, model)`` mesh (``models/layers.py``) the embedding and
``lm_head`` are vocab-parallel as the transformer's, each Mamba layer's
weights are gathered to their layout at use (``models/mamba2.py`` has its
mesh branch), and the shared block's once a forward, then read at every
application point (their gradients summed over the points before one
reduce-scatter). Its attention and MLP are the transformer's sublayers; each
point's cache holds this rank's rows, positions and kv heads.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from . import sharding as sh
from .config import ModelConfig
from .layers import (
    MLP, Attention, Ctx, RMSNorm, _normal, _write_seq, attn_sublayer, dtype_of, generator,
    mlp_sublayer, norm, remat, whole_positions,
)
from .losses import chunked_cross_entropy
from .mamba2 import (
    CONV_W, P_HEAD, Mamba, MambaLayerState, dims, mamba_param_specs, mamba_sublayer,
)
from .transformer import _cache_block, _embed, _last_position, _local_kv_heads, _unembed


class ZambaCaches(NamedTuple):
    mamba_h: torch.Tensor  # (L, B, H, N, P) float32
    mamba_conv: torch.Tensor  # (L, B, CONV_W - 1, Dconv)
    attn_k: torch.Tensor  # (A, B, Smax, Hkv, Dh), one an application point
    attn_v: torch.Tensor
    length: int  # valid prefix of the attention caches


def _groups(cfg: ModelConfig) -> tuple[int, int]:
    """(application points, Mamba layers a group)."""
    period = cfg.shared_attn_period or cfg.num_layers
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not groups of {period}")
    return cfg.num_layers // period, period


class MambaBlock(nn.Module):
    """``ln`` and ``mamba``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg, cfg.d_model, device)
        self.mamba = Mamba(cfg, gen, device)


class SharedAttn(nn.Module):
    """The one shared block: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg, cfg.d_model, device)
        self.ln2 = RMSNorm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, gen, device)
        self.mlp = MLP(cfg, gen, device)


class Zamba2(nn.Module):
    """The weights: ``embed`` (V, D), ``blocks.<i>`` (``ln``, ``mamba``),
    ``shared_attn``, ``final_norm``, ``lm_head`` (D, V); matrices from
    N(0, 0.02) by a generator seeded with ``seed`` on ``device``."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        _groups(cfg)
        dev = resolve_device(device)
        gen = generator(dev, seed)
        self.cfg = cfg
        self.embed = _normal((cfg.vocab_size, cfg.d_model), cfg, gen, dev)
        self.blocks = nn.ModuleList(MambaBlock(cfg, gen, dev) for _ in range(cfg.num_layers))
        self.shared_attn = SharedAttn(cfg, gen, dev)
        self.final_norm = RMSNorm(cfg, cfg.d_model, dev)
        self.lm_head = _normal((cfg.d_model, cfg.vocab_size), cfg, gen, dev)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Zamba2:
    return Zamba2(cfg, seed=seed, device=device)


def _mamba_layer(ctx: Ctx, blk: MambaBlock, x, state):
    blk = ctx.gathered(blk, mamba_block_specs())
    out, new_state = mamba_sublayer(ctx, blk.mamba, norm(ctx, blk.ln, x), state)
    return x + out, new_state


def _shared_attn_block(ctx: Ctx, p, x, *, pos_offset=0, cache=None, cache_len=None):
    h, new_cache = attn_sublayer(ctx, p.attn, norm(ctx, p.ln1, x), pos_offset=pos_offset,
                                 cache=cache, cache_len=cache_len)
    x = x + h
    return x + mlp_sublayer(ctx, p.mlp, norm(ctx, p.ln2, x)), new_cache


def _backbone(ctx: Ctx, params: Zamba2, x: torch.Tensor, caches: ZambaCaches | None):
    """The groups of Mamba layers, each followed by the shared block; x in
    the residual layout. Without caches (training, prefill) the attention
    takes the whole sequence and returns its (k, v); with caches (decode) it
    writes the new entries into each point's cache in place. Returns (x,
    (the Mamba states stacked (L, ...), the attention (k, v) a point))."""
    g, per = _groups(ctx.cfg)
    run = remat(_mamba_layer) if ctx.cfg.remat and caches is None and torch.is_grad_enabled() \
        else _mamba_layer
    shared = ctx.gathered(params.shared_attn, shared_attn_specs())
    hs, convs, kvs = [], [], []
    for gi in range(g):
        for li in range(gi * per, (gi + 1) * per):
            st = None if caches is None else MambaLayerState(caches.mamba_h[li], caches.mamba_conv[li])
            x, st = run(ctx, params.blocks[li], x, st)
            hs.append(st.h)
            convs.append(st.conv)
        if caches is None:
            x, kv = _shared_attn_block(ctx, shared, x)
        else:
            x, kv = _shared_attn_block(ctx, shared, x, pos_offset=caches.length,
                                       cache=(caches.attn_k[gi], caches.attn_v[gi]),
                                       cache_len=caches.length)
        kvs.append(kv)
    return x, (torch.stack(hs), torch.stack(convs), kvs)


def forward(ctx: Ctx, params: Zamba2, tokens: torch.Tensor) -> torch.Tensor:
    """Scoring forward: (B, S) tokens -> (B, S, V) logits (on a mesh the
    rank's rows and vocab block)."""
    x, _ = _backbone(ctx, params, _embed(ctx, params, tokens, None), None)
    return _unembed(ctx, params, whole_positions(ctx, norm(ctx, params.final_norm, x)))


def loss_fn(ctx: Ctx, params: Zamba2, batch: dict) -> torch.Tensor:
    """Next-token CE of ``batch["tokens"]`` (B, S + 1)."""
    tokens = batch["tokens"].long()
    x, _ = _backbone(ctx, params, _embed(ctx, params, tokens[:, :-1], None), None)
    return chunked_cross_entropy(ctx, whole_positions(ctx, norm(ctx, params.final_norm, x)),
                                 ctx.weight(params.lm_head, ("fsdp", "vocab")), tokens[:, 1:])


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> ZambaCaches:
    g, _ = _groups(cfg)
    _, n, h, dconv = dims(cfg)
    dev, dt = resolve_device(device), dtype_of(cfg)
    kv = (g, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return ZambaCaches(
        mamba_h=torch.zeros((cfg.num_layers, batch, h, n, P_HEAD), dtype=torch.float32, device=dev),
        mamba_conv=torch.zeros((cfg.num_layers, batch, CONV_W - 1, dconv), dtype=dt, device=dev),
        attn_k=torch.zeros(kv, dtype=dt, device=dev),
        attn_v=torch.zeros(kv, dtype=dt, device=dev),
        length=0,
    )


@torch.inference_mode()
def prefill(ctx: Ctx, params: Zamba2, tokens: torch.Tensor, max_len: int):
    """Run the prompt; build the caches (attention caches sized ``max_len``
    or the prompt's length if longer). Returns (last-token logits (B, 1, V),
    caches)."""
    b, s = tokens.shape
    n, lo = _cache_block(ctx, max(max_len, s))
    x, (hs, convs, kvs) = _backbone(ctx, params, _embed(ctx, params, tokens, None), None)
    kv = (len(kvs), b, n, _local_kv_heads(ctx), ctx.cfg.hd)
    attn_k, attn_v = (torch.zeros(kv, dtype=dtype_of(ctx.cfg), device=tokens.device)
                      for _ in range(2))
    for gi, (k, v) in enumerate(kvs):
        _write_seq(attn_k[gi], k, 0, lo)
        _write_seq(attn_v[gi], v, 0, lo)
    x = norm(ctx, params.final_norm, _last_position(ctx, x))
    return _unembed(ctx, params, x), ZambaCaches(mamba_h=hs, mamba_conv=convs, attn_k=attn_k,
                                                 attn_v=attn_v, length=s)


@torch.inference_mode()
def decode_step(ctx: Ctx, params: Zamba2, token: torch.Tensor, caches: ZambaCaches):
    """One serve step: (B, 1) token -> (B, 1, V) logits and the caches
    advanced (the Mamba states anew, the attention entries in place)."""
    x, (hs, convs, _) = _backbone(ctx, params, _embed(ctx, params, token, None), caches)
    x = norm(ctx, params.final_norm, x)
    return _unembed(ctx, params, x), caches._replace(mamba_h=hs, mamba_conv=convs,
                                                     length=caches.length + token.shape[1])


# -- sharding specs (the JAX package's tables) -------------------------------------


def mamba_block_specs() -> dict:
    """A Mamba layer's logical specs, keyed by the layer-relative names."""
    return {"ln.w": (None,), **{f"mamba.{n}": spec for n, spec in mamba_param_specs().items()}}


def shared_attn_specs() -> dict:
    """The shared block's logical specs (no layer dim: one block)."""
    return {"ln1.w": (None,), "ln2.w": (None,),
            "attn.wq": ("fsdp", "heads"), "attn.wk": ("fsdp", "heads"),
            "attn.wv": ("fsdp", "heads"), "attn.wo": ("heads", "fsdp"),
            "mlp.w_gate": ("fsdp", "d_ff"), "mlp.w_up": ("fsdp", "d_ff"),
            "mlp.w_down": ("d_ff", "fsdp")}


def param_specs(cfg: ModelConfig) -> dict:
    """Logical specs keyed by the parameter names (one tensor a layer)."""
    return sh.expand_layers(
        {"embed": ("vocab", "fsdp"), "blocks": mamba_block_specs(),
         "shared_attn": shared_attn_specs(), "final_norm": {"w": (None,)},
         "lm_head": ("fsdp", "vocab")},
        {"blocks": cfg.num_layers})


def cache_specs(cfg: ModelConfig) -> ZambaCaches:
    return ZambaCaches(
        mamba_h=(None, "batch", "heads4d", None, None),
        mamba_conv=(None, "batch", None, "heads"),
        attn_k=(None, "batch", "kv_seq", "kv_heads4d", None),
        attn_v=(None, "batch", "kv_seq", "kv_heads4d", None),
        length=(),
    )
