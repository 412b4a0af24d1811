"""Zamba2 hybrid: a Mamba-2 backbone and ONE shared attention block applied
after every group of ``shared_attn_period`` Mamba layers (54 layers, period
6: 9 application points). The shared block's weights are read at every
point; each point keeps its own KV cache.

Functions take ``(ctx, params, ...)`` with ``params`` a :class:`Zamba2`;
``prefill`` and ``decode_step`` run under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from .config import ModelConfig
from .layers import (
    MLP, Attention, Ctx, RMSNorm, _normal, attn_sublayer, dtype_of, generator, mlp_sublayer, norm,
    remat,
)
from .losses import chunked_cross_entropy
from . import sharding as sh
from .mamba2 import (
    CONV_W, P_HEAD, Mamba, MambaLayerState, dims, mamba_param_specs, mamba_sublayer,
)


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
    out, new_state = mamba_sublayer(ctx, blk.mamba, norm(ctx, blk.ln, x), state)
    return x + out, new_state


def _shared_attn_block(ctx: Ctx, p: SharedAttn, x, *, pos_offset=0, cache=None, cache_len=None):
    h, new_cache = attn_sublayer(ctx, p.attn, norm(ctx, p.ln1, x), pos_offset=pos_offset,
                                 cache=cache, cache_len=cache_len)
    x = x + h
    return x + mlp_sublayer(ctx, p.mlp, norm(ctx, p.ln2, x)), new_cache


def _backbone(ctx: Ctx, params: Zamba2, x: torch.Tensor, caches: ZambaCaches | None):
    """The groups of Mamba layers, each followed by the shared block.
    Without caches (training, prefill) the attention takes the whole
    sequence and returns its (k, v); with caches (decode) it writes the new
    entries into each point's cache in place. Returns (x, (the Mamba
    states stacked (L, ...), the attention (k, v) a point))."""
    g, per = _groups(ctx.cfg)
    run = remat(_mamba_layer) if ctx.cfg.remat and caches is None and torch.is_grad_enabled() \
        else _mamba_layer
    hs, convs, kvs = [], [], []
    for gi in range(g):
        for li in range(gi * per, (gi + 1) * per):
            st = None if caches is None else MambaLayerState(caches.mamba_h[li], caches.mamba_conv[li])
            x, st = run(ctx, params.blocks[li], x, st)
            hs.append(st.h)
            convs.append(st.conv)
        if caches is None:
            x, kv = _shared_attn_block(ctx, params.shared_attn, x)
        else:
            x, kv = _shared_attn_block(ctx, params.shared_attn, x, pos_offset=caches.length,
                                       cache=(caches.attn_k[gi], caches.attn_v[gi]),
                                       cache_len=caches.length)
        kvs.append(kv)
    return x, (torch.stack(hs), torch.stack(convs), kvs)


def forward(ctx: Ctx, params: Zamba2, tokens: torch.Tensor) -> torch.Tensor:
    """Scoring forward: (B, S) tokens -> (B, S, V) logits."""
    x, _ = _backbone(ctx, params, params.embed[tokens], None)
    return norm(ctx, params.final_norm, x) @ params.lm_head


def loss_fn(ctx: Ctx, params: Zamba2, batch: dict) -> torch.Tensor:
    """Next-token CE of ``batch["tokens"]`` (B, S + 1)."""
    tokens = batch["tokens"].long()
    x, _ = _backbone(ctx, params, params.embed[tokens[:, :-1]], None)
    return chunked_cross_entropy(ctx, norm(ctx, params.final_norm, x), params.lm_head, tokens[:, 1:])


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
    """Run the prompt; build the caches (attention caches sized ``max_len``).
    Returns (last-token logits (B, 1, V), caches)."""
    b, s = tokens.shape
    caches = init_caches(ctx.cfg, b, max_len, device=tokens.device)
    x, (hs, convs, kvs) = _backbone(ctx, params, params.embed[tokens], None)
    for gi, (k, v) in enumerate(kvs):
        caches.attn_k[gi, :, :s] = k
        caches.attn_v[gi, :, :s] = v
    x = norm(ctx, params.final_norm, x[:, -1:])
    return x @ params.lm_head, caches._replace(mamba_h=hs, mamba_conv=convs, length=s)


@torch.inference_mode()
def decode_step(ctx: Ctx, params: Zamba2, token: torch.Tensor, caches: ZambaCaches):
    """One serve step: (B, 1) token -> (B, 1, V) logits and the caches
    advanced (the Mamba states anew, the attention entries in place)."""
    x, (hs, convs, _) = _backbone(ctx, params, params.embed[token], caches)
    x = norm(ctx, params.final_norm, x)
    return x @ params.lm_head, caches._replace(mamba_h=hs, mamba_conv=convs,
                                               length=caches.length + token.shape[1])


# -- sharding specs (the JAX package's tables; no mesh runs this family yet) ----


def param_specs(cfg: ModelConfig) -> dict:
    """Logical specs keyed by the parameter names (one tensor a layer)."""
    attn = {"wq": ("fsdp", "heads"), "wk": ("fsdp", "heads"),
            "wv": ("fsdp", "heads"), "wo": ("heads", "fsdp")}
    return sh.expand_layers(
        {"embed": ("vocab", "fsdp"),
         "blocks": {"ln": {"w": (None,)}, "mamba": mamba_param_specs()},
         "shared_attn": {"ln1": {"w": (None,)}, "ln2": {"w": (None,)}, "attn": attn,
                         "mlp": {"w_gate": ("fsdp", "d_ff"), "w_up": ("fsdp", "d_ff"),
                                 "w_down": ("d_ff", "fsdp")}},
         "final_norm": {"w": (None,)}, "lm_head": ("fsdp", "vocab")},
        {"blocks": cfg.num_layers})


def cache_specs(cfg: ModelConfig) -> ZambaCaches:
    return ZambaCaches(
        mamba_h=(None, "batch", "heads4d", None, None),
        mamba_conv=(None, "batch", None, "heads"),
        attn_k=(None, "batch", "kv_seq", "kv_heads4d", None),
        attn_v=(None, "batch", "kv_seq", "kv_heads4d", None),
        length=(),
    )
