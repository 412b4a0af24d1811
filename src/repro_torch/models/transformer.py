"""Decoder-only LM, dense family (llama, qwen2, mistral, glm4): per-layer
blocks, prefill and KV-cache decode.

The functions take ``(ctx, params, ...)`` as the JAX package's do, with
``params`` a :class:`Transformer`. The context is apart from the weights so
that one set of weights can run under another config, such as another
``attn_impl``. ``prefill`` and ``decode_step`` run under
``torch.inference_mode()``; activation checkpointing (the JAX package's
remat) only matters for training and has no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from .config import ModelConfig
from .layers import MLP, Attention, Ctx, RMSNorm, _normal, attn_sublayer, dtype_of, mlp_sublayer, norm

NOT_PORTED = "not ported yet (ROADMAP.md, queue 1 item 10: 'LM stack: what is left')"


class KVCaches(NamedTuple):
    k: torch.Tensor  # (L, B, Smax, Hkv, Dh)
    v: torch.Tensor
    length: int  # valid prefix


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg, cfg.d_model, device)
        self.ln2 = RMSNorm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, gen, device)
        self.mlp = MLP(cfg, gen, device)


class Transformer(nn.Module):
    """The weights: ``embed`` (V, D), ``blocks.<i>`` (``ln1``, ``attn``,
    ``ln2``, ``mlp``), ``final_norm``, ``lm_head`` (D, V). Matrices are drawn
    from N(0, 0.02) by a ``torch.Generator`` seeded with ``seed`` on
    ``device``, norms start at ones and biases at zeros, as the JAX
    package's ``init_params`` (whose random numbers differ)."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.is_moe:
            raise NotImplementedError(f"{cfg.name}: the MoE layer stack is {NOT_PORTED}")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        self.embed = _normal((cfg.vocab_size, cfg.d_model), cfg, gen, dev)
        self.blocks = nn.ModuleList(Block(cfg, gen, dev) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg, cfg.d_model, dev)
        self.lm_head = _normal((cfg.d_model, cfg.vocab_size), cfg, gen, dev)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(Ctx(self.cfg), self, tokens)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Transformer:
    return Transformer(cfg, seed=seed, device=device)


# -- forward -------------------------------------------------------------------


def _block(ctx: Ctx, p: Block, x, *, pos_offset=0, cache=None, cache_len=None):
    h, new_cache = attn_sublayer(ctx, p.attn, norm(ctx, p.ln1, x), pos_offset=pos_offset,
                                 cache=cache, cache_len=cache_len)
    x = x + h
    x = x + mlp_sublayer(ctx, p.mlp, norm(ctx, p.ln2, x))
    return x, new_cache


def backbone(ctx: Ctx, params: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Embed + blocks + final norm (no unembed)."""
    x = params.embed[tokens]
    for blk in params.blocks:
        x, _ = _block(ctx, blk, x)
    return norm(ctx, params.final_norm, x)


def forward(ctx: Ctx, params: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Scoring forward: (B, S) tokens -> (B, S, V) logits."""
    return backbone(ctx, params, tokens) @ params.lm_head


# -- serving -------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> KVCaches:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return KVCaches(
        k=torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
        v=torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
        length=0,
    )


@torch.inference_mode()
def prefill(ctx: Ctx, params: Transformer, tokens: torch.Tensor, max_len: int):
    """Run the prompt, build KV caches sized ``max_len``. Returns (last-token
    logits (B, 1, V), caches)."""
    x = params.embed[tokens]
    b, s = tokens.shape
    caches = init_caches(ctx.cfg, b, max(max_len, s), device=tokens.device)
    for i, blk in enumerate(params.blocks):
        x, (k, v) = _block(ctx, blk, x)
        caches.k[i, :, :s] = k
        caches.v[i, :, :s] = v
    x = norm(ctx, params.final_norm, x)
    return x[:, -1:, :] @ params.lm_head, caches._replace(length=s)


@torch.inference_mode()
def decode_step(ctx: Ctx, params: Transformer, token: torch.Tensor, caches: KVCaches):
    """One serve step: (B, 1) token -> (B, 1, V) logits and the caches
    advanced. The new entries are written into ``caches``' own tensors."""
    x = params.embed[token]
    ln = caches.length
    for i, blk in enumerate(params.blocks):
        x, _ = _block(ctx, blk, x, pos_offset=ln, cache=(caches.k[i], caches.v[i]), cache_len=ln)
    x = norm(ctx, params.final_norm, x)
    return x @ params.lm_head, caches._replace(length=ln + token.shape[1])
