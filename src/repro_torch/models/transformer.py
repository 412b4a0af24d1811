"""Decoder-only LM, dense (llama, qwen2, mistral, glm4), MoE (mixtral,
moonshot) and VLM (phi-3-vision: stub patch embeddings prepended to the
tokens) families: per-layer blocks, the training loss, prefill and
KV-cache decode, and the flat single-block parameters of the engine's
``moe_decode`` op.

The functions take ``(ctx, params, ...)`` as the JAX package's do, with
``params`` a :class:`Transformer`. The context is apart from the weights so
that one set of weights can run under another config, such as another
``attn_impl``. ``prefill`` and ``decode_step`` run under
``torch.inference_mode()``. Under grad with ``cfg.remat`` on,
:func:`backbone` runs each block under a non-reentrant activation
checkpoint, as the JAX package remats each scanned block.
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
from .moe import MoE, moe_sublayer

class KVCaches(NamedTuple):
    k: torch.Tensor  # (L, B, Smax, Hkv, Dh)
    v: torch.Tensor
    length: int  # valid prefix


class Block(nn.Module):
    """``ln1``, ``attn``, ``ln2`` and the feed-forward: ``moe`` (the experts)
    for an MoE config, else ``mlp``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg, cfg.d_model, device)
        self.ln2 = RMSNorm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, gen, device)
        if cfg.is_moe:
            self.moe = MoE(cfg, gen, device)
        else:
            self.mlp = MLP(cfg, gen, device)


class Transformer(nn.Module):
    """The weights: ``embed`` (V, D), ``blocks.<i>`` (``ln1``, ``attn``,
    ``ln2``, ``mlp`` or ``moe``), ``final_norm``, ``lm_head`` (D, V). Matrices are drawn
    from N(0, 0.02) by a ``torch.Generator`` seeded with ``seed`` on
    ``device``, norms start at ones and biases at zeros, as the JAX
    package's ``init_params`` (whose random numbers differ)."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        gen = generator(dev, seed)
        self.cfg = cfg
        self.embed = _normal((cfg.vocab_size, cfg.d_model), cfg, gen, dev)
        self.blocks = nn.ModuleList(Block(cfg, gen, dev) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg, cfg.d_model, dev)
        self.lm_head = _normal((cfg.d_model, cfg.vocab_size), cfg, gen, dev)

    def forward(self, tokens: torch.Tensor, extra_embeds: torch.Tensor | None = None) -> torch.Tensor:
        return forward(Ctx(self.cfg), self, tokens, extra_embeds)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Transformer:
    return Transformer(cfg, seed=seed, device=device)


# -- forward -------------------------------------------------------------------


def _block(ctx: Ctx, p: Block, x, *, pos_offset=0, cache=None, cache_len=None):
    h, new_cache = attn_sublayer(ctx, p.attn, norm(ctx, p.ln1, x), pos_offset=pos_offset,
                                 cache=cache, cache_len=cache_len)
    x = x + h
    if hasattr(p, "moe"):
        x = x + moe_sublayer(ctx, p.moe, norm(ctx, p.ln2, x))
    else:
        x = x + mlp_sublayer(ctx, p.mlp, norm(ctx, p.ln2, x))
    return x, new_cache


def _block_out(ctx: Ctx, p: Block, x):
    return _block(ctx, p, x)[0]


def _embed(params: Transformer, tokens: torch.Tensor, extra_embeds: torch.Tensor | None):
    """Token embedding, after the (B, Np, D) patch embeddings when given (vlm)."""
    x = params.embed[tokens]
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def backbone(ctx: Ctx, params: Transformer, tokens: torch.Tensor,
             extra_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Embed (patches first) + blocks + final norm (no unembed); each block
    checkpointed under grad when ``cfg.remat``."""
    x = _embed(params, tokens, extra_embeds)
    run = remat(_block_out) if ctx.cfg.remat and torch.is_grad_enabled() else _block_out
    for blk in params.blocks:
        x = run(ctx, blk, x)
    return norm(ctx, params.final_norm, x)


def forward(ctx: Ctx, params: Transformer, tokens: torch.Tensor,
            extra_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Scoring forward: (B, S) tokens -> (B, [Np +] S, V) logits."""
    return backbone(ctx, params, tokens, extra_embeds) @ params.lm_head


def loss_fn(ctx: Ctx, params: Transformer, batch: dict) -> torch.Tensor:
    """Next-token CE of ``batch["tokens"]`` (B, S + 1): the first S tokens
    in, the last S as labels, through :func:`chunked_cross_entropy`. With
    ``batch["patches"]`` (vlm) the patch positions carry no loss."""
    tokens = batch["tokens"].long()
    patches = batch.get("patches")
    x = backbone(ctx, params, tokens[:, :-1], patches)
    if patches is not None:
        x = x[:, patches.shape[1]:]
    return chunked_cross_entropy(ctx, x, params.lm_head, tokens[:, 1:])


# -- serving -------------------------------------------------------------------


# the keys of moe_decode_params, the layout the engine's moe_decode op reads
MOE_DECODE_PARAM_KEYS = (
    "embed", "ln1", "ln2", "ln_f", "wq", "wk", "wv", "wo",
    "router", "w_gate", "w_up", "w_down", "lm_head",
)


def moe_decode_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict[str, torch.Tensor]:
    """Flat single-block MoE decode-serving params for the engine's
    ``moe_decode`` op (``engine/decode_op.py``): one single-head attention
    sublayer (head dim = d_model), one MoE sublayer in the :class:`MoE`
    layout (``router`` float32), rmsnorms at ones; matrices drawn in place
    from N(0, 0.02) by a generator seeded with ``seed`` on ``device``. Use a
    float32 config (``serve-moe``) where decode is held against the JAX
    package."""
    dev = resolve_device(device)
    gen = generator(dev, seed)
    d, dt = cfg.d_model, dtype_of(cfg)
    moe = MoE(cfg, gen, dev)
    p = {"embed": _normal((cfg.vocab_size, d), cfg, gen, dev)}
    p.update({name: torch.ones(d, dtype=dt, device=dev) for name in ("ln1", "ln2", "ln_f")})
    p.update({name: _normal((d, d), cfg, gen, dev) for name in ("wq", "wk", "wv", "wo")})
    p.update({name: getattr(moe, name) for name in ("router", "w_gate", "w_up", "w_down")})
    p["lm_head"] = _normal((d, cfg.vocab_size), cfg, gen, dev)
    return {name: t.detach() for name, t in p.items()}


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device="cuda") -> KVCaches:
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return KVCaches(
        k=torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
        v=torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
        length=0,
    )


@torch.inference_mode()
def prefill(ctx: Ctx, params: Transformer, tokens: torch.Tensor, max_len: int,
            extra_embeds: torch.Tensor | None = None):
    """Run the prompt (after the patches, vlm), build KV caches sized
    ``max_len`` or the prompt's length if longer. Returns (last-token logits
    (B, 1, V), caches)."""
    x = _embed(params, tokens, extra_embeds)
    b, s = x.shape[:2]
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
