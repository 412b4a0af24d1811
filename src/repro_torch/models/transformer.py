"""Decoder-only LM, dense (llama, qwen2, mistral, glm4), MoE (mixtral,
moonshot) and VLM (phi-3-vision: stub patch embeddings prepended to the
tokens) families: per-layer blocks, the training loss, prefill and
KV-cache decode, and the flat single-block parameters of the engine's
``moe_decode`` op.

The functions take ``(ctx, params, ...)`` as the JAX package's do, with
``params`` a :class:`Transformer`: on the ``(data, model)`` mesh the rank's
blocks of the weights (:func:`param_specs`), the tokens the rank's batch
rows, logits the rank's vocab block and the caches the rank's block as
:func:`cache_specs` lays them out (``models/layers.py`` has the layouts).
The context is apart from the weights so
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
from . import sharding as sh
from .config import ModelConfig
from .layers import (
    MLP, RES, Attention, Ctx, RMSNorm, _normal, _write_seq, attn_sublayer, dtype_of, generator,
    mlp_sublayer, norm, remat, whole_positions,
)
from .losses import chunked_cross_entropy
from .moe import EXPERT_SPECS, MoE, moe_sublayer

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


# -- sharding ------------------------------------------------------------------


def block_param_specs(cfg: ModelConfig) -> dict:
    """One block's logical specs, keyed by the block-relative name (the
    JAX package's ``param_specs`` subtree without the layer dim)."""
    norms = ("w", "b") if cfg.norm == "layernorm" else ("w",)
    specs = {f"{ln}.{n}": (None,) for ln in ("ln1", "ln2") for n in norms}
    specs.update({"attn.wq": ("fsdp", "heads"), "attn.wk": ("fsdp", "heads"),
                  "attn.wv": ("fsdp", "heads"), "attn.wo": ("heads", "fsdp")})
    if cfg.qkv_bias:
        specs.update({f"attn.{n}": ("heads",) for n in ("bq", "bk", "bv")})
    if cfg.is_moe:
        specs["moe.router"] = (None, None)
        specs.update({f"moe.{n}": spec for n, spec in EXPERT_SPECS.items()})
    else:
        specs.update({"mlp.w_gate": ("fsdp", "d_ff"), "mlp.w_up": ("fsdp", "d_ff"),
                      "mlp.w_down": ("d_ff", "fsdp")})
    return specs


def param_specs(cfg: ModelConfig) -> dict:
    """Logical specs keyed by the parameter names (one tensor a layer).

    fsdp shards the d_model dim of weights over "data"; heads/d_ff/vocab
    shard over "model"; MoE experts over "data" (EP) with d_model over
    "model" when divisible, else F over "model" (the tp fallback)."""
    block = block_param_specs(cfg)
    specs = {"embed": ("vocab", "fsdp")}
    for i in range(cfg.num_layers):
        specs.update({f"blocks.{i}.{n}": spec for n, spec in block.items()})
    norms = ("w", "b") if cfg.norm == "layernorm" else ("w",)
    specs.update({f"final_norm.{n}": (None,) for n in norms})
    specs["lm_head"] = ("fsdp", "vocab")
    return specs


def cache_specs(cfg: ModelConfig) -> KVCaches:
    """Logical specs of the KV caches (kv_seq shards for long context or
    kv heads that do not divide the model axis)."""
    spec = (None, "batch", "kv_seq", "kv_heads4d", None)
    return KVCaches(k=spec, v=spec, length=())


# -- forward -------------------------------------------------------------------


def _block(ctx: Ctx, p: Block, x, *, pos_offset=0, cache=None, cache_len=None):
    """x in the residual layout; on a mesh the block's weights are gathered
    to their layout at use first (the experts at the MoE sublayer)."""
    p = ctx.gathered(p, block_param_specs(ctx.cfg), keep=("moe",))
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


def _embed(ctx: Ctx, params: Transformer, tokens: torch.Tensor,
           extra_embeds: torch.Tensor | None):
    """Token embedding, after the (B, Np, D) patch embeddings when given
    (vlm), in the residual layout. On a mesh the table is vocab-parallel:
    each rank looks up the tokens of its vocab block, and the sum over
    ``model`` is reduce-scattered into the residual layout."""
    if ctx.mesh is None:
        x = params.embed[tokens]
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        return x
    table = ctx.weight(params.embed, ("vocab", "fsdp"))
    whole = ("batch", None, None)
    vocab = ctx.axes("vocab")
    if not vocab:
        x = table[tokens]
    else:
        lo = ctx.index(vocab) * table.shape[0]
        local = tokens - lo
        inside = (local >= 0) & (local < table.shape[0])
        x = table[torch.where(inside, local, 0)] * inside[..., None].to(table.dtype)
        if extra_embeds is None:
            return ctx.reduce(x, *RES, over=vocab[0])
        x = ctx.psum(x, "vocab")
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return ctx.cs(x, *RES, src=whole)


def _unembed(ctx: Ctx, params: Transformer, x: torch.Tensor) -> torch.Tensor:
    """x (whole sequence positions) -> logits, the rank's vocab block."""
    return x @ ctx.weight(params.lm_head, ("fsdp", "vocab"))


def backbone(ctx: Ctx, params: Transformer, tokens: torch.Tensor,
             extra_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Embed (patches first) + blocks + final norm (no unembed), in the
    residual layout; each block checkpointed under grad when ``cfg.remat``."""
    x = _embed(ctx, params, tokens, extra_embeds)
    run = remat(_block_out) if ctx.cfg.remat and torch.is_grad_enabled() else _block_out
    for blk in params.blocks:
        x = run(ctx, blk, x)
    return norm(ctx, params.final_norm, x)


def forward(ctx: Ctx, params: Transformer, tokens: torch.Tensor,
            extra_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Scoring forward: (B, S) tokens -> (B, [Np +] S, V) logits (on a mesh
    every position, the rank's batch rows and vocab block)."""
    x = whole_positions(ctx, backbone(ctx, params, tokens, extra_embeds))
    return _unembed(ctx, params, x)


def loss_fn(ctx: Ctx, params: Transformer, batch: dict) -> torch.Tensor:
    """Next-token CE of ``batch["tokens"]`` (B, S + 1): the first S tokens
    in, the last S as labels, through :func:`chunked_cross_entropy`. With
    ``batch["patches"]`` (vlm) the patch positions carry no loss."""
    tokens = batch["tokens"].long()
    patches = batch.get("patches")
    x = whole_positions(ctx, backbone(ctx, params, tokens[:, :-1], patches))
    if patches is not None:
        x = x[:, patches.shape[1]:]
    return chunked_cross_entropy(ctx, x, ctx.weight(params.lm_head, ("fsdp", "vocab")),
                                 tokens[:, 1:])


def _last_position(ctx: Ctx, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) in the residual layout -> (B, 1, D), the last position:
    every rank's last row gathered over the seq axes, the last one kept."""
    seq = ctx.axes("residual_seq")
    if not seq:
        return x[:, -1:]
    return sh.all_gather(ctx.mesh, x[:, -1:], seq, 1)[:, -1:]


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


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
                kv_heads: "int | None" = None) -> KVCaches:
    """Zero caches (L, batch, max_len, kv heads, Dh); on a mesh the rank's
    block (its batch rows, positions and ``kv_heads``)."""
    shape = (cfg.num_layers, batch, max_len, kv_heads or cfg.num_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return KVCaches(
        k=torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
        v=torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
        length=0,
    )


def _cache_block(ctx: Ctx, s_max: int) -> tuple[int, int]:
    """(positions a rank's cache holds, the first of them)."""
    seq = ctx.axes("kv_seq")
    n = sh.axis_size(ctx.mesh, seq) if seq else 1
    if s_max % n:
        raise ValueError(f"cache length {s_max} does not divide over kv_seq {seq} ({n})")
    return s_max // n, (ctx.index(seq) * (s_max // n) if seq else 0)


def _local_kv_heads(ctx: Ctx) -> int:
    """The kv heads a rank's cache holds: its block when ``kv_heads4d``
    shards, else all."""
    return ctx.cfg.num_kv_heads // (ctx.size("model") if ctx.axes("kv_heads4d") else 1)


@torch.inference_mode()
def prefill(ctx: Ctx, params: Transformer, tokens: torch.Tensor, max_len: int,
            extra_embeds: torch.Tensor | None = None):
    """Run the prompt (after the patches, vlm), build KV caches sized
    ``max_len`` or the prompt's length if longer. Returns (last-token logits
    (B, 1, V), caches)."""
    x = _embed(ctx, params, tokens, extra_embeds)
    b = x.shape[0]
    s = tokens.shape[1] + (0 if extra_embeds is None else extra_embeds.shape[1])
    n, lo = _cache_block(ctx, max(max_len, s))
    caches = init_caches(ctx.cfg, b, n, device=tokens.device, kv_heads=_local_kv_heads(ctx))
    for i, blk in enumerate(params.blocks):
        x, (k, v) = _block(ctx, blk, x)
        _write_seq(caches.k[i], k, 0, lo)
        _write_seq(caches.v[i], v, 0, lo)
    x = norm(ctx, params.final_norm, _last_position(ctx, x))
    return _unembed(ctx, params, x), caches._replace(length=s)


@torch.inference_mode()
def decode_step(ctx: Ctx, params: Transformer, token: torch.Tensor, caches: KVCaches):
    """One serve step: (B, 1) token -> (B, 1, V) logits and the caches
    advanced. The new entries are written into ``caches``' own tensors."""
    x = _embed(ctx, params, token, None)
    ln = caches.length
    for i, blk in enumerate(params.blocks):
        x, _ = _block(ctx, blk, x, pos_offset=ln, cache=(caches.k[i], caches.v[i]), cache_len=ln)
    x = norm(ctx, params.final_norm, x)
    return _unembed(ctx, params, x), caches._replace(length=ln + token.shape[1])
