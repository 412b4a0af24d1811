"""Family-dispatching model API: ``init_params``, ``loss_fn``,
``train_step`` (loss + grad + AdamW) and ``init_opt`` for training;
``prefill``, ``decode_step`` and ``init_decode_state`` for serving. Six
families: dense, MoE and VLM (``transformer``), SSM (``rwkv6``), hybrid
(``zamba2``) and encoder-decoder (``whisper``)."""
from __future__ import annotations

import torch

from ..optim import AdamWConfig, AdamWState, apply_updates
from ..optim import init as adamw_init
from . import rwkv6, transformer, whisper, zamba2
from .config import ModelConfig
from .layers import Ctx

_FAMILY = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": rwkv6,
    "hybrid": zamba2,
    "encdec": whisper,
}


def module_for(cfg: ModelConfig):
    return _FAMILY[cfg.family]


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    return module_for(cfg).init_params(cfg, seed, device)


def loss_fn(ctx: Ctx, params, batch: dict) -> torch.Tensor:
    """Mean next-token CE of ``batch["tokens"]``, with ``batch["frames"]``
    (encdec) or ``batch["patches"]`` (vlm) where the family takes them."""
    return module_for(ctx.cfg).loss_fn(ctx, params, batch)


def train_step(
    ctx: Ctx, params, opt_state: AdamWState, batch: dict, opt_cfg: AdamWConfig,
    microbatches: int = 1,
):
    """One optimizer step on the model ``params``, in place. With
    ``microbatches`` > 1 the batch splits along its first axis into that
    many equal rows of microbatches; their gradients are accumulated in
    float32 (``g.float() / m`` each) and their losses as ``loss / m``, then
    one update is applied (activation memory / m). Returns (params,
    opt_state, metrics) with ``metrics["loss"]`` (0-d float32 tensor),
    ``"grad_norm"`` and ``"lr"``."""
    named = dict(params.named_parameters())
    weights = list(named.values())
    if microbatches <= 1:
        loss = loss_fn(ctx, params, batch)
        grads = dict(zip(named, torch.autograd.grad(loss, weights)))
        loss = loss.detach()
    else:
        m = microbatches
        b = next(iter(batch.values())).shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by microbatches {m}")
        rows = b // m
        grads = {n: torch.zeros(w.shape, dtype=torch.float32, device=w.device) for n, w in named.items()}
        loss = torch.zeros((), dtype=torch.float32, device=weights[0].device)
        for i in range(m):
            mb = {key: leaf[i * rows:(i + 1) * rows] for key, leaf in batch.items()}
            l = loss_fn(ctx, params, mb)
            for acc, g in zip(grads.values(), torch.autograd.grad(l, weights)):
                acc.add_(g.float() / m)
            loss = loss + l.detach() / m
    params, opt_state, metrics = apply_updates(params, opt_state, grads, opt_cfg)
    metrics["loss"] = loss
    return params, opt_state, metrics


def init_opt(cfg: ModelConfig, params, opt_cfg: AdamWConfig) -> AdamWState:
    del cfg  # the moments follow the parameters
    return adamw_init(params, opt_cfg)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """The empty decode state: the recurrent state of an SSM, else caches
    sized ``max_len``."""
    if cfg.family == "ssm":
        return rwkv6.init_state(cfg, batch, device)
    return module_for(cfg).init_caches(cfg, batch, max_len, device)


def prefill(ctx: Ctx, params, tokens: torch.Tensor, max_len: int, batch: dict | None = None):
    """The prompt pass: (last-token logits, decode state). ``batch`` holds
    the encoder's ``"frames"`` (encdec) or the ``"patches"`` that precede
    the prompt (vlm)."""
    m = module_for(ctx.cfg)
    if ctx.cfg.family == "encdec":
        return m.prefill(ctx, params, tokens, max_len, batch["frames"])
    if ctx.cfg.family == "vlm":
        return m.prefill(ctx, params, tokens, max_len, extra_embeds=batch["patches"])
    return m.prefill(ctx, params, tokens, max_len)


def decode_step(ctx: Ctx, params, token: torch.Tensor, state):
    return module_for(ctx.cfg).decode_step(ctx, params, token, state)
