"""Family-dispatching model API for serving: ``init_params``, ``prefill``,
``decode_step`` and ``init_decode_state``. The dense and MoE families are
ported (both through ``transformer``); the others raise
``NotImplementedError``."""
from __future__ import annotations

import torch

from . import transformer
from .config import ModelConfig
from .layers import Ctx

_FAMILY = {"dense": transformer, "moe": transformer}


def module_for(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family is {transformer.NOT_PORTED}")
    return _FAMILY[cfg.family]


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    return module_for(cfg).init_params(cfg, seed, device)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    return module_for(cfg).init_caches(cfg, batch, max_len, device)


def prefill(ctx: Ctx, params, tokens: torch.Tensor, max_len: int):
    return module_for(ctx.cfg).prefill(ctx, params, tokens, max_len)


def decode_step(ctx: Ctx, params, token: torch.Tensor, state):
    return module_for(ctx.cfg).decode_step(ctx, params, token, state)
