"""AdamW with decoupled weight decay, global-norm clipping, and optional
error-feedback int8 gradient compression.

The compression hook implements the standard EF-SGD trick: quantize the
gradient to int8 with a per-tensor scale, carry the quantization residual in
the optimizer state, add it back next step. A tensor here is one of the JAX
package's stacked arrays: the layers of one block weight share a scale
(:func:`scale_groups`).

The arithmetic and its order are the JAX package's (``optim/adamw.py``):
grads cast to float32, then the optional compression, then the global norm
and clipping, then the moments and the bias-corrected update in float32,
cast back to each parameter's type. The schedule and the bias corrections
are float32 scalars, as there. Unlike there, :func:`apply_updates` works in
place: parameters and moments keep their tensors, and the float32 copy of a
gradient lives for one parameter at a time, so the optimizer adds one
parameter's float32 temporaries to the moments, not a float32 copy of every
gradient.

On the LM's ``(data, model)`` mesh each rank updates its blocks in place,
given a ``reduce`` (``models/api.py::MeshReduce``): the global gradient
norm sums every rank's squares with each replicated block counted once,
and the int8 scale's amax is the max over every rank's blocks of the
group, as the JAX package's global ``max`` is.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Iterable, Mapping, NamedTuple

import torch
from torch import nn


class AdamWState(NamedTuple):
    step: int  # steps applied
    mu: dict  # parameter name -> float32 first moment
    nu: dict  # parameter name -> float32 second moment
    ef_residual: dict | None  # error-feedback residual (None if compression off)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    compress_grads: bool = False  # int8 EF compression (cross-pod trick)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup + cosine decay to min_lr_frac, in float32."""
    warm = torch.clamp(_f32(step) / _f32(max(cfg.warmup_steps, 1)), max=1.0)
    t = torch.clamp(
        _f32(step - cfg.warmup_steps) / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
        0.0, 1.0,
    )
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return float(cfg.lr * warm * cos)


def _named(params) -> dict[str, torch.Tensor]:
    """Parameter name -> tensor, from a module or a mapping."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def init(params, cfg: AdamWConfig) -> AdamWState:
    """Zero float32 moments (and residuals, with compression) keyed by the
    parameter names of ``params`` (a module or a name -> tensor mapping)."""
    named = _named(params)

    def zeros() -> dict:
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in named.items()}

    return AdamWState(step=0, mu=zeros(), nu=zeros(),
                      ef_residual=zeros() if cfg.compress_grads else None)


def _quantize_int8(g: torch.Tensor, amax: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes of ``g`` and their scale, ``amax`` (default: ``g``'s
    largest magnitude) / 127."""
    scale = torch.clamp(g.abs().max() if amax is None else amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(g: torch.Tensor, residual: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """EF int8 round-trip: returns (decompressed grad, new residual)."""
    return _compress_group([g], [residual])[0]


def _compress_group(gs: list, residuals: list, reduce=None) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """EF int8 round-trip of tensors quantized with one shared scale: a
    (decompressed grad, new residual) pair for each."""
    g_efs = [g + r for g, r in zip(gs, residuals)]
    amax = torch.stack([g.abs().max() for g in g_efs]).max()
    if reduce is not None:
        amax = reduce.amax(amax)
    out = []
    for g_ef in g_efs:
        q, scale = _quantize_int8(g_ef, amax)
        deq = q.float() * scale
        out.append((deq, g_ef - deq))
    return out


def scale_groups(names) -> list[list[str]]:
    """The parameters that share one int8 scale: the JAX package stacks the
    layers' weights into one ``(L, ...)`` array and quantizes each array
    with one scale, so ``blocks.<i>.<rest>`` for every i is one group; any
    other name is a group of its own."""
    groups: dict[str, list[str]] = {}
    for n in names:
        groups.setdefault(re.sub(r"^blocks\.\d+\.", "blocks.", n), []).append(n)
    return list(groups.values())


def global_norm(tensors: Mapping[str, torch.Tensor] | Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32 (0-d tensor)."""
    vals = tensors.values() if isinstance(tensors, Mapping) else tensors
    return torch.sqrt(sum(x.float().square().sum() for x in vals))


@torch.no_grad()
def apply_updates(params, state: AdamWState, grads: Mapping[str, torch.Tensor], cfg: AdamWConfig,
                  reduce=None):
    """One AdamW step, in place. ``params`` is a module or a name -> tensor
    mapping, ``grads`` holds a gradient for each of its names (``reduce``:
    the mesh's norm and amax reductions, module docstring). Returns
    (params, state, metrics) as the JAX package does; ``state``'s moments
    (and residuals) are the same tensors, updated, and its step advanced;
    metrics are ``grad_norm`` (0-d float32 tensor, before clipping) and
    ``lr`` (the step's learning rate)."""
    named = _named(params)
    step = state.step + 1
    src = dict(grads)
    if cfg.compress_grads:
        for group in scale_groups(named):
            pairs = _compress_group([src[n].float() for n in group],
                                    [state.ef_residual[n] for n in group], reduce)
            for n, (deq, resid) in zip(group, pairs):
                src[n] = deq
                state.ef_residual[n].copy_(resid)

    gnorm = global_norm(src) if reduce is None else torch.sqrt(reduce.sum_squares(src))
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(gnorm.new_tensor(cfg.clip_norm) / torch.clamp(gnorm, min=1e-9), max=1.0)

    lr = schedule(cfg, step)
    b1c = float(1 - _f32(cfg.b1) ** _f32(step))
    b2c = float(1 - _f32(cfg.b2) ** _f32(step))

    for n, p in named.items():
        m, v = state.mu[n], state.nu[n]
        g = src.pop(n).float()
        if scale is not None:
            g = g * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
        del g
        p32 = p.float()
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps)).add_(p32 * cfg.weight_decay)
        p.copy_(p32 - delta.mul_(lr))
    return params, state._replace(step=step), {"grad_norm": gnorm, "lr": lr}
