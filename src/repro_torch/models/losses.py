"""Chunked cross-entropy: never materializes the full (B, S, V) logits.

The unembed + CE over a 100k+ vocab dominates training memory if done in one
shot (float32 logits + their backward). Chunking the sequence, each chunk
under a non-reentrant activation checkpoint, bounds the live logits to one
(B, chunk, V) block and recomputes them in the backward pass, as the JAX
package's rematted scan (``nothing_saveable``) does.

On the ``(data, model)`` mesh ``x`` is the rank's batch rows (every
position) and ``lm_head`` its vocab block: the logsumexp reduces its max
and its sum over the vocab axes, the gold logit comes from the rank whose
block holds the label, and the sums of CE and of positions are reduced
over the batch axes, so every rank returns the global mean.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import sharding as sh
from .layers import Ctx, remat

CE_CHUNK = 512


def _chunk_loss(xi: torch.Tensor, lm_head: torch.Tensor, li: torch.Tensor, ctx: Ctx):
    """(sum of CE over the chunk's non-pad positions, their count)."""
    logits = (xi @ lm_head).float()
    vocab = () if ctx is None else ctx.axes("vocab")
    if not vocab:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, li.clamp_min(0)[..., None])[..., 0]
    else:
        m = sh.pmax(ctx.mesh, logits.detach().amax(dim=-1), vocab)
        logz = torch.log(sh.psum(ctx.mesh, torch.exp(logits - m[..., None]).sum(-1), vocab)) + m
        local = li.clamp_min(0) - ctx.index(vocab) * logits.shape[-1]
        inside = (local >= 0) & (local < logits.shape[-1])
        picked = torch.gather(logits, -1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        gold = sh.psum(ctx.mesh, torch.where(inside, picked, 0.0), vocab)
    mask = (li >= 0).float()
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_cross_entropy(
    ctx: Ctx, x: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor,
    chunk: int = CE_CHUNK,
) -> torch.Tensor:
    """x: (B, S, D) final-normed activations; labels: (B, S) (-1 = pad).

    Returns mean CE over non-pad positions (0-d float32)."""
    b, s, d = x.shape
    c = min(chunk, s)
    s_pad = -(-s // c) * c
    labels = labels.long()
    if s_pad != s:
        x = F.pad(x, (0, 0, 0, s_pad - s))
        labels = F.pad(labels, (0, s_pad - s), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    run = remat(_chunk_loss) if torch.is_grad_enabled() else _chunk_loss
    for lo in range(0, s_pad, c):
        t, n = run(x[:, lo:lo + c], lm_head, labels[:, lo:lo + c], ctx)
        tot, cnt = tot + t, cnt + n
    if ctx is not None:
        tot, cnt = ctx.psum(tot, "batch"), ctx.psum(cnt.detach(), "batch")
    return tot / torch.clamp(cnt, min=1.0)
