"""Chunked cross-entropy: never materializes the full (B, S, V) logits.

The unembed + CE over a 100k+ vocab dominates training memory if done in one
shot (float32 logits + their backward). Chunking the sequence, each chunk
under a non-reentrant activation checkpoint, bounds the live logits to one
(B, chunk, V) block and recomputes them in the backward pass, as the JAX
package's rematted scan (``nothing_saveable``) does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Ctx, remat

CE_CHUNK = 512


def _chunk_loss(xi: torch.Tensor, lm_head: torch.Tensor, li: torch.Tensor):
    """(sum of CE over the chunk's non-pad positions, their count)."""
    logits = (xi @ lm_head).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, li.clamp_min(0)[..., None])[..., 0]
    mask = (li >= 0).float()
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_cross_entropy(
    ctx: Ctx, x: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor,
    chunk: int = CE_CHUNK,
) -> torch.Tensor:
    """x: (B, S, D) final-normed activations; labels: (B, S) (-1 = pad).

    Returns mean CE over non-pad positions (0-d float32)."""
    del ctx  # one device: no sharding constraints
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
        t, n = run(x[:, lo:lo + c], lm_head, labels[:, lo:lo + c])
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)
