"""Public op: pack VertexSet metadata into dense feature planes and run the
fused similarity+top-k kernel over a PAIR task list."""
from __future__ import annotations

import torch

from ...core.gsana import DEFAULT_VOCAB, pack_features
from ...core.gsana_data import Buckets, VertexSet
from .kernel import topk_sim

__all__ = ["pack_features", "pair_planes", "topk_sim_pairs"]


def pair_planes(
    vs1: VertexSet,
    vs2: VertexSet,
    b1: Buckets,
    b2: Buckets,
    pair_b2: torch.Tensor,  # (P,) QT2 bucket id per task
    pair_b1: torch.Tensor,  # (P,) QT1 bucket id per task (-1 = inactive task)
    vocab: tuple[int, int, int] = DEFAULT_VOCAB,
):
    """The kernel's inputs for a PAIR task list: feature planes
    ``(P, cap2, F)`` and ``(P, cap1, F)``, their validity masks, and the
    global u ids ``(P, cap1)`` (-1 on padding) that slot indices map back to."""
    f1 = pack_features(vs1, vocab)
    f2 = pack_features(vs2, vocab)
    v_idx = b2.vid[pair_b2.long()]  # (P, cap2)
    u_idx = torch.where(pair_b1[:, None] >= 0, b1.vid[pair_b1.clamp(min=0).long()], -1)
    fv = f2[v_idx.clamp(min=0).long()]
    fu = f1[u_idx.clamp(min=0).long()]
    return fv, fu, (v_idx >= 0).float(), (u_idx >= 0).float(), u_idx


def topk_sim_pairs(
    vs1: VertexSet,
    vs2: VertexSet,
    b1: Buckets,
    b2: Buckets,
    pair_b2: torch.Tensor,
    pair_b1: torch.Tensor,
    *,
    vocab: tuple[int, int, int] = DEFAULT_VOCAB,
    k: int = 4,
):
    """Run all PAIR tasks. Returns (scores (P, cap2, k), u_ids (P, cap2, k)),
    u_ids -1 wherever the score is not finite."""
    t1, t2, t3 = vocab
    fv, fu, mv, mu, u_idx = pair_planes(vs1, vs2, b1, b2, pair_b2, pair_b1, vocab)
    scores, local_ix = topk_sim(fv, fu, mv, mu, t1=t1, t2=t2, t3=t3, k=k)
    u_ids = torch.gather(u_idx, 1, local_ix.flatten(1).long()).view_as(local_ix)
    return scores, torch.where(torch.isfinite(scores), u_ids, -1)
