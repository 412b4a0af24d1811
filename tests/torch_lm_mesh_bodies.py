"""Rank bodies of the LM-mesh tests (``tests/test_torch_lm_mesh.py``):
module-level functions, which the rank processes import by name. Each
takes whole tensors, keeps the rank's blocks, and returns its block of the
result with its mesh coordinates."""
from types import SimpleNamespace

import torch

from repro_torch.launch import steps
from repro_torch.models import moe
from repro_torch.models import sharding as sh
from repro_torch.models import transformer
from repro_torch.models.layers import RES, Ctx


def moe_layer(rank, world, group, params, x, *, cfg, rules, mode):
    """``moe_sublayer`` in ``mode`` over this rank's tokens and expert
    blocks (stored as the rules lay them out); the kept and routed slots
    this rank counted."""
    mesh = group.mesh
    specs = {"router": (None, None), **moe.EXPERT_SPECS}
    p = SimpleNamespace(**{n: sh.shard_tensor(mesh, t, rules.spec(*specs[n])).to(group.device)
                           for n, t in params.items()})
    xl = sh.shard_tensor(mesh, x, rules.spec(*RES)).to(group.device)
    mesh.reset_counts()
    out = moe.moe_sublayer(Ctx(cfg, mesh, rules), p, xl, dispatch=mode)
    return {"out": out, "coords": dict(mesh.coords), "routed": mesh.tallies.get("moe_routed", 0),
            "kept": mesh.tallies.get("moe_kept", 0)}


def lm_forward(rank, world, group, params, tokens, *, cfg, rules):
    """The scoring forward over this rank's batch rows: every position,
    its vocab block."""
    mesh = group.mesh
    steps._load_body(rank, world, group, params, None, key="forward", cfg=cfg, rules=rules)
    model = mesh.resident.pop("forward")["params"]
    rows = sh.shard_tensor(mesh, tokens, rules.spec("batch", None)).to(group.device)
    with torch.no_grad():
        logits = transformer.forward(Ctx(cfg, mesh, rules), model, rows)
    return {"logits": logits, "coords": dict(mesh.coords)}


def _host_count(ctx, routed, kept):
    """The MoE slot tally as it was made before it moved into the mesh: the
    kept count read on the host where it is made."""
    if torch.is_grad_enabled():
        return
    ctx.mesh.tally("moe_routed", routed)
    ctx.mesh.tally("moe_kept", int(kept.sum()))


def prefill_host_tally(rank, world, group, batch, *, key, cfg, rules, max_len):
    """``steps._prefill_body`` with the MoE tally read on the host in the
    layer (``_host_count``); the rank's routed and kept slots."""
    count = moe._count
    moe._count = _host_count
    try:
        out = steps._prefill_body(rank, world, group, batch, key=key, cfg=cfg, rules=rules,
                                  max_len=max_len)
    finally:
        moe._count = count
    return out
