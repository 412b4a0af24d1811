"""Elastic re-meshing: rebuild programs when the healthy device set shrinks.

Policy: the "model" axis is sacred (TP state layout); shrink the "data" axis
to the largest power-of-two that the survivors support, re-shard params via
host round-trip (restore path), and keep the GLOBAL batch constant by raising
per-device batch (preferred) or microbatching. The deterministic pipeline
makes the data stream independent of the mesh shape.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data_axis: int
    model_axis: int
    per_device_batch_factor: float  # vs the healthy-mesh configuration
    microbatches: int


def plan_remesh(
    n_healthy: int, model_axis: int, global_batch: int, prev_data_axis: int,
    hbm_headroom_frac: float = 0.8,
) -> ElasticPlan:
    """Choose the new mesh for ``n_healthy`` devices (model axis preserved)."""
    if n_healthy < model_axis:
        raise ValueError(
            f"cannot preserve model axis {model_axis} with {n_healthy} devices"
        )
    data = 1
    while data * 2 * model_axis <= n_healthy:
        data *= 2
    # keep global batch: per-device batch grows by prev/new
    factor = prev_data_axis / data
    # if activations no longer fit, fall back to gradient accumulation
    micro = 1
    while factor / micro > 1.0 / hbm_headroom_frac:
        micro *= 2
    return ElasticPlan(
        data_axis=data, model_axis=model_axis,
        per_device_batch_factor=factor, microbatches=micro,
    )


def make_elastic_mesh(plan: ElasticPlan, device="cuda", **kw):
    """A ``(data, model)`` mesh of the plan's shape (rank processes on
    ``device``; ``kw`` as :func:`repro_torch.launch.mesh.make_mesh`)."""
    from ..launch.mesh import make_mesh

    return make_mesh((plan.data_axis, plan.model_axis), ("data", "model"), device, **kw)


def remesh(old, new) -> None:
    """Re-shard a train program's resident state onto another mesh through
    the host (the checkpoint restore path): the weights and the optimizer
    state of ``old`` gathered whole, then loaded into ``new`` (both
    ``launch.steps.CellPrograms``; ``new`` built on the new mesh)."""
    new.load(old.gather_params(), old.gather_opt_state())
