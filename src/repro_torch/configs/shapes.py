"""Assigned input shapes (arch x shape = the 40 dry-run cells)."""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention: run for SSM/hybrid/SWA archs,
    skip for pure full-attention archs."""
    if shape.name == "long_500k":
        sub_quadratic = cfg.family in ("ssm", "hybrid") or cfg.sliding_window
        if not sub_quadratic:
            return False, "pure full-attention arch: O(S) KV per token at 500k"
    return True, ""


def cells(archs: dict) -> list[tuple[str, str]]:
    """All 40 (arch, shape) cells in a stable order."""
    return [(a, s) for a in archs for s in SHAPES]
