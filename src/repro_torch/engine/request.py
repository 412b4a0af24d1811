"""The one request shape of the engine's public surface:

    y, report = engine.run(Request("spmv", SpMVInputs(a, x), strategy, "cuda"))

``op`` is an op name or a :class:`~repro_torch.engine.api.MigratoryOp`;
``strategy`` a :class:`~repro_torch.core.strategies.MigratoryStrategy`,
``"auto"`` (the autotuner's pick) or None (the paper defaults);
``substrate`` a substrate instance or registered name, None meaning
``"local"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..core.strategies import MigratoryStrategy


@dataclasses.dataclass(frozen=True)
class Request:
    """One unit of engine work: what to run, on what, under which strategy."""

    op: Any
    inputs: Any
    strategy: "MigratoryStrategy | str | None" = None
    substrate: Any = None  # Substrate | str | None (None = "local")
