"""The one request shape of the engine's public surface:

    y, report = engine.run(Request("spmv", SpMVInputs(a, x), strategy, "cuda"))
    fut = service.submit(Request("spmv", SpMVInputs(a, x)))   # batch ticket or future

``op`` is an op name or a :class:`~repro_torch.engine.api.MigratoryOp`;
``strategy`` a :class:`~repro_torch.core.strategies.MigratoryStrategy`,
``"auto"`` (the autotuner's pick) or None (the paper defaults);
``substrate`` a substrate instance or registered name, None meaning
``"local"`` (or the service's default substrate).

Serving-only fields ride along:

- ``qos``: per-request scheduling weight. Overrides the service's per-op
  ``qos`` table for this request's plan-key group (higher runs first).
- ``timeout``: per-request deadline in seconds from admission. A request
  still queued when its deadline passes is shed instead of run — its future
  raises :class:`~repro_torch.engine.service.ServiceTimeout`, counted in
  ``ServiceStats.timed_out``. ``engine.run`` ignores it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core.strategies import MigratoryStrategy


@dataclasses.dataclass(frozen=True)
class Request:
    """One unit of engine work: what to run, on what, under which strategy,
    plus the serving QoS/deadline envelope."""

    op: Any
    inputs: Any
    strategy: "MigratoryStrategy | str | None" = None
    substrate: Any = None  # Substrate | str | None (None = "local")
    qos: "float | None" = None
    timeout: "float | None" = None

    def __post_init__(self):
        if self.qos is not None and float(self.qos) <= 0:
            raise ValueError(f"qos must be > 0, got {self.qos!r}")
        if self.timeout is not None and float(self.timeout) < 0:
            raise ValueError(f"timeout must be >= 0, got {self.timeout!r}")

    def to_wire(self, *, segments=None, blob_sink=None) -> dict:
        """The stable wire form of this request: a JSON-compatible dict with
        dtype/shape-preserving tensor encoding, the bytes the dedup content
        hash is taken over. ``op`` travels by name and ``substrate`` by
        registered name; the receiver resolves both through its own
        registries. ``segments`` (a :class:`~repro_torch.engine.wire.SegmentTable`)
        and ``blob_sink`` move input arrays out of inline base64 into
        out-of-band segments / content-addressed blobrefs."""
        from .substrate import Substrate, list_substrates
        from .wire import WIRE_VERSION, WireError, encode_value

        op = self.op
        if not isinstance(op, str):
            op = getattr(op, "name", None)
            if not isinstance(op, str):
                raise WireError(
                    f"op {self.op!r} has no registry name; pass the op by name for wire transport"
                )
        substrate = self.substrate
        if substrate is not None and not isinstance(substrate, str):
            if not isinstance(substrate, Substrate) or substrate.name not in list_substrates():
                raise WireError(
                    f"substrate {substrate!r} is not a registered substrate name; "
                    "only registered substrates cross the wire"
                )
            substrate = substrate.name
        return {
            "v": WIRE_VERSION,
            "op": op,
            "inputs": encode_value(self.inputs, segments=segments, blob_sink=blob_sink),
            "strategy": encode_value(self.strategy),
            "substrate": substrate,
            "qos": None if self.qos is None else float(self.qos),
            "timeout": None if self.timeout is None else float(self.timeout),
        }

    @classmethod
    def from_wire(
        cls, payload: dict, *, blob_resolver=None, device: "str | torch.device" = "cuda",
    ) -> "Request":
        """Rebuild a Request from :meth:`to_wire` output on ``device``: the
        decoded tensors are moved there, and a named substrate is built
        there (the substrates accept only inputs on their own device).
        ``blob_resolver`` (digest -> array) resolves any ``blobref`` nodes."""
        from ..device import resolve_device
        from .substrate import substrate_classes
        from .wire import WIRE_VERSION, WireError, decode_value, to_device

        version = payload.get("v")
        if version != WIRE_VERSION:
            raise WireError(f"wire version mismatch: got {version!r}, expected {WIRE_VERSION}")
        dev = resolve_device(device)
        substrate = payload.get("substrate")
        if substrate is not None:
            classes = substrate_classes()
            if substrate not in classes:
                raise WireError(f"unknown substrate {substrate!r} on the wire; known: {sorted(classes)}")
            substrate = classes[substrate](dev)
        return cls(
            op=payload["op"],
            inputs=to_device(decode_value(payload["inputs"], blob_resolver=blob_resolver), dev),
            strategy=decode_value(payload["strategy"]),
            substrate=substrate,
            qos=payload.get("qos"),
            timeout=payload.get("timeout"),
        )
