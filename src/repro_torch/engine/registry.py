"""The op x substrate kernel registry.

Ops and substrates stay decoupled: an op contributes an :class:`OpSpec`
(how to build it), a backend contributes kernels — concrete
``(op_name, substrate_kind)`` entry points — and the registry is the only
place the two meet:

    @kernel("spmv", "cuda")
    def _spmv_cuda(substrate, a, x, *, strategy): ...

    register_op(OpSpec(name="spmv", factory=SpMVOp, inputs_type=SpMVInputs))

``Substrate.kernel(op_name)`` resolves through :meth:`KernelRegistry.resolve_kernel`;
absence *is* the capability signal — it raises
:class:`~repro_torch.engine.api.OpNotSupportedError`.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import TYPE_CHECKING, Any, Callable

from .api import OpNotSupportedError

if TYPE_CHECKING:
    import torch

# A kernel is a plain function: (substrate, *args, **statics) -> result.
Kernel = Callable[..., Any]


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """Everything the engine needs to serve one op, minus the kernels.

    ``factory`` builds the :class:`~repro_torch.engine.api.MigratoryOp`
    adapter; ``inputs_type`` is the op's input dataclass. ``cost_model`` is
    the op's analytic cost-model factory (``inputs -> strategy ->
    CostEstimate``); registering the spec installs it in
    :mod:`repro_torch.core.cost`, so ``cost_model_for(name, inputs)`` serves
    every registered op from one lookup. ``grid`` yields the op's autotune
    candidate strategies (None: the default S1 x S2 x S3 cross product); a
    grid callable that accepts an argument receives the target substrate's
    kind and may widen a kernel-tuning axis for it.
    """

    name: str
    factory: Callable[[], Any]
    inputs_type: "type | None" = None
    cost_model: "Callable[[Any], Any] | None" = None
    grid: "Callable[..., list] | None" = None


class KernelRegistry:
    """Thread-safe ``(op_name, substrate_kind) -> kernel`` table plus the
    op-spec table. One default instance serves the process."""

    def __init__(self):
        self._lock = threading.RLock()
        self._specs: dict[str, OpSpec] = {}
        self._kernels: dict[tuple[str, str], Kernel] = {}

    def register_op(self, spec: OpSpec, *, replace: bool = False) -> OpSpec:
        with self._lock:
            if spec.name in self._specs and not replace:
                raise ValueError(f"op {spec.name!r} already registered")
            self._specs[spec.name] = spec
        if spec.cost_model is not None:
            from ..core.cost import register_cost_model

            register_cost_model(spec.name, spec.cost_model)
        return spec

    def op_spec(self, name: str) -> OpSpec:
        with self._lock:
            try:
                return self._specs[name]
            except KeyError:
                raise ValueError(f"unknown op {name!r}; known: {sorted(self._specs)}") from None

    def ops(self) -> list[str]:
        with self._lock:
            return sorted(self._specs)

    def register_kernel(
        self, op_name: str, substrate_kind: str, fn: Kernel, *, replace: bool = False
    ) -> Kernel:
        key = (op_name, substrate_kind)
        with self._lock:
            if key in self._kernels and not replace:
                raise ValueError(f"kernel {key} already registered")
            self._kernels[key] = fn
        return fn

    def resolve_kernel(self, op_name: str, substrate_kind: str) -> Kernel:
        """The dispatch point: missing entry == unsupported capability."""
        with self._lock:
            fn = self._kernels.get((op_name, substrate_kind))
        if fn is None:
            raise OpNotSupportedError(
                f"no kernel registered for op {op_name!r} on substrate "
                f"{substrate_kind!r} (registered kernels for this op: "
                f"{[k for o, k in self.kernels() if o == op_name]})"
            )
        return fn

    def has_kernel(self, op_name: str, substrate_kind: str) -> bool:
        with self._lock:
            return (op_name, substrate_kind) in self._kernels

    def kernels(self) -> list[tuple[str, str]]:
        with self._lock:
            return sorted(self._kernels)


_DEFAULT_REGISTRY = KernelRegistry()


def default_registry() -> KernelRegistry:
    """The process-wide registry every engine entry point dispatches through."""
    return _DEFAULT_REGISTRY


def register_op(spec: OpSpec, *, replace: bool = False) -> OpSpec:
    return _DEFAULT_REGISTRY.register_op(spec, replace=replace)


def kernel(op_name: str, substrate_kind: str, *, replace: bool = False):
    """Decorator: ``@kernel("spmv", "cuda")`` registers the function as the
    cuda backend's SpMV entry point in the default registry."""

    def deco(fn: Kernel) -> Kernel:
        return _DEFAULT_REGISTRY.register_kernel(op_name, substrate_kind, fn, replace=replace)

    return deco


def capabilities() -> dict[str, dict[str, bool]]:
    """The op x substrate capability table: for every registered op, which
    registered substrates resolve a kernel for it. Reads the substrate
    classes, so it needs no device."""
    from .substrate import substrate_classes

    reg = _DEFAULT_REGISTRY
    return {
        op_name: {name: reg.has_kernel(op_name, cls.kind) for name, cls in substrate_classes().items()}
        for op_name in reg.ops()
    }


def placement_table(device: "str | torch.device" = "cuda") -> dict[str, dict[str, Any]]:
    """The placement view the service's executor pool routes by: for every
    registered substrate built on ``device``, its kernel-lookup kind, its
    placement policy (``"spread"`` = round-robin + work stealing,
    ``"affinity"`` = a plan-key group pins to one slot) and how many
    independent execution slots it drives (``placement_slots()``: CUDA
    streams on the card, cores on the CPU). ``workers="auto"`` services
    size their pools from it."""
    from .substrate import substrate_classes

    table: dict[str, dict[str, Any]] = {}
    for name, cls in substrate_classes().items():
        sub = cls(device)
        table[name] = {"kind": sub.kind, "policy": sub.placement_policy,
                       "slots": sub.placement_slots()}
    return table
