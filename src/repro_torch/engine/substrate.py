"""Substrates: where a MigratoryOp's plan executes.

Three built-in backends:

- ``local`` — plain PyTorch with the distributed semantics: the port's own
  correctness oracle.
- ``cuda``  — routes the compute hot loops to the hand-written CUDA kernels
  (``kernels/spmv``, ``kernels/bfs``, ``kernels/topk_sim``); the counterpart
  of the JAX package's ``pallas`` substrate.
- ``mesh``  — runs each op's per-nodelet body in rank processes joined by a
  ``torch.distributed`` group (:mod:`repro_torch.launch.mesh`): replication,
  ``all_gather`` pulls, ``all_to_all`` pushes between real processes. Its
  bodies are plain PyTorch on the rank's device, as the JAX package's
  ``shard_map`` bodies are plain ``jnp``.

A substrate does not implement one method per op: its per-op entry points
are *kernels* registered against its ``kind`` in the
:mod:`~repro_torch.engine.registry` (``@kernel("spmv", "cuda")`` below).

Every substrate is bound to one device (``device=``, default ``"cuda"``;
asking for CUDA without a card raises) and accepts only inputs that lie on
it. A ``cuda`` substrate on the CPU runs each kernel's plain PyTorch
version, because the kernel wrappers dispatch on the device of the tensors
they are handed.

Placement (the service's executor pool): a substrate advertises how many
independent execution channels it can keep busy (:meth:`Substrate.placement_slots`),
a :attr:`~Substrate.placement_policy` for routing plan-key groups onto pool
workers, and a per-slot variant (:meth:`Substrate.placement_variant`). On
the card a pool slot is a CUDA stream of its own, which the service owns;
the substrate is shared by every slot.
"""
from __future__ import annotations

import functools
import os
from typing import Callable

import torch

from ..core.bfs import bfs_local, bfs_mesh
from ..core.gsana import (
    DEFAULT_VOCAB, NEG, _merge_pair_topk, _scatter_vertex_major, compute_similarity,
    compute_similarity_mesh, pair_tasks,
)
from ..core.spmv import spmv_local, spmv_mesh, unstripe_vector
from ..core.strategies import Scheme
from ..device import resolve_device
from ..kernels.bfs.ops import bfs_cuda
from ..kernels.spmv.ops import spmv as spmv_kernel
from ..kernels.topk_sim.ops import topk_sim_pairs
from .api import OpNotSupportedError
from .registry import default_registry, kernel


# pool slots a substrate on the card advertises: how many workers of the
# service's executor pool, each on a CUDA stream of its own, one card keeps
# usefully busy with this engine's requests. Two matched or beat one in
# every measured burst and four lost to one: the requests are host time
# (PERF.md, the W = 1, 2, 4 rows of chip_smoke.py and tools/serving_sweep.py)
CUDA_STREAM_SLOTS = 2


class Substrate:
    """Execution backend for MigratoryOps, bound to one device.

    ``name`` labels the instance in reports; ``kind`` (defaults to ``name``)
    is the registry key kernels are looked up under.
    """

    name: str = "abstract"
    kind: str = "abstract"
    #: "spread": groups round-robin over pool workers and idle workers may
    #: steal queued or straggling work. "affinity": a plan-key group is
    #: pinned to one slot and never stolen.
    placement_policy: str = "spread"

    def __init__(self, device: "str | torch.device" = "cuda"):
        self.device = resolve_device(device)

    def kernel(self, op_name: str) -> Callable:
        """Resolve this backend's kernel for ``op_name`` (bound to self).
        Raises :class:`OpNotSupportedError` when no kernel is registered."""
        fn = default_registry().resolve_kernel(op_name, self.kind)
        return functools.partial(fn, self)

    def supports(self, op_name: str) -> bool:
        return default_registry().has_kernel(op_name, self.kind)

    def check_inputs(self, *tensors: torch.Tensor) -> None:
        """Raise unless every tensor lies on this substrate's device."""
        for t in tensors:
            if t.device.type != self.device.type or (
                self.device.index is not None and t.device != self.device
            ):
                raise ValueError(
                    f"{self.name} substrate on {self.device} got an input on {t.device}; "
                    "build the inputs with the same device="
                )

    def cache_fingerprint(self) -> tuple:
        """Hashable identity for the plan cache: two substrate instances with
        equal fingerprints are interchangeable executors."""
        return (self.name, str(self.device))

    def placement_slots(self) -> int:
        """How many pool workers this substrate keeps independently busy;
        ``workers="auto"`` sizes the pool to ``min(8, placement_slots())``.
        On the card: :data:`CUDA_STREAM_SLOTS` streams. On the CPU: the
        core count (executions from different workers overlap in PyTorch's
        intra-op pool, and the operators release the interpreter lock)."""
        if self.device.type == "cuda":
            return CUDA_STREAM_SLOTS
        return max(1, os.cpu_count() or 1)

    def placement_variant(self, slot: int, n_slots: int) -> "Substrate":
        """The substrate instance slot ``slot`` of ``n_slots`` plans
        against: ``self``, since every slot shares one device. (A slot's
        stream is the service's, not part of the fingerprint, so a
        compiled entry serves every slot.)"""
        del slot, n_slots
        return self


class LocalSubstrate(Substrate):
    """Plain PyTorch — the port's oracle, on the CPU or on the card."""

    name = kind = "local"


class CudaSubstrate(Substrate):
    """Routes hot loops to the CUDA kernels (plain versions on the CPU)."""

    name = kind = "cuda"


# the width of a mesh for ops whose inputs carry no partition count (GSANA's
# task list): one Chick node's nodelets, the JAX package's make_nodelet_mesh default
DEFAULT_NODELETS = 8


class MeshSubstrate(Substrate):
    """Runs kernels on a nodelet mesh: an explicit
    :class:`~repro_torch.launch.mesh.NodeletMesh`, else the process's mesh
    of as many ranks as the input has nodelets (:data:`DEFAULT_NODELETS`
    for GSANA), started on first use on this substrate's device.

    ``window`` is the executor pool's per-slot carving: the cards a slot's
    meshes may take, so plans placed on different slots run on disjoint
    cards (the reference carves devices). On one card there is one window.

    The fingerprint holds the device and the window; an explicit mesh adds
    its width and backend. Without one, the width is the input's (its
    shapes are in the plan key's argument signature, GSANA's is the
    constant), and the backend follows from width, device and window."""

    name = kind = "mesh"
    placement_policy = "affinity"

    def __init__(self, device: "str | torch.device" = "cuda", mesh=None, *,
                 window: "tuple[int, ...] | None" = None):
        super().__init__(mesh.device if mesh is not None else device)
        self.mesh = mesh
        self.window = tuple(window) if window else None

    def mesh_for(self, p: int):
        """The mesh kernels run on: the explicit one, else the process's
        ``p``-rank mesh (over the slot's window of cards, if any)."""
        if self.mesh is not None:
            return self.mesh
        from ..launch.mesh import make_nodelet_mesh

        return make_nodelet_mesh(p, self.device, cards=self.window)

    def mesh_of_width(self, p: int, op: str):
        """:meth:`mesh_for` ``p``, raising when an explicit mesh is of another
        width (its ranks would take stripes sized for the wrong count)."""
        mesh = self.mesh_for(p)
        if mesh.p != p:
            raise OpNotSupportedError(
                f"{op} needs a {p}-rank nodelet mesh (inputs.nodelets), got {mesh.p}")
        return mesh

    def cache_fingerprint(self) -> tuple:
        if self.mesh is not None:
            return (self.name, str(self.device), self.mesh.p, self.mesh.backend, "explicit")
        return (self.name, str(self.device), self.window)

    def placement_slots(self) -> int:
        """Independent channels are cards: an explicit mesh is one committed
        channel, the CPU one device."""
        if self.mesh is not None or self.device.type != "cuda":
            return 1
        return max(1, torch.cuda.device_count())

    def placement_variant(self, slot: int, n_slots: int) -> "MeshSubstrate":
        """Slot ``slot``'s window: the ``slot``-th of ``n_slots`` equal
        blocks of cards. ``self`` with an explicit mesh, one slot, or fewer
        cards than slots."""
        width = self.placement_slots() // max(1, n_slots)
        if self.mesh is not None or n_slots <= 1 or width < 1:
            return self
        lo = (slot % n_slots) * width
        return MeshSubstrate(torch.device("cuda", lo), window=tuple(range(lo, lo + width)))


# -- built-in kernels ----------------------------------------------------------
# The algorithm code lives in repro_torch.core.*; these adapters bind it to a
# backend. Registered here (not on the classes) so capability is data.


@kernel("spmv", "local")
def _spmv_local(sub: Substrate, a, x, *, strategy):
    return spmv_local(a, x, strategy)


@kernel("bfs", "local")
def _bfs_local(sub: Substrate, g, root, *, strategy, max_rounds=None):
    return bfs_local(g, root, strategy, max_rounds)


@kernel("gsana", "local")
def _gsana_local(sub: Substrate, vs1, vs2, b1, b2, k, *, strategy):
    return compute_similarity(vs1, vs2, b1, b2, k, strategy.scheme)


@kernel("spmv", "cuda")
def _spmv_cuda(sub: CudaSubstrate, a, x, *, strategy):
    x_full = x if strategy.replicate_x else unstripe_vector(x, a.shape[1])
    p, rp, k = a.cols.shape
    grain = strategy.dynamic_grain(rp)
    # nodelet planes -> one (P*R_p, K) row block; one CUDA block per grain rows
    y = spmv_kernel(
        a.cols.reshape(p * rp, k), a.vals.reshape(p * rp, k), x_full.contiguous(),
        grain=max(1, min(grain, p * rp)),
    )
    return y.reshape(p, rp)


@kernel("bfs", "cuda")
def _bfs_cuda(sub: CudaSubstrate, g, root, *, strategy, max_rounds=None):
    # both S2 strategies share the kernel (deterministic min-merge, same
    # tree as the local oracle); the strategy contributes the grain axis
    return bfs_cuda(g, root, strategy, max_rounds)


@kernel("gsana", "cuda")
def _gsana_cuda(sub: CudaSubstrate, vs1, vs2, b1, b2, k, *, strategy):
    if strategy.scheme != Scheme.PAIR:
        raise OpNotSupportedError("cuda gsana kernel implements the PAIR task shape only")
    pair_b2, pair_b1 = pair_tasks(b2.grid, b2.vid.device)
    scores, u_ids = topk_sim_pairs(
        vs1, vs2, b1, b2, pair_b2, pair_b1, vocab=DEFAULT_VOCAB, k=min(k, b1.cap),
    )
    scores = torch.where(torch.isfinite(scores), scores, NEG)
    cand_b, score_b = _merge_pair_topk(u_ids, scores, b2.grid * b2.grid, k)
    return _scatter_vertex_major(cand_b, score_b, b2, vs2.n, k)


@kernel("spmv", "mesh")
def _spmv_mesh(sub: MeshSubstrate, a, x, *, strategy):
    return spmv_mesh(a, x, strategy, sub.mesh_for(a.P))


@kernel("bfs", "mesh")
def _bfs_mesh(sub: MeshSubstrate, g, root, *, strategy, max_rounds=None):
    return bfs_mesh(g, root, strategy, max_rounds, mesh=sub.mesh_for(g.P))


@kernel("gsana", "mesh")
def _gsana_mesh(sub: MeshSubstrate, vs1, vs2, b1, b2, k, *, strategy):
    return compute_similarity_mesh(vs1, vs2, b1, b2, k, strategy.scheme,
                                   mesh=sub.mesh_for(DEFAULT_NODELETS))


# -- registry ------------------------------------------------------------------

_REGISTRY: dict[str, type[Substrate]] = {}


def register_substrate(cls: type[Substrate]) -> type[Substrate]:
    _REGISTRY[cls.name] = cls
    return cls


def substrate_classes() -> dict[str, type[Substrate]]:
    return dict(sorted(_REGISTRY.items()))


def list_substrates() -> list[str]:
    return sorted(_REGISTRY)


def get_substrate(substrate: "Substrate | str") -> Substrate:
    """Resolve a substrate instance from a name (on the default device,
    ``"cuda"``) or pass an instance through."""
    if isinstance(substrate, Substrate):
        return substrate
    try:
        cls = _REGISTRY[substrate]
    except KeyError:
        raise ValueError(
            f"unknown substrate {substrate!r}; registered: {list_substrates()}"
        ) from None
    return cls()


def substrate_for_mesh(mesh=None, device: "str | torch.device" = "cuda") -> Substrate:
    """Shim resolution: a mesh means the mesh substrate over it, no mesh
    the local substrate on ``device``."""
    if mesh is None:
        return LocalSubstrate(device)
    return MeshSubstrate(mesh.device, mesh)


register_substrate(LocalSubstrate)
register_substrate(CudaSubstrate)
register_substrate(MeshSubstrate)
