"""Logical-axis sharding rules mapped onto the ``(pod?, data, model)`` mesh,
and their realization in rank processes.

Model code names the *logical* axes of its tensors; :class:`Rules` maps them
to mesh axes, as the JAX package's rules do. There GSPMD inserts the
collectives a layout change needs. Here every rank process holds its local
block of each tensor, and :func:`relayout` makes the change with explicit
collectives over the per-axis process groups of the rank's mesh (an object
with ``shape``, ``coords`` and ``group(axis)``, see
``launch/mesh.py::RankMesh``):

- a dim whose mesh axes go away is gathered (``all_gather`` over each axis,
  the minor axis first);
- a dim that takes mesh axes keeps the rank's block (a slice).

Each collective is an autograd function whose backward is its exact adjoint:
``all_gather`` <-> ``reduce_scatter``, ``all_reduce`` <-> ``all_reduce``,
``all_to_all`` <-> ``all_to_all``, a slice <-> zero padding. So a rank's
gradient of a tensor it holds replicated is that copy's share, and the
gradient of a weight is the sum of every copy's share (``models/api.py``
seeds each rank's loss with 1 / ranks and sums the replicated weights'
gradients over their replica axes).

Mesh shapes are given as a mapping of axis name to size (or any object
with ``shape`` and ``axis_names``, such as :class:`launch.mesh.MeshShape`),
not as a device mesh: the rules need only the sizes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

MeshAxes = "tuple[str, ...] | str | None"


@dataclasses.dataclass(frozen=True)
class Rules:
    """logical axis -> mesh axes."""

    batch: MeshAxes = ("data",)
    seq: MeshAxes = None
    residual_seq: MeshAxes = None  # Megatron-SP: residual stream seq-sharded
    kv_seq: MeshAxes = None  # ("data",) for long-context decode
    heads: MeshAxes = "model"  # flattened H*hd projections (always divisible)
    heads4d: MeshAxes = "model"  # explicit head dim of 4-D activations
    kv_heads4d: MeshAxes = "model"  # explicit kv-head dim (replicated if uneven)
    heads_pad: MeshAxes = "model"  # padded-head dim (always divisible)
    d_model: MeshAxes = None
    fsdp: MeshAxes = "data"  # weight-shard axis (d_model dim of weights)
    d_ff: MeshAxes = "model"
    vocab: MeshAxes = "model"
    experts: MeshAxes = "model"  # expert dim of MoE weights (EP storage)
    expert_inner: MeshAxes = None  # d_model dim of expert weights (FSDP when no EP)
    moe_d_ff: MeshAxes = None  # F dim of expert weights ("model" in tp mode)
    replicated: MeshAxes = None

    def spec(self, *axes: "str | None") -> tuple:
        """One entry a dim, as the JAX package's ``PartitionSpec`` holds it:
        None, a mesh axis name, or a tuple of two or more names."""
        return tuple(_entry(None if a is None else getattr(self, a)) for a in axes)


def _entry(v):
    """A spec entry as ``PartitionSpec`` normalizes it: a 1-tuple is its name."""
    if isinstance(v, (tuple, list)):
        v = tuple(v)
        return v[0] if len(v) == 1 else v
    return v


def mesh_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a mesh or a mesh shape given as a mapping."""
    return dict(mesh) if isinstance(mesh, Mapping) else dict(mesh.shape)


def make_rules(
    mesh,
    *,
    num_experts: int = 0,
    num_heads: int = 0,
    num_kv_heads: int = 0,
    vocab_size: int = 0,
    long_context: bool = False,
    seq_shard: bool = False,
) -> Rules:
    """Production rules for the ``(pod?, data, model)`` mesh (the JAX
    package's ``make_rules``, field for field):

    - batch spans (pod, data): DP across pods, DP+FSDP within;
    - 4-D head dims shard over "model" only when divisible; flattened
      H*hd projection dims always shard;
    - experts shard over "data" (EP) when ``num_experts`` divides it, else
      the experts stay whole, their d_model dim FSDP over "data" and F over
      "model" (the tp storage);
    - long-context decode shards the KV sequence over "data";
    - the KV sequence shards over "model" when the kv heads cannot;
    - vocab replicates when it does not divide "model" (whisper's 51865);
    - ``seq_shard``: the residual stream is seq-sharded over "model".
    """
    sizes = mesh_sizes(mesh)
    batch = ("pod", "data") if "pod" in sizes else ("data",)
    fsdp = ("pod", "data") if "pod" in sizes else ("data",)
    ms = sizes.get("model", 1)
    ds = sizes.get("data", 1)
    ep = bool(num_experts) and num_experts % ds == 0
    kv_head_model = bool(num_kv_heads) and num_kv_heads % ms == 0
    return Rules(
        batch=batch,
        fsdp=fsdp,
        residual_seq=("model",) if seq_shard else None,
        kv_seq=_kv_seq_axes(long_context, kv_head_model),
        heads4d="model" if (num_heads and num_heads % ms == 0) else None,
        kv_heads4d="model" if kv_head_model else None,
        experts="data" if ep else None,
        expert_inner="model" if ep else "data",
        moe_d_ff=None if ep else "model",
        vocab="model" if (not vocab_size or vocab_size % ms == 0) else None,
    )


def _kv_seq_axes(long_context: bool, kv_head_model: bool):
    axes = (("data",) if long_context else ()) + (() if kv_head_model else ("model",))
    return axes or None


def axes_of(entry) -> tuple[str, ...]:
    """A rules value or spec entry as a tuple of mesh axis names."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def expand_layers(table: dict, layers: "dict[str, int]") -> dict[str, tuple]:
    """A nested spec table keyed as the JAX package's tree (a subtree per
    layer stack, named in ``layers`` with its depth) as one entry a
    parameter of the port: ``<stack>.<i>.<path>`` for each layer of a
    stack, ``<path>`` for the rest."""
    out: dict[str, tuple] = {}

    def walk(tree: dict, prefix: str, stack: "str | None"):
        for key, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{key}.", stack)
            elif stack is None:
                out[f"{prefix}{key}"] = v
            else:
                for i in range(layers[stack]):
                    out[f"{stack}.{i}.{prefix}{key}"] = v

    for key, v in table.items():
        if key in layers:
            walk(v, "", key)
        elif isinstance(v, dict):
            walk(v, f"{key}.", None)
        else:
            out[key] = v
    return out


# -- the collectives, with their adjoints ----------------------------------------------
#
# ``mesh`` below is a rank's view of its mesh (``launch/mesh.py::RankMesh``):
# ``group(axis)`` has ``all_gather``, ``reduce_scatter``, ``all_reduce`` and
# ``all_to_all`` over dim 0 of the axis's process group.


def _live(mesh, axes) -> tuple[str, ...]:
    """``axes`` without the axes of size 1 (nothing to move over them)."""
    return tuple(a for a in axes_of(axes) if mesh.shape.get(a, 1) > 1)


def _on_dim0(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    dim = dim % x.dim()
    if dim == 0:
        return fn(x.contiguous())
    return fn(x.movedim(dim, 0).contiguous()).movedim(0, dim)


def _gather_raw(mesh, x, axes, dim):
    for a in reversed(axes):  # the minor axis first: block order (major, minor)
        x = _on_dim0(mesh.group(a).all_gather, x, dim)
    return x


def _reduce_scatter_raw(mesh, x, axes, dim):
    for a in axes:  # the major axis first, the adjoint of _gather_raw
        x = _on_dim0(mesh.group(a).reduce_scatter, x, dim)
    return x


def _all_reduce_raw(mesh, x, axes):
    for a in axes:
        x = mesh.group(a).all_reduce(x)
    return x


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather_raw(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_raw(ctx.mesh, g, ctx.axes, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _reduce_scatter_raw(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_raw(ctx.mesh, g, ctx.axes, ctx.dim), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce_raw(mesh, x, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(ctx.mesh, g, ctx.axes), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.group(axis).all_to_all(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.group(ctx.axis).all_to_all(g.contiguous()), None, None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_gather(mesh, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim`` over ``axes`` (tiled)."""
    axes = _live(mesh, axes)
    if not axes:
        return x
    if _differentiable(x):
        return _Gather.apply(x, mesh, axes, dim)
    return _gather_raw(mesh, x, axes, dim)


def reduce_scatter(mesh, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
    """The sum over ``axes`` of every rank's ``x``, this rank's block of it
    along ``dim`` (``psum_scatter`` tiled)."""
    axes = _live(mesh, axes)
    if not axes:
        return x
    if _differentiable(x):
        return _ReduceScatter.apply(x, mesh, axes, dim)
    return _reduce_scatter_raw(mesh, x, axes, dim)


def psum(mesh, x: torch.Tensor, axes) -> torch.Tensor:
    """The sum over ``axes`` of every rank's ``x``."""
    axes = _live(mesh, axes)
    if not axes:
        return x
    if _differentiable(x):
        return _AllReduce.apply(x, mesh, axes)
    return _all_reduce_raw(mesh, x, axes)


def pmax(mesh, x: torch.Tensor, axes) -> torch.Tensor:
    """The elementwise max over ``axes`` (no gradient)."""
    for a in _live(mesh, axes):
        x = mesh.group(a).all_reduce(x.detach(), op="max")
    return x


def all_to_all(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Block j of dim 0 to rank j of ``axis``; the blocks received, in
    source order (``jax.lax.all_to_all(x, axis, 0, 0, tiled=False)``)."""
    if mesh.shape.get(axis, 1) == 1:
        return x
    if _differentiable(x):
        return _AllToAll.apply(x, mesh, axis)
    return mesh.group(axis).all_to_all(x.contiguous())


def axis_index(mesh, axes) -> int:
    """This rank's block index over ``axes`` (major first)."""
    idx = 0
    for a in axes_of(axes):
        idx = idx * mesh.shape.get(a, 1) + mesh.coords.get(a, 0)
    return idx


def axis_size(mesh, axes) -> int:
    """The product of ``axes``' sizes (``mesh`` a mesh or a size mapping)."""
    sizes = mesh if isinstance(mesh, Mapping) else mesh.shape
    n = 1
    for a in axes_of(axes):
        n *= sizes.get(a, 1)
    return n


def relayout(mesh, x: torch.Tensor, src: tuple, dst: tuple) -> torch.Tensor:
    """``x`` from the layout ``src`` to ``dst`` (specs: one entry a dim,
    mesh axes): the dims that lose axes are gathered first, then the dims
    that gain axes keep this rank's block."""
    if mesh is None:
        return x
    src = tuple(_live(mesh, e) for e in src) + ((),) * (x.dim() - len(src))
    dst = tuple(_live(mesh, e) for e in dst) + ((),) * (x.dim() - len(dst))
    for d in range(x.dim()):
        if src[d] != dst[d] and src[d]:
            x = all_gather(mesh, x, src[d], d)
    kept = tuple(dst[d] if src[d] != dst[d] else () for d in range(x.dim()))
    return block_of(x, kept, mesh.coords, mesh.shape)


def shard_tensor(mesh, x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` laid out as ``spec``."""
    return block_of(x, spec, mesh.coords, mesh.shape)


def block_of(x: torch.Tensor, spec: tuple, coords: dict, sizes: dict) -> torch.Tensor:
    """The block of the whole tensor ``x`` laid out as ``spec`` that the
    rank at mesh coordinates ``coords`` holds (a view)."""
    for d, entry in enumerate(spec):
        axes = axes_of(entry)
        n = math.prod(sizes.get(a, 1) for a in axes)
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of size {x.shape[d]} does not divide over {axes} ({n})")
        idx = 0
        for a in axes:
            idx = idx * sizes.get(a, 1) + coords.get(a, 0)
        w = x.shape[d] // n
        x = x.narrow(d, idx * w, w)
    return x


def unblock(blocks: list, coords: list, spec: tuple, sizes: dict) -> torch.Tensor:
    """The whole tensor from every rank's block (``coords[r]`` the mesh
    coordinates of ``blocks[r]``); replicated blocks are written once each."""
    first = blocks[0]
    shape = [first.shape[d] * (math.prod(sizes.get(a, 1) for a in axes_of(spec[d]))
                                if d < len(spec) else 1) for d in range(first.dim())]
    out = torch.empty(shape, dtype=first.dtype, device=first.device)
    for blk, c in zip(blocks, coords):
        block_of(out, spec, c, sizes).copy_(blk)
    return out


def compute_spec(logical: tuple) -> tuple:
    """A weight's layout at its use: the FSDP dims (``fsdp``,
    ``expert_inner``) gathered, the rest as stored."""
    return tuple(None if a in ("fsdp", "expert_inner") else a for a in logical)
