"""Carry state across from numpy: build the port's containers (``CSR``,
``PartitionedELL``, ``PartitionedGraph``, ``VertexSet``, ``Buckets``) from a
dict with one entry per field name of the container.

Array fields become tensors on ``device`` with their numpy dtype; the other
fields (shapes, vertex counts, grids) are taken as they are. A dict built
with ``np.asarray`` from the JAX package's object of the same name gives the
port's object holding the same arrays:

    fields = {f: np.asarray(getattr(ref_csr, f)) for f in ("indptr", "indices", "data")}
    csr = from_numpy(CSR, {**fields, "shape": ref_csr.shape}, device="cpu")

The LM's weights and KV caches come across with :func:`lm_params_from_numpy`
and :func:`kv_caches_from_numpy`, the optimizer's state with
:func:`opt_state_from_numpy`, the ``moe_decode`` op's flat parameters with
:func:`moe_decode_params_from_numpy`; :func:`lm_params_to_numpy` and
:func:`opt_state_to_numpy` go back to the JAX package's tree layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .core.gsana_data import Buckets, VertexSet
from .core.spmv import PartitionedELL
from .device import resolve_device
from .models.config import ModelConfig
from .models.layers import dtype_of
from .models.transformer import MOE_DECODE_PARAM_KEYS, KVCaches
from .optim import AdamWState
from .sparse.csr import CSR
from .sparse.graph import PartitionedGraph

CONTAINERS = (CSR, PartitionedELL, PartitionedGraph, VertexSet, Buckets)


def numpy_fields(obj) -> dict[str, Any]:
    """The inverse direction: one entry per dataclass field of ``obj``, array
    fields (tensors, or any object numpy can read, such as the JAX package's
    arrays) as numpy arrays, the others as they are."""
    def host(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v) if hasattr(v, "shape") and hasattr(v, "dtype") else v

    return {f.name: host(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def from_numpy(cls: type, fields: dict[str, Any], device="cuda"):
    """``cls(**fields)`` with every numpy array copied to a tensor on ``device``."""
    if cls not in CONTAINERS:
        raise TypeError(f"{cls.__name__} is not one of {[c.__name__ for c in CONTAINERS]}")
    names = {f.name for f in dataclasses.fields(cls)}
    if set(fields) != names:
        raise ValueError(f"{cls.__name__} needs fields {sorted(names)}, got {sorted(fields)}")
    dev = resolve_device(device)
    return cls(**{
        name: torch.as_tensor(np.array(v), device=dev) if isinstance(v, np.ndarray)
        else v
        for name, v in fields.items()
    })


def lm_params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> dict[str, torch.Tensor]:
    """The port's ``Transformer`` state_dict from the JAX package's
    ``init_params`` tree as numpy arrays: each stacked ``(L, ...)`` block
    array (``attn``, ``mlp`` or ``moe``, the norms) is split into per-layer
    ``blocks.<i>.<sub>.<name>`` entries, and every array is cast to
    ``cfg.dtype`` on ``device``, but an MoE ``router``, which stays float32
    as in both packages. numpy has no bfloat16, so hand bf16 arrays over as
    float32: the round trip is lossless."""
    tensor = _caster(cfg, device)
    return {name: tensor(a, name.rsplit(".", 1)[-1]) for name, a in _by_name(cfg, tree).items()}


def _by_name(cfg: ModelConfig, tree: dict) -> dict:
    """The JAX package's parameter tree (or a tree of the same layout, such
    as an optimizer moment) keyed by the port's parameter names."""
    out = {"embed": tree["embed"], "lm_head": tree["lm_head"]}
    out.update({f"final_norm.{name}": a for name, a in tree["final_norm"].items()})
    for sub, leaves in tree["blocks"].items():
        for name, a in leaves.items():
            if len(a) != cfg.num_layers:
                raise ValueError(f"blocks.{sub}.{name} stacks {len(a)} layers, config has {cfg.num_layers}")
            out.update({f"blocks.{i}.{sub}.{name}": a[i] for i in range(cfg.num_layers)})
    return out


def lm_params_to_numpy(params) -> dict:
    """The JAX package's ``init_params`` tree (numpy, floating tensors as
    float32) from the port's ``Transformer``, or from a dict keyed by its
    parameter names (grads, moments): the inverse of :func:`_by_name`, each
    layer's ``blocks.<i>.<sub>.<name>`` stacked to ``(L, ...)``."""
    named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params

    def host(t):
        t = t.detach()
        return (t.float() if t.is_floating_point() else t).cpu().numpy()

    tree: dict = {"blocks": {}, "final_norm": {}}
    layers: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            layers.setdefault(parts[2], {}).setdefault(parts[3], {})[int(parts[1])] = host(t)
        elif parts[0] == "final_norm":
            tree["final_norm"][parts[1]] = host(t)
        else:
            tree[name] = host(t)
    for sub, leaves in layers.items():
        tree["blocks"][sub] = {n: np.stack([by_layer[i] for i in sorted(by_layer)])
                               for n, by_layer in leaves.items()}
    return tree


def opt_state_from_numpy(cfg: ModelConfig, state_tree, device="cuda") -> AdamWState:
    """The port's ``AdamWState`` from the JAX package's (``step``, ``mu``,
    ``nu``, ``ef_residual``, as a named tuple or a dict, with numpy trees of
    the parameters' layout): moments and residuals float32 on ``device``,
    keyed by the parameter names."""
    fields = state_tree._asdict() if hasattr(state_tree, "_asdict") else dict(state_tree)
    dev = resolve_device(device)

    def moments(tree):
        if tree is None:
            return None
        return {name: torch.as_tensor(np.array(a, np.float32), device=dev)
                for name, a in _by_name(cfg, tree).items()}

    return AdamWState(step=int(fields["step"]), mu=moments(fields["mu"]), nu=moments(fields["nu"]),
                      ef_residual=moments(fields["ef_residual"]))


def opt_state_to_numpy(state: AdamWState) -> dict:
    """The inverse of :func:`opt_state_from_numpy`: a dict of the JAX
    package's ``AdamWState`` fields (``step`` as a numpy int32)."""
    return {"step": np.int32(state.step), "mu": lm_params_to_numpy(state.mu),
            "nu": lm_params_to_numpy(state.nu),
            "ef_residual": None if state.ef_residual is None else lm_params_to_numpy(state.ef_residual)}


def _caster(cfg: ModelConfig, device):
    """numpy array (and its parameter name) -> tensor on ``device`` in
    ``cfg.dtype``, float32 for a ``router``."""
    dev = resolve_device(device)

    def tensor(a, name: str = "") -> torch.Tensor:
        dt = torch.float32 if name == "router" else dtype_of(cfg)
        return torch.as_tensor(np.array(a), device=dev).to(dt)

    return tensor


def moe_decode_params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> dict[str, torch.Tensor]:
    """The ``moe_decode`` op's flat parameter dict (the port's
    ``moe_decode_params`` layout) from the JAX package's
    ``moe_decode_params`` dict as numpy arrays, cast as
    :func:`lm_params_from_numpy` casts."""
    missing = sorted(set(MOE_DECODE_PARAM_KEYS) - set(tree))
    if missing:
        raise ValueError(f"moe_decode params missing {missing}")
    tensor = _caster(cfg, device)
    return {name: tensor(tree[name], name) for name in MOE_DECODE_PARAM_KEYS}


def kv_caches_from_numpy(cfg: ModelConfig, k, v, length, device="cuda") -> KVCaches:
    """``KVCaches`` from the JAX package's ``(L, B, Smax, Hkv, Dh)`` cache
    arrays (as numpy, bf16 upcast to float32) and valid length."""
    dev = resolve_device(device)
    return KVCaches(
        k=torch.as_tensor(np.array(k), device=dev).to(dtype_of(cfg)),
        v=torch.as_tensor(np.array(v), device=dev).to(dtype_of(cfg)),
        length=int(length),
    )
