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
and :func:`kv_caches_from_numpy`.
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
from .models.transformer import KVCaches
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
    array is split into per-layer ``blocks.<i>.<sub>.<name>`` entries, and
    every array is cast to ``cfg.dtype`` on ``device``. numpy has no
    bfloat16, so hand bf16 arrays over as float32: the round trip is
    lossless."""
    dev = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        return torch.as_tensor(np.array(a), device=dev).to(dtype_of(cfg))

    sd = {"embed": tensor(tree["embed"]), "lm_head": tensor(tree["lm_head"])}
    sd.update({f"final_norm.{name}": tensor(a) for name, a in tree["final_norm"].items()})
    for sub, leaves in tree["blocks"].items():
        for name, a in leaves.items():
            if len(a) != cfg.num_layers:
                raise ValueError(f"blocks.{sub}.{name} stacks {len(a)} layers, config has {cfg.num_layers}")
            sd.update({f"blocks.{i}.{sub}.{name}": tensor(a[i]) for i in range(cfg.num_layers)})
    return sd


def kv_caches_from_numpy(cfg: ModelConfig, k, v, length, device="cuda") -> KVCaches:
    """``KVCaches`` from the JAX package's ``(L, B, Smax, Hkv, Dh)`` cache
    arrays (as numpy, bf16 upcast to float32) and valid length."""
    dev = resolve_device(device)
    return KVCaches(
        k=torch.as_tensor(np.array(k), device=dev).to(dtype_of(cfg)),
        v=torch.as_tensor(np.array(v), device=dev).to(dtype_of(cfg)),
        length=int(length),
    )
