"""Carry state across from numpy: build the port's containers (``CSR``,
``PartitionedELL``, ``PartitionedGraph``, ``VertexSet``, ``Buckets``) from a
dict with one entry per field name of the container.

Array fields become tensors on ``device`` with their numpy dtype; the other
fields (shapes, vertex counts, grids) are taken as they are. A dict built
with ``np.asarray`` from the JAX package's object of the same name gives the
port's object holding the same arrays:

    fields = {f: np.asarray(getattr(ref_csr, f)) for f in ("indptr", "indices", "data")}
    csr = from_numpy(CSR, {**fields, "shape": ref_csr.shape}, device="cpu")
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .core.gsana_data import Buckets, VertexSet
from .core.spmv import PartitionedELL
from .device import resolve_device
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
