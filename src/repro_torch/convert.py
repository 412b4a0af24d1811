"""Carry state across from numpy: build the port's containers (``CSR``,
``PartitionedELL``, ``PartitionedGraph``, ``VertexSet``, ``Buckets``) from a
dict with one entry per field name of the container.

Array fields become tensors on ``device`` with their numpy dtype; the other
fields (shapes, vertex counts, grids) are taken as they are. A dict built
with ``np.asarray`` from the JAX package's object of the same name gives the
port's object holding the same arrays:

    fields = {f: np.asarray(getattr(ref_csr, f)) for f in ("indptr", "indices", "data")}
    csr = from_numpy(CSR, {**fields, "shape": ref_csr.shape}, device="cpu")

The LM's weights (every family's tree) come across with
:func:`lm_params_from_numpy`, any family's decode state (KV caches, RWKV-6
state, Zamba2 or Whisper caches) with :func:`decode_state_from_numpy`, the
optimizer's state with
:func:`opt_state_from_numpy`, the ``moe_decode`` op's flat parameters with
:func:`moe_decode_params_from_numpy`; :func:`lm_params_to_numpy` and
:func:`opt_state_to_numpy` go back to the JAX package's tree layout. On the
LM's ``(data, model)`` mesh, :func:`shard_params` gives the block of each
parameter (or moment) a rank holds, and :func:`unshard_params` puts every
rank's blocks back whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .core.gsana_data import Buckets, VertexSet
from .core.spmv import PartitionedELL
from .device import resolve_device
from .models import api
from .models.config import ModelConfig
from .models.sharding import Rules, block_of, unblock
from .models.transformer import MOE_DECODE_PARAM_KEYS, moe_decode_params
from .optim import AdamWState
from .sparse.csr import CSR
from .sparse.graph import PartitionedGraph

CONTAINERS = (CSR, PartitionedELL, PartitionedGraph, VertexSet, Buckets)
# the LM trees' subtrees stacked (L, ...) a layer: decoder or encoder-decoder
_STACKS = ("blocks", "enc_blocks", "dec_blocks")


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
    """The port's model state_dict (any family) from the JAX package's
    ``init_params`` tree as numpy arrays: each stacked ``(L, ...)`` array of
    ``blocks``, ``enc_blocks`` or ``dec_blocks`` is split into per-layer
    ``<stack>.<i>.<path>`` entries, the unstacked subtrees (``final_norm``,
    ``enc_norm``, ``shared_attn``) keep their paths, and every array takes
    the type of its leaf in the tree: ``cfg.dtype``, or float32 for the
    leaves that are float32 whatever the config (an MoE ``router``, rwkv6's
    decay and bonus, Mamba-2's ``a_log``, ``d_skip``, ``dt_bias``). numpy has
    no bfloat16, so hand bf16 arrays over as float32: the round trip is
    lossless."""
    dtypes = _param_dtypes(cfg)
    dev = resolve_device(device)
    return {name: torch.as_tensor(np.array(a), device=dev).to(dtypes[name])
            for name, a in _by_name(cfg, tree).items()}


def _param_dtypes(cfg: ModelConfig) -> dict[str, torch.dtype]:
    """Each parameter's type in the model of ``cfg``, read from one built on
    the meta device (no memory): the port's tree holds the JAX package's
    leaf types (``tests/test_torch_lm_*.py`` pin them)."""
    return {name: t.dtype for name, t in api.init_params(cfg, device="meta").state_dict().items()}


def _flat(tree: dict, prefix: str = ""):
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", v


def _by_name(cfg: ModelConfig, tree: dict) -> dict:
    """The JAX package's parameter tree (or a tree of the same layout, such
    as an optimizer moment) keyed by the port's parameter names."""
    stacks = dict(zip(_STACKS, (cfg.num_layers, cfg.encoder_layers, cfg.num_layers)))
    out = {}
    for path, a in _flat(tree):
        top, _, rest = path.partition(".")
        if top not in stacks:
            out[path] = a
            continue
        if len(a) != stacks[top]:
            raise ValueError(f"{path} stacks {len(a)} layers, config has {stacks[top]}")
        out.update({f"{top}.{i}.{rest}": a[i] for i in range(stacks[top])})
    return out


def lm_params_to_numpy(params) -> dict:
    """The JAX package's ``init_params`` tree (numpy, floating tensors as
    float32) from the port's model (any family), or from a dict keyed by
    its parameter names (grads, moments): the inverse of :func:`_by_name`,
    each layer's ``<stack>.<i>.<path>`` stacked to ``(L, ...)``."""
    named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) else params

    def host(t):
        t = t.detach()
        return (t.float() if t.is_floating_point() else t).cpu().numpy()

    def put(tree: dict, parts: list, value) -> None:
        for key in parts[:-1]:
            tree = tree.setdefault(key, {})
        tree[parts[-1]] = value

    tree: dict = {}
    layers: dict = {}  # (stack, path) -> {layer: array}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] in _STACKS:
            layers.setdefault((parts[0], tuple(parts[2:])), {})[int(parts[1])] = host(t)
        else:
            put(tree, parts, host(t))
    for (stack, path), by_layer in layers.items():
        put(tree, [stack, *path], np.stack([by_layer[i] for i in sorted(by_layer)]))
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


def moe_decode_params_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> dict[str, torch.Tensor]:
    """The ``moe_decode`` op's flat parameter dict (the port's
    ``moe_decode_params`` layout) from the JAX package's
    ``moe_decode_params`` dict as numpy arrays, cast as
    :func:`lm_params_from_numpy` casts (``router`` float32)."""
    missing = sorted(set(MOE_DECODE_PARAM_KEYS) - set(tree))
    if missing:
        raise ValueError(f"moe_decode params missing {missing}")
    dev = resolve_device(device)
    dtypes = {name: t.dtype for name, t in moe_decode_params(cfg, device="meta").items()}
    return {name: torch.as_tensor(np.array(tree[name]), device=dev).to(dtypes[name])
            for name in MOE_DECODE_PARAM_KEYS}


def decode_state_from_numpy(cfg: ModelConfig, state, device="cuda"):
    """The family's decode state (``KVCaches``, ``RWKVState``,
    ``ZambaCaches`` or ``WhisperCaches``) from the JAX package's (a named
    tuple of the same field names, or a dict, arrays as numpy with bf16
    upcast to float32): each array takes the type of its field in the
    port's empty state (``api.init_decode_state``), ``length`` an int."""
    fields = state._asdict() if hasattr(state, "_asdict") else dict(state)
    empty = api.init_decode_state(cfg, 1, 1, device="meta")
    if set(fields) != set(empty._fields):
        raise ValueError(f"{cfg.family} decode state needs fields {sorted(empty._fields)}, "
                         f"got {sorted(fields)}")
    dev = resolve_device(device)
    return type(empty)(**{
        name: int(fields[name]) if name == "length"
        else torch.as_tensor(np.array(fields[name]), device=dev).to(getattr(empty, name).dtype)
        for name in empty._fields
    })


def shard_params(named: dict, cfg: ModelConfig, rules: Rules, coords: dict, sizes: dict) -> dict:
    """The block of each whole tensor of ``named`` (parameters, or moments
    keyed by the parameters' names) that the rank at mesh coordinates
    ``coords`` holds, as ``api.param_specs`` and ``rules`` lay it out
    (views; ``sizes`` is the mesh's axis -> size)."""
    specs = api.param_specs(cfg)
    return {n: block_of(t, rules.spec(*specs[n]), coords, sizes) for n, t in named.items()}


def unshard_params(blocks: list, coords: list, cfg: ModelConfig, rules: Rules,
                   sizes: dict) -> dict:
    """The inverse of :func:`shard_params`: every rank's name-keyed blocks
    (``coords[r]`` the coordinates of ``blocks[r]``) put back whole."""
    specs = api.param_specs(cfg)
    return {n: unblock([b[n] for b in blocks], coords, rules.spec(*specs[n]), sizes)
            for n in blocks[0]}
