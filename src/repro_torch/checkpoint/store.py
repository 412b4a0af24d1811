"""Atomic, async checkpointing with keep-k retention.

Layout (the JAX package's): ``<dir>/step_<N>/`` holds ``leaves.npz``, one
array per leaf of the tree (``leaf0``, ``leaf1``, ...), and
``manifest.json`` (tree structure, shapes and dtypes). Writes go to
``step_<N>.tmp`` and are atomically renamed after fsync, so a crashed save
can never shadow a good one. :class:`AsyncCheckpointer` overlaps the disk
IO with the next training steps.

A tree is built from modules (their ``state_dict``), dicts, tuples, lists
and named tuples, with tensors, numbers and ``None`` (no leaf) at the ends.
numpy has no bfloat16: a bf16 tensor is stored as its ``uint16`` bit
pattern, with ``"bfloat16"`` in the manifest, and restored bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

BF16 = "bfloat16"


def _children(tree: Any) -> list[tuple[str, Any]] | None:
    """(name, subtree) pairs of an inner node in a fixed order, or None for
    a leaf."""
    if isinstance(tree, nn.Module):
        return list(tree.state_dict(keep_vars=True).items())
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (tuple, list)):
        return [(getattr(tree, "_fields", range(len(tree)))[i], t) for i, t in enumerate(tree)]
    return None


def _paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """Every leaf with its dotted path, depth first; ``None`` has none."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [leaf for name, sub in kids for leaf in _paths(sub, f"{prefix}{name}.")]


def _host(x: Any) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array that shares no memory with it, and its
    dtype's name (``"bfloat16"`` for bit patterns)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16), BF16
        a = t.to("cpu", copy=True).numpy()
    else:
        a = np.array(x)
    return a, str(a.dtype)


def _flatten(tree: Any) -> tuple[list[tuple[str, np.ndarray, str]], list[str]]:
    """Host copies of every leaf as (key, array, dtype name), and the leaves'
    paths (the tree's structure)."""
    paths = _paths(tree)
    keyed = [(f"leaf{i}", *_host(x)) for i, (_, x) in enumerate(paths)]
    return keyed, [p.rstrip(".") for p, _ in paths]


def _write(directory: Path, step: int, keyed: list, treedef: list[str], keep: int) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step}.tmp"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    np.savez(tmp / "leaves.npz", **{k: a for k, a, _ in keyed})
    manifest = {
        "step": step,
        "treedef": treedef,
        "leaves": [{"key": k, "shape": list(a.shape), "dtype": dt} for k, a, dt in keyed],
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    # fsync the directory entries then atomically publish
    fd = os.open(tmp, os.O_RDONLY)
    os.fsync(fd)
    os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _retain(directory, keep)
    return final


def save(directory: str | Path, step: int, tree: Any, keep: int = 3) -> Path:
    """Synchronous atomic save of ``tree`` at ``step``."""
    keyed, treedef = _flatten(tree)
    return _write(Path(directory), step, keyed, treedef, keep)


def _retain(directory: Path, keep: int) -> None:
    steps = sorted(
        (int(p.name.split("_")[1]), p)
        for p in directory.glob("step_*")
        if not p.name.endswith(".tmp")
    )
    for _, p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str | Path) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in directory.glob("step_*")
        if not p.name.endswith(".tmp") and (p / "manifest.json").exists()
    ]
    return max(steps) if steps else None


def _load_leaf(arr: np.ndarray, dtype: str, like: Any) -> Any:
    """The stored array as ``like``'s kind: written into ``like`` itself for
    a tensor, a number of ``like``'s type otherwise."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if dtype == BF16 \
            else torch.from_numpy(arr)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} for a tensor of {tuple(like.shape)}")
        with torch.no_grad():
            like.copy_(t)
        return like
    return type(like)(arr.item()) if isinstance(like, (int, float, bool)) else arr


def _rebuild(like: Any, stored) -> Any:
    """``like`` with its leaves taken in order from the iterator ``stored``
    of (array, dtype name); modules and tensors are filled in place and
    returned as themselves."""
    if like is None:
        return None
    if isinstance(like, nn.Module):
        for _, t in _children(like):
            _rebuild(t, stored)
        return like
    if isinstance(like, dict):
        return {k: _rebuild(v, stored) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        vals = [_rebuild(v, stored) for v in like]
        return type(like)(*vals) if hasattr(like, "_fields") else type(like)(vals)
    return _load_leaf(*next(stored), like)


def restore(directory: str | Path, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``: its tensors (a module's too)
    are overwritten in place with the stored values, each in its own dtype
    and on its own device; numbers are replaced. Returns the tree."""
    directory = Path(directory) / f"step_{step}"
    manifest = json.loads((directory / "manifest.json").read_text())
    n = len(_paths(like))
    if n != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, the tree {n}")
    with np.load(directory / "leaves.npz") as data:
        stored = [(data[m["key"]], m["dtype"]) for m in manifest["leaves"]]
    return _rebuild(like, iter(stored))


class AsyncCheckpointer:
    """Overlap checkpoint IO with training. One in-flight save at a time
    (back-pressure if the previous save has not finished)."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.saved_steps: list[int] = []

    def save(self, step: int, tree: Any) -> None:
        """Copy every leaf to the host now, before returning (training
        updates parameters and moments in place, so a later copy would hold
        a later step), and write them on a thread."""
        self.wait()
        keyed, treedef = _flatten(tree)

        def _run():
            _write(self.directory, step, keyed, treedef, self.keep)
            self.saved_steps.append(step)

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
