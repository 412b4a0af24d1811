"""Device resolution shared by every constructor and substrate.

The port's entry points run on the card unless the caller asks for the CPU:
``device`` defaults to ``"cuda"`` everywhere, and asking for a CUDA device on
a machine without one raises instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA and
    no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def to_numpy(t: torch.Tensor):
    """Host copy of a tensor for the numpy-side builders and models."""
    return t.detach().cpu().numpy()
