"""Backend policy shared by every kernel wrapper: the kernel runs on CUDA
tensors, the plain PyTorch version on CPU tensors.

The decision follows the tensors a wrapper is handed, never a flag or a
probe of the machine: a wrapper given CUDA tensors launches its kernel or
raises, and nothing falls back.
"""
from __future__ import annotations

import torch


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device (launch the kernel),
    False when every one lies on the CPU (run the plain version)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel inputs lie on different CUDA devices")
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all be on CUDA or all on the CPU, got {sorted(kinds)}")
