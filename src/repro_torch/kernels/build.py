"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface and loaded with :mod:`ctypes`. No
PyTorch header is included, so a build takes seconds. Libraries land in
``build/`` at the root of the checkout, named by a hash of the source and the
flags, so an edited source is never served by a stale library. A library is
built at its first use; :func:`build` compiles several at once, one ``nvcc``
process per source, all started together.

Every entry point returns the ``cudaError_t`` of its launch; :func:`check`
turns a nonzero one into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("spmv_ell", "bfs_expand", "topk_sim")
# -fmad=false: no multiply-add contraction, so the kernels round like the
# plain versions and a tie in topk_sim's scores cannot move (see topk_sim.cu)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: "tuple[str, ...]" = SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing, all at once.
    Returns ``name -> compiler output`` (registers and shared memory per
    kernel, from ``-Xptxas -v``) for the sources it compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    procs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            compiler = compiler or nvcc()
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs[name] = (proc, tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            logs[name], _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name}.cu (exit {proc.returncode}):\n{logs[name]}")
            else:
                os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return logs
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a nonzero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({lib.error_string(err).decode()})")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
