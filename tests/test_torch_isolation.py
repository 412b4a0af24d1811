"""The PyTorch port stands alone: no source file under ``src/repro_torch``
(nor ``chip_smoke.py``) imports JAX or the JAX package, and importing every
module of the port leaves ``jax`` out of ``sys.modules``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)\b(?!_torch))", re.M)


def _sources() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_reference(path):
    text = path.read_text()
    assert not FORBIDDEN.findall(text), f"{path} imports jax or the JAX package"


def test_forbidden_pattern_catches_reference_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "import repro", "from repro.core import bfs", "  from repro import engine"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import bfs", "import torch"):
        assert not FORBIDDEN.search(line), line


def test_importing_every_port_module_leaves_jax_out():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
