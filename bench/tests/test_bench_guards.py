"""The harness refuses to run without a card, and neither it nor the
references load JAX or the JAX package (top-level names compared whole):
checked for every op that a configuration of ``BENCHMARK.json`` runs."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench.tests.tiny import spec_ops

OPS = spec_ops()
ROOT = Path(__file__).resolve().parents[2]
ENV = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def _python(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("op", OPS)
def test_harness_and_references_load_no_jax(op):
    code = (
        "import sys; sys.path[0:0] = ['.', 'src']\n"
        "import bench.run, bench.harness, bench.trace, bench.stats, bench.sweep\n"
        f"import bench.ops.{op}, bench.reference.{op}\n"
        "from bench import harness\n"
        "spec = harness.load_spec()\n"
        "[harness.metric_reader(m['name']) for m in spec['end_to_end'] + spec['per_layer']]\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    top = set(json.loads(_python(code).replace("'", '"')))
    assert not top & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in top  # the port is loaded; it is not `repro`


@pytest.mark.parametrize("op", OPS)
def test_references_load_nothing_of_the_program(op):
    code = (
        "import sys; sys.path[0:0] = ['.']\n"
        f"import bench.reference.{op}\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    top = set(json.loads(_python(code).replace("'", '"')))
    assert not top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_loaded_compares_whole_names(monkeypatch):
    from bench import harness

    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_loaded() == ["jax"]


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "spmv-lap2d-4096.seq",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "needs 1 CUDA card" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
