"""Tiny copies of the benchmark's configurations and mixes for the CPU, and
the faults planted under a cell's timed path.

Like the harness's own files, each is found by name under ``harness.BENCH``:
a configuration's tiny sizes in ``tests/tiny/<config>.json``, an op's faults
in ``tests/faults/<op>.py``, whose ``broken(fault)`` gives the
``repro_torch.engine.substrate`` attribute to replace and its replacement
for every name in ``FAULTS``.
"""
import importlib.util
import json
import time
from pathlib import Path

import torch

from bench import harness

OPEN = {"loop": "open", "path": "service", "workers": 2, "lanes": 4, "rate_per_s": 200}
# A cell on one chip has no exchange between chips to leave out.
FAULTS = ["state_unchanged", "half_left_out", "answer_altered"]


def _named_file(kind: str, name: str, suffix: str, what: str) -> Path:
    path = harness.BENCH / "tests" / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{what} {name!r} has no {kind} file: add {path.relative_to(harness.ROOT)}")
    return path


def spec_ops() -> "list[str]":
    """The ops that the configurations of ``BENCHMARK.json`` run."""
    spec = harness.load_spec()
    return sorted({json.loads((harness.ROOT / c["file"]).read_text())["op"] for c in spec["configs"]})


def tiny_sizes(config_name: str) -> dict:
    """The keys a configuration's tiny copy changes."""
    return json.loads(_named_file("tiny", config_name, ".json", "configuration").read_text())


def broken(op: str, fault: str):
    """(substrate attribute, replacement) that plants ``fault`` under ``op``."""
    path = _named_file("faults", op, ".py", "op")
    spec = importlib.util.spec_from_file_location(f"bench_faults_{op}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.broken(fault)


def cell_inputs(workload: str):
    spec = harness.load_spec()
    entry, _, config, mix = harness.find_cell(spec, workload)
    config = dict(config, **tiny_sizes(entry["config"]))
    return config, mix


def run_tiny(workload: str, seed: int = 2**31 + 11, seconds: float = 0.3, mix=None):
    """One run of a cell at tiny size on the CPU: (run, numbers, correct)."""
    config, cell_mix = cell_inputs(workload)
    run, numbers, _, _ = harness.run_cell(config, mix or cell_mix, seed, seconds, False,
                                          torch.device("cpu"), time.perf_counter())
    return run, numbers, harness.limits_met(numbers, config["limits"])
