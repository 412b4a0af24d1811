"""Tiny copies of the benchmark's configurations and mixes for the CPU."""
import time

import torch

from bench import harness

TINY = {"spmv-lap2d-4096": {"grid": 16}, "bfs-er-s21": {"scale": 9}}
OPEN = {"loop": "open", "path": "service", "workers": 2, "lanes": 4, "rate_per_s": 200}


def cell_inputs(workload: str):
    spec = harness.load_spec()
    entry, _, config, mix = harness.find_cell(spec, workload)
    config = dict(config, **TINY[entry["config"]])
    return config, mix


def run_tiny(workload: str, seed: int = 2**31 + 11, seconds: float = 0.3, mix=None):
    """One run of a cell at tiny size on the CPU: (run, numbers, correct)."""
    config, cell_mix = cell_inputs(workload)
    run, numbers, _, _ = harness.run_cell(config, mix or cell_mix, seed, seconds, False,
                                          torch.device("cpu"), time.perf_counter())
    return run, numbers, harness.limits_met(numbers, config["limits"])
