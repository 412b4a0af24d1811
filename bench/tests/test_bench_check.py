"""The check that decides ``correct``: sound runs pass, the control (the
reference in the program's place one precision below, or with one stated
guarantee broken) fails, and so does a run whose timed path is broken
underneath in each way a cell of these ops can be broken. Tiny sizes on the
CPU, through the same harness a run uses, past its look for a card."""
import json

import pytest
import torch

from bench import harness
from bench.tests.tiny import FAULTS, OPEN, broken, cell_inputs, run_tiny

SPEC = harness.load_spec()
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
CONFIGS = [c["name"] for c in SPEC["configs"]]
SEEDS = (2**31 + 1, 7, 123456789)


def first_cell(config_name: str) -> str:
    """The first workload of ``BENCHMARK.json`` that runs the configuration."""
    return next(w["name"] for w in SPEC["workloads"] if w["config"] == config_name)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_runs_are_correct(workload):
    for seed in SEEDS[:2]:
        run, numbers, correct = run_tiny(workload, seed)
        assert correct, numbers
        assert numbers["checked_results"] >= 1 and numbers["failed_requests"] == 0


@pytest.mark.parametrize("config_name", CONFIGS)
def test_open_loop_through_the_service_is_correct_and_timed_from_due(config_name):
    run, numbers, correct = run_tiny(first_cell(config_name), mix=OPEN)
    assert correct, numbers
    assert run.generator_late_ms is not None and len(run.samples) > 10
    wait = harness.metric_reader("service.wait_ms")(run)
    assert wait is not None and wait >= 0.0
    assert harness.metric_reader("engine.host_ms")(run) is None


@pytest.mark.parametrize("config_name", CONFIGS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_the_check(config_name, seed):
    config, _ = cell_inputs(first_cell(config_name))
    cell = harness.op_cell_class(config["op"])(config, seed, torch.device("cpu"))
    numbers = cell.check([(tag, cell.control(tag)) for tag in range(cell.tags)])
    assert any(numbers[k] > config["limits"][k] for k in numbers), numbers


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("path", ["cell", "service"])
def test_a_broken_timed_path_is_not_correct(workload, fault, path, monkeypatch):
    import repro_torch.engine.substrate as substrate

    config, _ = cell_inputs(workload)
    monkeypatch.setattr(substrate, *broken(config["op"], fault))
    _, numbers, correct = run_tiny(workload, mix=OPEN if path == "service" else None)
    assert not correct, numbers


@pytest.mark.gpu
@pytest.mark.parametrize("config_name", CONFIGS)
def test_the_control_fails_at_full_size_on_the_card(config_name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    entry = next(c for c in SPEC["configs"] if c["name"] == config_name)
    config = json.loads((harness.ROOT / entry["file"]).read_text())
    cell = harness.op_cell_class(config["op"])(config, SEEDS[0], torch.device("cuda", 0))
    numbers = cell.check([(tag, cell.control(tag)) for tag in range(cell.tags)])
    assert any(numbers[k] > config["limits"][k] for k in numbers), numbers
