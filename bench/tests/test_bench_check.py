"""The check that decides ``correct``: sound runs pass, the control (the
reference in the program's place one precision below, or with one stated
guarantee broken) fails, and so does a run whose timed path is broken
underneath in each way a cell of these ops can be broken. Tiny sizes on the
CPU, through the same harness a run uses, past its look for a card."""
import pytest
import torch

from bench import harness
from bench.tests.tiny import OPEN, cell_inputs, run_tiny

WORKLOADS = [w["name"] for w in harness.load_spec()["workloads"]]
SEEDS = (2**31 + 1, 7, 123456789)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_runs_are_correct(workload):
    for seed in SEEDS[:2]:
        run, numbers, correct = run_tiny(workload, seed)
        assert correct, numbers
        assert numbers["checked_results"] >= 1 and numbers["failed_requests"] == 0


@pytest.mark.parametrize("config_name", ["spmv-lap2d-4096", "bfs-er-s21"])
def test_open_loop_through_the_service_is_correct_and_timed_from_due(config_name):
    run, numbers, correct = run_tiny(f"{config_name}.seq", mix=OPEN)
    assert correct, numbers
    assert run.generator_late_ms is not None and len(run.samples) > 10
    wait = harness.metric_reader("service.wait_ms")(run)
    assert wait is not None and wait >= 0.0
    assert harness.metric_reader("engine.host_ms")(run) is None


@pytest.mark.parametrize("config_name", ["spmv-lap2d-4096", "bfs-er-s21"])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_the_check(config_name, seed):
    workload = f"{config_name}.seq"
    config, _ = cell_inputs(workload)
    cell = harness.op_cell_class(config["op"])(config, seed, torch.device("cpu"))
    numbers = cell.check([(tag, cell.control(tag)) for tag in range(cell.tags)])
    assert any(numbers[k] > config["limits"][k] for k in numbers), numbers


def _broken_spmv(fault):
    from repro_torch.kernels.spmv.ops import spmv as real

    def spmv(cols, vals, x, grain):
        if fault == "state_unchanged":  # hands its input back as the result
            return x[: cols.shape[0]].clone()
        y = real(cols, vals, x, grain=grain)
        if fault == "half_left_out":
            y[y.shape[0] // 2:] = 0
        elif fault == "answer_altered":
            y[y.shape[0] // 3] += 1.0
        return y

    return "spmv_kernel", spmv


def _broken_bfs(fault):
    from repro_torch.core.bfs import UNVISITED, _finalize_parents, bfs_rounds
    from repro_torch.kernels.bfs.kernel import bfs_expand
    from repro_torch.kernels.bfs.ops import bfs_cuda as real

    def bfs_cuda(g, root, strategy=None, max_rounds=None):
        n = g.P * g.v_per_nodelet
        if fault == "state_unchanged":  # the parents as the search starts
            par = torch.full((n,), UNVISITED, dtype=torch.int32)
            par[root] = root
            return _finalize_parents(g, par)
        if fault == "half_left_out":  # half of every frontier never expands
            keep = torch.arange(n) % 2 == 0
            expand = lambda a, f: bfs_expand(a, f & keep)  # noqa: E731
            return _finalize_parents(g, bfs_rounds(g.adj, root, max_rounds or n, expand, n))
        par = real(g, root, strategy, max_rounds)
        v = (root + 1) % g.n_vertices
        par[v] = v  # answer_altered: a vertex made its own parent
        return par

    return "bfs_cuda", bfs_cuda


# A cell on one chip has no exchange between chips to leave out.
FAULTS = ["state_unchanged", "half_left_out", "answer_altered"]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("path", ["cell", "service"])
def test_a_broken_timed_path_is_not_correct(workload, fault, path, monkeypatch):
    import repro_torch.engine.substrate as substrate

    config, _ = cell_inputs(workload)
    name, broken = {"spmv": _broken_spmv, "bfs": _broken_bfs}[config["op"]](fault)
    monkeypatch.setattr(substrate, name, broken)
    _, numbers, correct = run_tiny(workload, mix=OPEN if path == "service" else None)
    assert not correct, numbers


@pytest.mark.gpu
@pytest.mark.parametrize("config_name", ["spmv-lap2d-4096", "bfs-er-s21"])
def test_the_control_fails_at_full_size_on_the_card(config_name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    config, _ = cell_inputs(f"{config_name}.seq")
    import json

    config = json.loads((harness.ROOT / f"bench/configs/{config_name}.json").read_text())
    cell = harness.op_cell_class(config["op"])(config, SEEDS[0], torch.device("cuda", 0))
    numbers = cell.check([(tag, cell.control(tag)) for tag in range(cell.tags)])
    assert any(numbers[k] > config["limits"][k] for k in numbers), numbers
