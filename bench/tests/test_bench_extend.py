"""A new configuration, a new op and their cells join a copy of the benchmark
by new files and new entries in ``BENCHMARK.json`` alone. The copy's own CPU
checks, run from its root so that the harness reads the copy, take the new
cells: the spec checks, the import guards, the tiny runs, the control and the
planted faults. No file the copy held before changes but ``BENCHMARK.json``,
by the new entries; and the guards catch a new reference that loads the
program."""
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

from bench import harness
from bench.tests import tiny

BASE = "spmv-lap2d-4096"
NEW = "spmv-lap2d-64"  # a second configuration of an op that is there
OP = "spmvcopy"  # a new op: SpMV's files under another name
NEW_OP = f"{OP}-lap2d-64"
CELLS = (f"{NEW}.seq", f"{NEW_OP}.seq")
CHECKS = ("sound_runs_are_correct", "open_loop_through_the_service", "control_fails_the_check",
          "broken_timed_path_is_not_correct")


def _hashes(root):
    files = [root / "BENCHMARK.json", *(root / "bench").rglob("*")]
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in files if p.is_file() and "__pycache__" not in p.parts}


def _copy(root):
    """The benchmark as a checkout holds it, beside the program's sources."""
    shutil.copytree(harness.BENCH, root / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "src").symlink_to(harness.ROOT / "src", target_is_directory=True)


def _write(root, rel, text):
    path = root / rel
    assert not path.exists(), rel  # every file added is new
    path.write_text(text)


def _add_configuration(root, spec, name, op, why):
    """A 64x64 Laplacian of ``op``: its configuration file, its tiny sizes,
    its entry and its cell's, and the cell in the lists of the metrics that
    the first SpMV cell reports (the new op's own roofline aside)."""
    n = 64
    config = json.loads((root / f"bench/configs/{BASE}.json").read_text())
    config.update(op=op, grid=n, rows=n * n, nnz=5 * n * n - 4 * n, reduced=["grid", "rows", "nnz"])
    _write(root, f"bench/configs/{name}.json", json.dumps(config, indent=2))
    _write(root, f"bench/tests/tiny/{name}.json", json.dumps({"grid": 8}))
    spec["configs"].append({"name": name, "source": config["source"], "file": f"bench/configs/{name}.json",
                            "reduced": config["reduced"], "why": why})
    spec["workloads"].append({"name": f"{name}.seq", "config": name, "traffic": "seq", "chips": 1,
                              "why": f"one closed-loop caller of engine.run at 4,096 rows ({op})"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if f"{BASE}.seq" in m.get("workloads", []) and not (op != "spmv" and m["name"] == "spmv_roofline"):
            m["workloads"].append(f"{name}.seq")


def _add_op(root, spec):
    """SpMV's cell, reference, faults and roofline reader under a new op name."""
    bench = root / "bench"
    cell = (bench / "ops/spmv.py").read_text()
    assert "from bench.reference import spmv as ref" in cell
    _write(root, f"bench/ops/{OP}.py", cell.replace("from bench.reference import spmv as ref",
                                                   f"from bench.reference import {OP} as ref"))
    _write(root, f"bench/reference/{OP}.py", (bench / "reference/spmv.py").read_text())
    _write(root, f"bench/tests/faults/{OP}.py", (bench / "tests/faults/spmv.py").read_text())
    reader = (bench / "metrics/spmv_roofline.py").read_text()
    _write(root, f"bench/metrics/{OP}_roofline.py", reader.replace('"spmv"', f'"{OP}"'))
    entry = dict(next(m for m in spec["per_layer"] if m["name"] == "spmv_roofline"))
    spec["per_layer"].append(dict(entry, name=f"{OP}_roofline", workloads=[f"{NEW_OP}.seq"]))


def _without_new_entries(spec):
    spec["configs"] = [c for c in spec["configs"] if c["name"] not in (NEW, NEW_OP)]
    spec["workloads"] = [w for w in spec["workloads"] if w["name"] not in CELLS]
    spec["per_layer"] = [m for m in spec["per_layer"] if m["name"] != f"{OP}_roofline"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w not in CELLS]
    return spec


def _pytest(root, *args):
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider", *args],
                         cwd=root, env=env, capture_output=True, text=True, timeout=900)
    return out.returncode, out.stdout + out.stderr


def _passed(log):
    return set(re.findall(r"^(\S+::\S+) PASSED", log, re.M))


def test_a_new_configuration_and_op_join_by_new_files_alone(tmp_path):
    _copy(tmp_path)
    before = _hashes(tmp_path)
    original = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    _add_configuration(tmp_path, spec, NEW, "spmv", "the paper's Laplacian at 4,096 rows")
    _add_op(tmp_path, spec)
    _add_configuration(tmp_path, spec, NEW_OP, OP, "the paper's Laplacian at 4,096 rows, as a new op")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))

    rc, log = _pytest(tmp_path, "bench/tests/test_bench_spec.py", "bench/tests/test_bench_guards.py")
    assert rc == 0, log[-6000:]
    passed = _passed(log)
    for test in ("test_every_op_has_its_cell_reference_and_faults", "test_each_ops_faults_cover_every_fault",
                 "test_harness_and_references_load_no_jax", "test_references_load_nothing_of_the_program"):
        assert any(test in t and f"[{OP}]" in t for t in passed), (test, sorted(passed))

    rc, log = _pytest(tmp_path, "bench/tests/test_bench_check.py", "-k", f"{NEW} or {OP}")
    assert rc == 0, log[-6000:]
    passed = _passed(log)
    for name in (NEW, NEW_OP):
        for test in CHECKS:
            assert any(test in t and name in t for t in passed), (test, name, sorted(passed))
        assert sum("broken_timed_path" in t and name in t for t in passed) == 2 * len(tiny.FAULTS)

    after = _hashes(tmp_path)
    assert {p for p in before if after.get(p) != before[p]} == {"BENCHMARK.json"}
    assert _without_new_entries(json.loads((tmp_path / "BENCHMARK.json").read_text())) == original

    # a new op's reference that loads the program is caught by the guard
    with open(tmp_path / f"bench/reference/{OP}.py", "a") as f:
        f.write("\nimport repro_torch  # noqa: E402,F401\n")
    rc, log = _pytest(tmp_path, "bench/tests/test_bench_guards.py", "-k", "references_load_nothing")
    assert rc != 0 and re.search(rf"test_references_load_nothing_of_the_program\[{OP}\] FAILED", log), log[-6000:]
