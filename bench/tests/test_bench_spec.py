"""BENCHMARK.json against the contract's shape, and every file it names found
by name: each configuration, mix, op, reference and metric reader, and the
CPU checks' tiny sizes of each configuration and faults of each op."""
import json
import re

import pytest

from bench import harness
from bench.tests.tiny import FAULTS, broken, spec_ops, tiny_sizes

SPEC = harness.load_spec()
OPS = spec_ops()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"] and SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_hold_just_their_keys_and_valid_names(group):
    for e in SPEC[group]:
        extra = set(e) - KEYS[group]
        assert extra <= ({"workloads"} if group in ("end_to_end", "per_layer") else set()), e
        assert KEYS[group] <= set(e), e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in cells:
        names = {m["name"] for m in harness.metrics_of(SPEC, c, False)}
        assert "setup_s" in names and len(names) >= 2
        layer = harness.metrics_of(SPEC, c, True)
        assert layer
        for m in layer:  # the metric it moves is reported there
            assert m["moves"] in {x["name"] for x in harness.metrics_of(SPEC, c, False)}


def test_each_cell_finds_its_config_mix_op_and_reference():
    for w in SPEC["workloads"]:
        cell, entry, config, mix = harness.find_cell(SPEC, w["name"])
        assert cell["chips"] == 1 and entry["name"] == w["config"]
        assert mix["loop"] in ("closed", "open") and mix["path"] in ("engine", "service")
        assert harness.op_cell_class(config["op"]) is not None
        __import__(f"bench.reference.{config['op']}")
        assert set(config["limits"]) >= {"failed_requests"}
        assert entry["source"] == config["source"] and entry["reduced"] == config["reduced"]


def test_each_metric_has_a_reader():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_file_is_small_and_configs_are_each_their_own():
    assert len(json.dumps(SPEC)) < 64 * 1024
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files) and all(f.startswith("bench/") for f in files)


def test_every_configuration_has_its_tiny_file():
    for c in SPEC["configs"]:
        assert isinstance(tiny_sizes(c["name"]), dict)
    with pytest.raises(FileNotFoundError, match="add bench/tests/tiny/no-such-config.json"):
        tiny_sizes("no-such-config")


@pytest.mark.parametrize("op", OPS)
def test_every_op_has_its_cell_reference_and_faults(op):
    for part in (f"ops/{op}.py", f"reference/{op}.py", f"tests/faults/{op}.py"):
        assert (harness.BENCH / part).is_file(), f"op {op!r} needs bench/{part}"


@pytest.mark.parametrize("op", OPS)
def test_each_ops_faults_cover_every_fault(op):
    import repro_torch.engine.substrate as substrate

    for fault in FAULTS:
        name, replacement = broken(op, fault)
        assert callable(getattr(substrate, name)) and callable(replacement), (op, fault)
