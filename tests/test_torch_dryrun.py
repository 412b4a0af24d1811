"""The port's dry-run (``launch/dryrun.py``, ``launch/report.py``) at full
width on the production ``(16, 16)`` mesh: every arch's decode_32k cell
(the MoE ones reached the kept-slot tally's host read on the meta device
before it moved into the mesh), whisper-small's train and prefill over its
1500 frames (which do not divide ``model`` = 16: the encoder pads them), a
short MoE prefill; the result's keys (the reference's, with one
``seconds_trace``), the CLI, the cells ``applicable`` skips, and the report
tables. Rank 0 of each cell is traced on the meta device: no memory is
drawn."""
import json
import sys

import pytest

from repro_torch.configs import ARCHS, ShapeSpec, get_config
from repro_torch.launch import dryrun, report
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_programs

KEYS = {"arch", "shape", "mesh", "status", "n_chips", "seconds_trace", "memory", "roofline",
        "model_flops_global", "model_flops_per_dev", "useful_flops_ratio", "collective_calls",
        "flops_by_dtype"}
MEMORY_KEYS = {"argument_bytes_per_dev", "output_bytes_per_dev", "temp_bytes_per_dev",
               "alias_bytes_per_dev", "peak_bytes_per_dev"}
ROOFLINE_KEYS = {"flops", "bytes_hbm", "bytes_collective", "t_compute", "t_memory",
                 "t_collective", "dominant", "collectives", "collective_counts"}


def _check(result: dict) -> None:
    assert set(result) == KEYS
    assert result["status"] == "ok" and result["n_chips"] == 256
    assert set(result["memory"]) == MEMORY_KEYS and set(result["roofline"]) == ROOFLINE_KEYS
    mem = result["memory"]
    assert mem["peak_bytes_per_dev"] == (mem["argument_bytes_per_dev"] + mem["output_bytes_per_dev"]
                                         + mem["temp_bytes_per_dev"] - mem["alias_bytes_per_dev"])
    assert mem["argument_bytes_per_dev"] > 0 and result["roofline"]["flops"] > 0
    assert result["collective_calls"]["data"] > 0 and result["collective_calls"]["model"] > 0
    assert result["useful_flops_ratio"] > 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_cell_at_full_width(arch):
    _check(dryrun.run_cell(arch, "decode_32k", "single"))


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_whisper_over_its_1500_frames_on_16_by_16(kind):
    """The encoder's frames pad to 1504 over ``model``; the cell is cut to
    448 decoder positions and 2 rows a rank (the sweep runs train_4k)."""
    shape = ShapeSpec("w", kind, 448, 32)
    cfg = get_config("whisper-small")
    assert cfg.encoder_frames % 16
    cell = dryrun.trace_programs(build_programs(cfg, make_production_mesh(), shape), shape)
    assert cell["collective_calls"]["model"] > 0 and cell["roofline"]["flops"] > 0
    assert cell["memory"]["peak_bytes_per_dev"] > cell["memory"]["argument_bytes_per_dev"]


def test_moe_prefill_at_a_short_sequence():
    shape = ShapeSpec("m", "prefill", 1024, 32)
    cell = dryrun.trace_programs(
        build_programs(get_config("moonshot-v1-16b-a3b"), make_production_mesh(), shape), shape)
    assert cell["collective_calls"]["data"] > 0


def test_applicable_skips_the_reference_cells():
    out = dryrun.run_cell("llama3.2-3b", "long_500k", "single")
    assert out["status"] == "skipped" and out["reason"]


def test_cli_writes_the_result_and_the_report_reads_it(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    monkeypatch.setattr(report, "OUT_DIR", tmp_path)
    for arch, shape in (("qwen2-7b", "decode_32k"), ("moonshot-v1-16b-a3b", "decode_32k"),
                        ("llama3.2-3b", "long_500k")):
        monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", arch, "--shape", shape])
        dryrun.main()
    result = json.loads((tmp_path / "qwen2-7b__decode_32k__single.json").read_text())
    _check(result)
    assert "dominant=" in capsys.readouterr().out
    table = report.roofline_table("single")
    assert "| qwen2-7b | decode_32k |" in table and "*skipped*" in table
    assert "| moonshot-v1-16b-a3b | decode_32k | ok |" in report.dryrun_table("single")
    cells = report.cell_table()
    assert cells.startswith("| arch | decode_32k | long_500k |")
    assert "| llama3.2-3b | — / — | skipped / — |" in cells and "| qwen2-7b | mem " in cells
    picks = report.pick_hillclimb_cells()
    assert {r["arch"] for r in picks} <= {"qwen2-7b", "moonshot-v1-16b-a3b"}
