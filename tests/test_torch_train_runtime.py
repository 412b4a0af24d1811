"""The port's training runtime on the CPU: the checkpoint store
(``repro_torch.checkpoint``: round trip, bf16 bit for bit, keep-k,
atomicity, ``AsyncCheckpointer`` copying at the call), the supervisor
(``repro_torch.runtime``: recovery to the unfailed run's losses, the
straggler report and the process supervisor against the JAX package's) and
the training CLI (``python -m repro_torch.launch.train``)."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.runtime.supervisor as JS
import repro_torch.checkpoint.store as store
from repro_torch.configs import reduced_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import Ctx, api
from repro_torch.optim import AdamWConfig, AdamWState
from repro_torch.runtime import (
    Failure, ProcessSupervisor, SupervisorConfig, run_supervised, straggler_report,
)

ROOT = Path(__file__).resolve().parents[1]


def _model_and_state(dtype="float32", seed=0):
    cfg = reduced_config("llama3.2-3b", dtype)
    model = api.init_params(cfg, seed=seed, device="cpu")
    state = api.init_opt(cfg, model, AdamWConfig(compress_grads=True))
    gen = torch.Generator().manual_seed(seed)
    for part in (state.mu, state.nu, state.ef_residual):
        for t in part.values():
            t.normal_(generator=gen)
    return cfg, model, state._replace(step=7)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _same(a, b) -> bool:
    """Equal dtypes and bit patterns (so -0.0 is not 0.0)."""
    return all(x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_keeps_every_value_bit_for_bit(tmp_path, dtype):
    cfg, model, state = _model_and_state(dtype)
    with torch.no_grad():
        model.blocks[0].attn.wq[0, :4] = torch.tensor([1e-40, -0.0, float("inf"), 3.0e38])
    store.save(tmp_path, 7, (model, state))
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    dtypes = {leaf["dtype"] for leaf in manifest["leaves"]}
    assert dtypes == ({"bfloat16", "float32", "int64"} if dtype == "bfloat16" else {"float32", "int64"})
    assert manifest["treedef"][0] == "0.embed" and len(manifest["treedef"]) == len(manifest["leaves"])

    _, fresh, fresh_state = _model_and_state(dtype, seed=1)
    fresh_state = fresh_state._replace(step=0)
    got_model, got_state = store.restore(tmp_path, 7, (fresh, fresh_state))
    assert got_model is fresh and isinstance(got_state, AdamWState) and got_state.step == 7
    assert _same(model.state_dict().values(), fresh.state_dict().values())
    for part in ("mu", "nu", "ef_residual"):
        assert _same(getattr(state, part).values(), getattr(got_state, part).values())


def test_restore_rejects_another_tree(tmp_path):
    _, model, state = _model_and_state()
    store.save(tmp_path, 1, (model, state))
    with pytest.raises(ValueError, match="leaves"):
        store.restore(tmp_path, 1, (model, state._replace(ef_residual=None)))


def test_keep_k_and_atomic_publish(tmp_path):
    tree = {"w": torch.arange(6.0), "step": 0}
    for step in range(1, 6):
        store.save(tmp_path, step, {**tree, "step": step}, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_4", "step_5"]
    # a crashed save leaves only its .tmp directory: it never shadows a good one
    (tmp_path / "step_9.tmp").mkdir()
    (tmp_path / "step_9.tmp" / "leaves.npz").write_bytes(b"partial")
    # nor does a directory without a manifest
    (tmp_path / "step_8").mkdir()
    assert store.latest_step(tmp_path) == 5
    got = store.restore(tmp_path, 5, {"w": torch.zeros(6), "step": 0})
    assert got["step"] == 5 and torch.equal(got["w"], torch.arange(6.0))
    # a later save of the same step replaces its leftover .tmp
    store.save(tmp_path, 9, tree, keep=0)
    assert store.latest_step(tmp_path) == 9 and not (tmp_path / "step_9.tmp").exists()
    assert store.latest_step(tmp_path / "missing") is None


def test_async_checkpointer_copies_at_the_call(tmp_path):
    """Training updates weights and moments in place right after the save;
    the checkpoint holds the values of the moment of the call."""
    _, model, state = _model_and_state("bfloat16")
    before = {n: t.clone() for n, t in model.state_dict().items()}
    mu_before = {n: t.clone() for n, t in state.mu.items()}
    ckpt = store.AsyncCheckpointer(tmp_path, keep=3)
    ckpt.save(3, (model, state))
    with torch.no_grad():
        for t in [*model.parameters(), *state.mu.values()]:
            t.add_(1.0)
    ckpt.wait()
    assert ckpt.saved_steps == [3]
    _, fresh, fresh_state = _model_and_state("bfloat16", seed=2)
    store.restore(tmp_path, 3, (fresh, fresh_state))
    assert _same(before.values(), fresh.state_dict().values())
    assert _same(mu_before.values(), fresh_state.mu.values())


def _supervised(tmp_path, name, fail_at=None):
    cfg = reduced_config("llama3.2-3b")
    ctx = Ctx(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, total_steps=14, warmup_steps=2)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=2))

    def build():
        params = api.init_params(cfg, seed=0, device="cpu")
        return params, api.init_opt(cfg, params, opt_cfg), (
            lambda p, o, b: api.train_step(ctx, p, o, b, opt_cfg))

    sup = SupervisorConfig(ckpt_dir=str(tmp_path / name), ckpt_every=5, total_steps=14)
    return run_supervised(sup, build=build, data_for_step=lambda s: data.torch_batch(s, "cpu"),
                          fail_at=fail_at)


def test_training_with_failure_recovers_and_matches(tmp_path):
    """The restarted run lands where the unfailed run lands (deterministic
    pipeline + checkpoint replay), as the JAX package's test_e2e holds."""
    res_a = _supervised(tmp_path, "a")
    res_b = _supervised(tmp_path, "b", fail_at=8)
    assert res_a.restarts == 0 and res_b.restarts == 1
    assert res_a.final_step == res_b.final_step == 13
    # steps 0..7, the failure at 8, then 6..13 after the step-5 checkpoint
    assert len(res_b.losses) == 8 + 8
    np.testing.assert_allclose(res_a.losses[-3:], res_b.losses[-3:], rtol=1e-4)
    assert store.latest_step(tmp_path / "b") == 13


def test_failure_past_max_restarts_raises(tmp_path):
    def build():
        return None, None, lambda p, o, b: (p, o, {"loss": torch.tensor(0.0)})

    sup = SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=100, total_steps=4, max_restarts=0)
    with pytest.raises(Failure):
        run_supervised(sup, build=build, data_for_step=lambda s: {}, fail_at=2)


@pytest.mark.parametrize("times", [[], [1.0], [1.0, 1.1, 0.9, 5.0, 1.0], [0.2, 0.2, 0.9, 0.2]])
def test_straggler_report_matches_reference(times):
    assert straggler_report(times) == JS.straggler_report(times)
    assert straggler_report(times, threshold=3.0) == JS.straggler_report(times, threshold=3.0)


def test_process_supervisor_matches_reference():
    class Proc:
        def __init__(self, rc):
            self.returncode = rc

    def drive(sup_cls):
        sup = sup_cls(max_restarts=1)
        alive = {"a": False, "b": True}
        sup.watch("a", Proc(3), alive=lambda h: alive["a"], restart=lambda: Proc(None))
        sup.watch("b", Proc(None), alive=lambda h: alive["b"])
        first = sup.poll()
        alive["b"] = False
        second = sup.poll()
        third = sup.poll()
        return [[(e.name, e.returncode, e.restarted, e.restarts) for e in evs] for evs in (first, second, third)]

    assert drive(ProcessSupervisor) == drive(JS.ProcessSupervisor)


def test_train_cli_reduces_loss(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "30",
         "--batch", "4", "--seq", "128", "--ckpt-dir", str(tmp_path), "--ckpt-every", "10"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    m = re.search(r"done: steps=30 restarts=0 loss ([\d.]+) -> ([\d.]+)", proc.stdout)
    assert m, proc.stdout
    first, last = float(m.group(1)), float(m.group(2))
    assert last < first - 0.3, proc.stdout
    assert store.latest_step(tmp_path) == 29


def test_train_cli_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
