"""The port's data pipeline and AdamW (``repro_torch.data``,
``repro_torch.optim``) against the JAX package's on the CPU: the same token
batches bit for bit, the same schedule, and the same update from identical
parameters, moments and gradients (clipping on and off, int8 error-feedback
compression on), carried across by ``convert.opt_state_from_numpy``.

The optimizer is held on identical gradients, not after a full step: Adam's
first update is about sign(g) * lr, so a 1e-7 difference in a gradient near
``eps`` would move a weight by up to ``lr``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.data as JD
import repro.optim.adamw as JA
import repro.models.transformer as JT
import repro_torch.configs as TC
import repro_torch.data as TD
import repro_torch.optim.adamw as TA
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy, opt_state_to_numpy
from repro_torch.models import api

# float32 elementwise arithmetic in the same order; the global norm sums in
# another order, which moves the clip scale (and so every update) by ulps.
# Where b1 * m and (1 - b1) * g nearly cancel, an ulp of g is a large part of
# the moment, so the elementwise tolerance has a floor of UPDATE_RTOL times
# the tensor's largest magnitude
UPDATE_RTOL = 1e-6


def assert_close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=UPDATE_RTOL,
                               atol=UPDATE_RTOL * float(np.abs(want).max()), err_msg=err_msg)


@pytest.mark.parametrize("seed,step,num_hosts", [(0, 0, 1), (0, 7, 2), (3, 123, 4), (11, 5, 1)])
def test_synthetic_tokens_bit_equal(seed, step, num_hosts):
    cfg_kw = dict(vocab_size=512, seq_len=96, global_batch=8, seed=seed, mean_doc_len=40)
    for host in range(num_hosts):
        ref = JD.SyntheticTokens(JD.DataConfig(**cfg_kw), host_id=host, num_hosts=num_hosts)
        port = TD.SyntheticTokens(TD.DataConfig(**cfg_kw), host_id=host, num_hosts=num_hosts)
        got = port.batch(step)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref.batch(step))
        t = port.torch_batch(step, "cpu")["tokens"]
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref.jax_batch(step)["tokens"]))
    np.testing.assert_array_equal(port.global_batch_all_hosts(step), ref.global_batch_all_hosts(step))


def test_synthetic_tokens_hosts_union_to_the_global_batch():
    cfg = TD.DataConfig(vocab_size=512, seq_len=32, global_batch=6)
    parts = [TD.SyntheticTokens(cfg, host_id=h, num_hosts=3).batch(4) for h in range(3)]
    np.testing.assert_array_equal(np.concatenate(parts), TD.SyntheticTokens(cfg).global_batch_all_hosts(4))
    with pytest.raises(ValueError):
        TD.SyntheticTokens(cfg, num_hosts=4)


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (0, 200), (3, 30), (1, 4), (10, 10)])
def test_schedule_matches_reference(warmup, total):
    jcfg = JA.AdamWConfig(lr=3e-3, warmup_steps=warmup, total_steps=total)
    tcfg = TA.AdamWConfig(lr=3e-3, warmup_steps=warmup, total_steps=total)
    for step in sorted({0, 1, 2, warmup, warmup + 1, total // 2, total - 1, total, total + 5}):
        want = float(JA.schedule(jcfg, jnp.int32(step)))
        assert abs(TA.schedule(tcfg, step) - want) <= 1e-7, step


def test_adamw_config_defaults_match_reference():
    assert dataclasses.asdict(TA.AdamWConfig()) == dataclasses.asdict(JA.AdamWConfig())


def _state_inputs(seed: int, compress: bool):
    """Reduced llama params, moments at step 3 and grads (numpy trees of the
    JAX package's layout), with some gradients far past the clip norm."""
    cfg = TC.reduced_config("llama3.2-3b")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        JT.init_params(JC.reduced_config("llama3.2-3b"), jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def like(scale, positive=False):
        return jax.tree.map(
            lambda a: (np.abs(rng.standard_normal(a.shape)) if positive else rng.standard_normal(a.shape))
            .astype(np.float32) * scale, tree)

    state = {"step": np.int32(3), "mu": like(1e-3), "nu": like(1e-6, positive=True),
             "ef_residual": like(1e-5) if compress else None}
    return cfg, tree, state, like(1e-2)


@pytest.mark.parametrize("clip,compress", [(1.0, False), (None, False), (1.0, True), (1e6, False)])
def test_apply_updates_matches_reference(clip, compress):
    cfg, tree, state, grads = _state_inputs(0, compress)
    ocfg = dict(lr=1e-3, clip_norm=clip, warmup_steps=2, total_steps=20, compress_grads=compress)
    jp, js, jm = JA.apply_updates(
        jax.tree.map(jnp.asarray, tree),
        JA.AdamWState(step=jnp.int32(state["step"]), mu=jax.tree.map(jnp.asarray, state["mu"]),
                      nu=jax.tree.map(jnp.asarray, state["nu"]),
                      ef_residual=None if state["ef_residual"] is None
                      else jax.tree.map(jnp.asarray, state["ef_residual"])),
        jax.tree.map(jnp.asarray, grads), JA.AdamWConfig(**ocfg))

    model = api.init_params(cfg, seed=0, device="cpu")
    model.load_state_dict(lm_params_from_numpy(cfg, tree, device="cpu"))
    tstate = opt_state_from_numpy(cfg, state, device="cpu")
    mu_before = dict(tstate.mu)
    tgrads = lm_params_from_numpy(cfg, grads, device="cpu")
    _, ts, tm = TA.apply_updates(model, tstate, tgrads, TA.AdamWConfig(**ocfg))

    assert ts.step == 4 and all(ts.mu[n] is mu_before[n] for n in mu_before)  # in place
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=UPDATE_RTOL)
    assert abs(tm["lr"] - float(jm["lr"])) <= 1e-9
    got = opt_state_to_numpy(ts)
    want = jax.tree.map(np.asarray, js._asdict())
    for part in ("mu", "nu"):
        jax.tree.map(assert_close, got[part], want[part])
    if compress:
        # the residual g_ef - q * scale: jitted, XLA fuses it into one
        # multiply-add, so the two differ by at most an ulp of g_ef
        def residual_close(got_r, want_r, g, r):
            g_ef = np.abs(g + r)
            assert np.all(np.abs(got_r - want_r) <= np.finfo(np.float32).eps * g_ef)

        jax.tree.map(residual_close, got["ef_residual"], want["ef_residual"], grads,
                     state["ef_residual"])
    want_p = jax.tree.map(np.asarray, jp)
    got_p = lm_params_from_numpy(cfg, want_p, device="cpu")
    for name, p in model.named_parameters():
        assert_close(p.detach().numpy(), got_p[name].numpy(), err_msg=name)


def test_int8_codes_and_residuals_equal_reference():
    rng = np.random.default_rng(5)
    for shape, scale in (((64, 33), 1.0), ((7,), 1e-6), ((128,), 0.0)):
        g = (rng.standard_normal(shape) * scale).astype(np.float32)
        r = (rng.standard_normal(shape) * scale * 1e-2).astype(np.float32)
        jq, js = JA._quantize_int8(jnp.asarray(g + r))
        tq, ts = TA._quantize_int8(torch.as_tensor(g + r))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert tq.dtype == torch.int8 and float(ts) == float(js)
        jd, jr = JA.compress_decompress(jnp.asarray(g), jnp.asarray(r))
        td, tr = TA.compress_decompress(torch.as_tensor(g), torch.as_tensor(r))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    arrays = {f"a{i}": rng.standard_normal(s).astype(np.float32) for i, s in enumerate([(3, 4), (17,), (2, 2, 5)])}
    want = float(JA.global_norm(jax.tree.map(jnp.asarray, arrays)))
    got = TA.global_norm({n: torch.as_tensor(a) for n, a in arrays.items()})
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    bf16 = TA.global_norm([torch.as_tensor(arrays["a0"]).bfloat16()])
    assert bf16.dtype == torch.float32


def test_adamw_converges_quadratic():
    cfg = TA.AdamWConfig(lr=0.1, weight_decay=0.0, total_steps=200, warmup_steps=0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = TA.init(params, cfg)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}  # d/dw of w^2
        params, state, _ = TA.apply_updates(params, state, grads, cfg)
    assert float(params["w"].abs().max()) < 0.1
    assert state.step == 200


def test_bf16_params_update_in_float32_and_round_back():
    """A bf16 weight's update is computed in float32 from the float32
    moments and rounded once, as the JAX package's ``upd`` does."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal(64).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    cfg = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    jp, js, _ = JA.apply_updates({"w": jnp.asarray(w, jnp.bfloat16)},
                                 JA.init({"w": jnp.asarray(w, jnp.bfloat16)}, JA.AdamWConfig(**cfg)),
                                 {"w": jnp.asarray(g, jnp.bfloat16)}, JA.AdamWConfig(**cfg))
    params = {"w": torch.as_tensor(w).bfloat16()}
    state = TA.init(params, TA.AdamWConfig(**cfg))
    assert state.mu["w"].dtype == torch.float32
    TA.apply_updates(params, state, {"w": torch.as_tensor(g).bfloat16()}, TA.AdamWConfig(**cfg))
    assert params["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["w"].float().numpy(), np.asarray(jp["w"], np.float32))
    assert_close(state.nu["w"].numpy(), js.nu["w"])
