"""Shared set-up of the LM family tests (``tests/test_torch_lm_*.py``): the
JAX package's reduced configs and weights, carried across to the port by
``convert.lm_params_from_numpy``, and numpy inputs from seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as JC
import repro.models.api as JAPI
import repro_torch.configs as TC
from repro.models.layers import Ctx as JCtx
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.serve import stub_inputs
from repro_torch.models import Ctx, api


def reduced(arch: str, impl: str = "reference", dtype: str = "float32", **upd):
    """(JAX config, port config) of the reduced arch."""
    upd = dict(attn_impl=impl, **upd)
    return (dataclasses.replace(JC.reduced_config(arch, dtype), **upd),
            dataclasses.replace(TC.reduced_config(arch, dtype), **upd))


def jax_tree(jcfg, seed: int = 0) -> dict:
    """The JAX package's ``init_params`` tree as float32 numpy, every leaf
    that init leaves constant (norms at 1, biases at 0, rwkv6's mixes,
    decay and bonus, Mamba-2's ``a_log``, ``d_skip``, ``dt_bias``) moved by
    0.1 N(0, 1) so that the comparison sees it, and each leaf rounded to its
    own type (a bf16 leaf holds bf16 values)."""
    tree = JAPI.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)

    def move(a):
        x = np.asarray(a, np.float32)
        if x.size > 1 and np.all(x == x.flat[0]):
            x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return np.asarray(jnp.asarray(x).astype(a.dtype), np.float32)

    return jax.tree.map(move, tree)


def jax_params(jcfg, tree: dict) -> dict:
    """The numpy tree as the JAX package's arrays, each in its init type."""
    dtypes = jax.tree.map(lambda a: a.dtype, JAPI.init_params(jcfg, jax.random.PRNGKey(0)))
    return jax.tree.map(lambda a, dt: jnp.asarray(a).astype(dt), tree, dtypes)


def both_models(arch: str, impl: str = "reference", dtype: str = "float32", seed: int = 0, **upd):
    """(jax ctx, jax params, port ctx, port model) holding the same weights."""
    jcfg, tcfg = reduced(arch, impl, dtype, **upd)
    tree = jax_tree(jcfg, seed)
    model = api.init_params(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(tcfg, tree, device="cpu"))
    return JCtx(jcfg), jax_params(jcfg, tree), Ctx(tcfg), model


def tokens(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, s)).astype(np.int32)


def as_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def to_np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def param_layout(model) -> dict:
    """{name: (shape, dtype name)} of the port's parameters."""
    return {name: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for name, t in model.state_dict().items()}


def jax_layout(cfg, tree) -> dict:
    """The same, from the JAX package's tree: each stacked subtree's leaf
    split into one entry a layer."""
    stacks = {"blocks": cfg.num_layers, "enc_blocks": cfg.encoder_layers, "dec_blocks": cfg.num_layers}
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] in stacks:
            assert leaf.shape[0] == stacks[keys[0]]
            for i in range(stacks[keys[0]]):
                out[".".join([keys[0], str(i), *keys[1:]])] = (tuple(leaf.shape[1:]), str(leaf.dtype))
        else:
            out[".".join(keys)] = (tuple(leaf.shape), str(leaf.dtype))
    return out


# -- checks shared by the family files -------------------------------------------

# float32: the same sums in another order over 2-4 layers (seen: 2e-6)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16, relative to the reference's largest magnitude: XLA on the CPU
# evaluates a fusion of bf16 elementwise ops in float32 and rounds once,
# PyTorch rounds after each op; one rounding is 2**-8 relative and the
# layers carry it on (seen: up to 2**-5 of the largest state entry)
BF16_RTOL = 2**-4
# grads, each leaf against the reference's largest |grad| of that leaf:
# float32 sums in other orders (seen: 2.3e-6)
GRAD_RTOL = 1e-4


def assert_close(got, want, dtype: str, what: str = "") -> None:
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    if dtype == "float32":
        np.testing.assert_allclose(g, w, **F32_TOL, err_msg=what)
    else:
        err, top = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= BF16_RTOL * top, f"{what}: differs by {err} > {BF16_RTOL} x {top}"


def check_param_layout(arch: str, dtype: str) -> None:
    """Names, shapes and types of the port's parameters equal the JAX
    tree's; ``lm_params_from_numpy`` keeps each leaf's type from float32
    arrays, and ``lm_params_to_numpy`` gives the tree back."""
    from repro_torch.convert import lm_params_to_numpy

    jcfg, tcfg = reduced(arch, dtype=dtype)
    tree = JAPI.init_params(jcfg, jax.random.PRNGKey(0))
    model = api.init_params(tcfg, device="cpu")
    want = jax_layout(jcfg, tree)
    assert param_layout(model) == want
    numpy_tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    sd = lm_params_from_numpy(tcfg, numpy_tree, device="cpu")
    assert {n: str(t.dtype).removeprefix("torch.") for n, t in sd.items()} == {
        n: dt for n, (_, dt) in want.items()}
    model.load_state_dict(sd)
    back = lm_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(numpy_tree)
    for got, leaf in zip(jax.tree.leaves(back), jax.tree.leaves(numpy_tree)):
        np.testing.assert_array_equal(got, leaf)


def check_forward(arch: str, dtype: str, s: int = 20) -> None:
    jctx, jp, tctx, model = both_models(arch, dtype=dtype)
    tok, mod = tokens(tctx.cfg, 2, s, 6), stub_inputs(tctx.cfg, 2, 7)
    # the frames (encdec) or patches (vlm) go in after the tokens
    want = JAPI.module_for(jctx.cfg).forward(jctx, jp, jnp.asarray(tok), *as_jax(mod).values())
    with torch.no_grad():
        got = api.module_for(tctx.cfg).forward(tctx, model, torch.as_tensor(tok), *as_torch(mod).values())
    assert_close(got, want, dtype, "forward logits")


def state_numpy(state) -> dict:
    """A JAX decode state's fields as numpy (bf16 upcast to float32)."""
    return {f: np.asarray(getattr(state, f), np.float32) if f != "length" else int(state.length)
            for f in state._fields}


def check_prefill_decode(arch: str, impl: str, dtype: str, s: int = 20, steps: int = 4) -> None:
    """Prefill logits and every field of the decode state, then ``steps``
    teacher-forced decode steps from the port's own state and from the
    reference's converted by ``decode_state_from_numpy``."""
    from repro_torch.convert import decode_state_from_numpy

    jctx, jp, tctx, model = both_models(arch, impl, dtype)
    cfg = tctx.cfg
    tok, mod = tokens(cfg, 2, s, 1), stub_inputs(cfg, 2, 2)
    max_len = s + steps + (cfg.num_patches or 0)
    wl, ws = JAPI.prefill(jctx, jp, jnp.asarray(tok), max_len, as_jax(mod))
    gl, gs = api.prefill(tctx, model, torch.as_tensor(tok), max_len, as_torch(mod))
    assert_close(gl, wl, dtype, "prefill logits")
    assert type(gs).__name__ == type(ws).__name__ and gs._fields == ws._fields
    for f in ws._fields:
        if f == "length":
            assert gs.length == int(ws.length)
        else:
            assert_close(getattr(gs, f), getattr(ws, f), dtype, f"prefill state {f}")
    cs = decode_state_from_numpy(cfg, state_numpy(ws), device="cpu")
    for i in range(steps):
        t1 = tokens(cfg, 2, 1, 10 + i)
        wl, ws = JAPI.decode_step(jctx, jp, jnp.asarray(t1), ws)
        gl, gs = api.decode_step(tctx, model, torch.as_tensor(t1), gs)
        cl, cs = api.decode_step(tctx, model, torch.as_tensor(t1), cs)
        assert_close(gl, wl, dtype, f"decode step {i}")
        assert_close(cl, wl, dtype, f"decode step {i} from the converted state")
    for f in ws._fields:
        if f == "length":
            assert gs.length == cs.length == int(ws.length)
        else:
            assert_close(getattr(gs, f), getattr(ws, f), dtype, f"state {f} after decode")


def port_grads(ctx, model, batch: dict) -> tuple[float, dict]:
    from repro_torch.convert import lm_params_to_numpy

    named = dict(model.named_parameters())
    loss = api.loss_fn(ctx, model, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), lm_params_to_numpy(dict(zip(named, grads)))


def assert_grads_close(got: dict, want, what: str = "") -> None:
    flat_w = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        g = flat_g[path]
        assert np.isfinite(g).all(), f"{what}{jax.tree_util.keystr(path)}: non-finite grad"
        err, top = float(np.abs(g - w).max()), float(np.abs(w).max())
        assert err <= GRAD_RTOL * top, f"{what}{jax.tree_util.keystr(path)}: {err} > {GRAD_RTOL} x {top}"


def check_loss_and_grads(arch: str, remat: bool, s: int = 25) -> None:
    """``loss_fn`` and its gradients against ``jax.value_and_grad``, float32."""
    jctx, jp, tctx, model = both_models(arch, remat=remat)
    tok, mod = tokens(tctx.cfg, 2, s + 1, 3), stub_inputs(tctx.cfg, 2, 4)
    jl, jg = jax.value_and_grad(
        lambda p: JAPI.loss_fn(jctx, p, {"tokens": jnp.asarray(tok), **as_jax(mod)}))(jp)
    tl, tg = port_grads(tctx, model, {"tokens": torch.as_tensor(tok), **as_torch(mod)})
    np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
    assert_grads_close(tg, jg)


def jax_serve_loop(jctx, jp, prompts: np.ndarray, gen: int, mod: dict) -> np.ndarray:
    """``repro.launch.serve.main``'s LM loop on given params, prompts and
    stub inputs: prefill, then greedy decode."""
    max_len = prompts.shape[1] + gen + (jctx.cfg.num_patches or 0)
    logits, state = JAPI.prefill(jctx, jp, jnp.asarray(prompts), max_len, as_jax(mod))
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    for _ in range(gen - 1):
        logits, state = JAPI.decode_step(jctx, jp, tok, state)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


def check_serve(arch: str, impl: str, gen: int = 6) -> None:
    """``lm_serve``'s greedy tokens equal the reference loop's (float32)."""
    from repro_torch.launch.serve import lm_serve

    jctx, jp, tctx, model = both_models(arch, impl)
    prompts, mod = tokens(tctx.cfg, 3, 12, 5), stub_inputs(tctx.cfg, 3, 8)
    want = jax_serve_loop(jctx, jp, prompts, gen, mod)
    res = lm_serve(tctx.cfg, model, prompts, gen, device="cpu", batch=mod)
    assert res.tokens.shape == (3, gen) and res.tokens.dtype == torch.int64
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    assert res.prefill_seconds > 0 and res.decode_seconds > 0


def check_cli(arch: str, capsys) -> None:
    from repro_torch.launch.serve import main

    main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert f"arch={arch} batch=2 device=cpu" in out and "sample token ids:" in out


def check_chunked_vs_stepwise(arch: str, s: int, impl: str = "reference", steps: int = 4) -> None:
    """The port alone: the last logits of prefill(S) against prefill(S -
    steps) and ``steps`` decode steps fed the prompt's last tokens (the
    chunked scan against the one-token path), float32."""
    _, _, tctx, model = both_models(arch, impl)
    tok = torch.as_tensor(tokens(tctx.cfg, 2, s, 9))
    want, _ = api.prefill(tctx, model, tok, s)
    got, state = api.prefill(tctx, model, tok[:, :s - steps], s)
    for i in range(s - steps, s):
        got, state = api.decode_step(tctx, model, tok[:, i:i + 1], state)
    assert_close(got, want, "float32", f"prefill({s}) vs prefill({s - steps}) + {steps} decode steps")


def check_train_cli(arch: str, tmp_path, capsys, monkeypatch) -> None:
    """``launch/train.py --arch <arch> --device cpu`` trains the reduced
    config, handing each step's batch its stub frames or patches (numpy
    N(0, 1) from the step's seed) beside the tokens."""
    from repro_torch.launch import train

    seen = []
    loss_fn = api.loss_fn

    def recording(ctx, params, batch):
        seen.append({k: tuple(v.shape) for k, v in batch.items()})
        return loss_fn(ctx, params, batch)

    monkeypatch.setattr(api, "loss_fn", recording)
    train.main(["--arch", arch, "--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "100"])
    assert "done: steps=4 restarts=0" in capsys.readouterr().out
    cfg = TC.reduced_config(arch)
    want = {"tokens": (2, 17), **{k: v.shape for k, v in stub_inputs(cfg, 2, 0).items()}}
    assert len(seen) == 4 and all(s == want for s in seen)
