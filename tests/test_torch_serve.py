"""The port's ``lm_serve`` on the CPU against the JAX package's LM serving
loop (the LM branch of ``repro.launch.serve.main``: jitted prefill, then
greedy decode), run on the same weights and prompts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import Ctx as JCtx
from repro.models import api as japi
from repro_torch.configs import reduced_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.serve import lm_serve, main
from repro_torch.models import api
from test_torch_lm import jax_params_numpy


def jax_lm_loop(cfg, params, prompts, gen: int) -> np.ndarray:
    """``repro.launch.serve.main``'s LM loop on given params and prompts."""
    ctx = JCtx(cfg=cfg)
    max_len = prompts.shape[1] + gen
    prefill = jax.jit(lambda p, toks: japi.prefill(ctx, p, toks, max_len=max_len, batch={}))
    decode = jax.jit(lambda p, tok, st: japi.decode_step(ctx, p, tok, st))
    logits, state = prefill(params, prompts)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    for _ in range(gen - 1):
        logits, state = decode(params, tok, state)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch,impl", [("llama3.2-3b", "reference"), ("llama3.2-3b", "flash"),
                                       ("qwen2-7b", "reference"), ("glm4-9b", "flash")])
def test_lm_serve_matches_jax_loop(arch, impl):
    jcfg = dataclasses.replace(JC.reduced_config(arch), attn_impl=impl)
    tcfg = dataclasses.replace(reduced_config(arch), attn_impl=impl)
    tree = jax_params_numpy(jcfg, seed=1)
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(1), (3, 24), 1, jcfg.vocab_size))
    want = jax_lm_loop(jcfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(prompts), gen=8)

    model = api.init_params(tcfg, seed=0, device="cpu")
    model.load_state_dict(lm_params_from_numpy(tcfg, tree, device="cpu"))
    res = lm_serve(tcfg, model, prompts, 8, device="cpu")
    assert res.tokens.shape == (3, 8) and res.tokens.dtype == torch.int64
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    assert res.prefill_seconds > 0 and res.decode_seconds > 0


def test_lm_serve_one_token_is_the_prefill_argmax():
    cfg = reduced_config("llama3.2-3b")
    model = api.init_params(cfg, seed=2, device="cpu")
    prompts = np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 10))
    res = lm_serve(cfg, model, prompts, 1, device="cpu")
    logits, _ = api.prefill(api.Ctx(cfg), model, torch.from_numpy(prompts), 11)
    assert torch.equal(res.tokens, logits[:, -1].argmax(-1, keepdim=True))
    with pytest.raises(ValueError, match="gen"):
        lm_serve(cfg, model, prompts, 0, device="cpu")


def test_serve_cli_on_the_cpu(capsys):
    main(["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "arch=llama3.2-3b batch=2 device=cpu" in out
    assert "sample token ids:" in out


def test_serve_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--batch", "1", "--prompt-len", "4", "--gen", "1"])
