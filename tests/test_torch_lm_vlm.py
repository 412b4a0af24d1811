"""The port's VLM family (phi-3-vision-4.2b: the dense decoder with stub
patch embeddings prepended to the tokens) against the JAX package's on its
reduced config (2 layers, 8 patches), in float32 and bf16, under both
attention backends: parameters, forward, prefill (caches sized for the
patches too) and decode from the port's caches and the reference's, the
loss over the token positions only and its grads, serving."""
import numpy as np
import pytest
import torch

import repro_torch.configs as TC
import repro_torch.models.transformer as TT
from repro_torch.models import Ctx, api
from repro_torch.launch.serve import stub_inputs
from torch_lm_families import (
    check_cli, check_forward, check_loss_and_grads, check_param_layout, check_prefill_decode,
    check_serve, check_train_cli, tokens,
)

ARCH = "phi-3-vision-4.2b"
DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_param_layout_matches_reference_tree(dtype):
    check_param_layout(ARCH, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_logits_match(dtype):
    check_forward(ARCH, dtype)


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_caches_and_decode_match(dtype, impl):
    check_prefill_decode(ARCH, impl, dtype)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match(remat):
    check_loss_and_grads(ARCH, remat)


def test_loss_skips_the_patch_positions():
    cfg = TC.reduced_config(ARCH)
    model = api.init_params(cfg, device="cpu")
    tok = torch.as_tensor(tokens(cfg, 2, 13, 3)).long()
    patches = torch.as_tensor(stub_inputs(cfg, 2, 4)["patches"])
    with torch.no_grad():
        logits = TT.forward(Ctx(cfg), model, tok[:, :-1], patches)
        loss = api.loss_fn(Ctx(cfg), model, {"tokens": tok, "patches": patches})
    assert logits.shape == (2, cfg.num_patches + 12, cfg.vocab_size)
    want = torch.nn.functional.cross_entropy(logits[:, cfg.num_patches:].reshape(-1, cfg.vocab_size),
                                             tok[:, 1:].reshape(-1))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)


def test_lm_serve_matches_reference_loop():
    check_serve(ARCH, "flash")


def test_serve_cli(capsys):
    check_cli(ARCH, capsys)


def test_train_cli(tmp_path, capsys, monkeypatch):
    check_train_cli(ARCH, tmp_path, capsys, monkeypatch)
