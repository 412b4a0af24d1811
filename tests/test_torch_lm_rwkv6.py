"""The port's RWKV-6 (``repro_torch.models.rwkv6``, the ``ssm`` family)
against the JAX package's on the reduced config of rwkv6-3b (2 layers, d
128, chunks of 16), in float32 and bf16, with the JAX package's weights
carried across by ``convert.lm_params_from_numpy``: parameters, forward,
prefill and its state, decode (the exact one-token recurrence) from the
port's state and from the reference's, loss and grads, serving."""
import numpy as np
import pytest
import torch

import repro_torch.configs as TC
import repro_torch.models.rwkv6 as TR
from repro_torch.models import api
from torch_lm_families import (
    check_chunked_vs_stepwise, check_cli, check_forward, check_loss_and_grads,
    check_param_layout, check_prefill_decode, check_serve,
)

ARCH = "rwkv6-3b"
DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_param_layout_matches_reference_tree(dtype):
    check_param_layout(ARCH, dtype)


def test_float32_leaves_stay_float32_in_bf16():
    model = api.init_params(TC.reduced_config(ARCH, "bfloat16"), device="cpu")
    blk = model.blocks[0]
    assert {blk.w_decay.dtype, blk.w_lora_b.dtype, blk.u_bonus.dtype} == {torch.float32}
    assert blk.w_lora_a.dtype == blk.w_r.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_logits_match(dtype):
    check_forward(ARCH, dtype)


# S = 20 (a chunk of 16 and a padded one), S = 16 (one whole chunk), S = 1
@pytest.mark.parametrize("s", [20, 16, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_state_and_decode_match(dtype, s):
    check_prefill_decode(ARCH, "reference", dtype, s=s)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match(remat):
    check_loss_and_grads(ARCH, remat)


@pytest.mark.parametrize("s", [37, 21, 5])
def test_chunked_prefill_equals_stepwise_decode(s):
    check_chunked_vs_stepwise(ARCH, s)


def test_lm_serve_matches_reference_loop():
    check_serve(ARCH, "reference")


def test_serve_cli(capsys):
    check_cli(ARCH, capsys)


def test_init_state_and_shift():
    cfg = TC.reduced_config(ARCH)
    st = api.init_decode_state(cfg, 3, 99, device="cpu")
    assert isinstance(st, TR.RWKVState)
    assert st.s.shape == (2, 3, 2, 64, 64) and st.tm_x.shape == st.cm_x.shape == (2, 3, 128)
    assert not st.s.any() and st.s.dtype == torch.float32
    x = torch.arange(12.0).reshape(1, 4, 3)
    np.testing.assert_array_equal(TR._shift(x, None)[0, 0].numpy(), 0.0)
    np.testing.assert_array_equal(TR._shift(x, torch.full((1, 3), 7.0))[0, 0].numpy(), 7.0)
    assert torch.equal(TR._shift(x, None)[:, 1:], x[:, :-1])
