#!/usr/bin/env python3
"""How far one change of summation order moves rwkv6-3b's bf16 logits at
full width and depth, on one CUDA card: the side of the 2 x 2 LM mesh's
check against the unsharded model (``chip_smoke.py``, ``LM_LOGIT_ATOL``)
that each change moves.

    python3 tools/rwkv6_logit_order.py

For weight seeds 0, 1 and 2 (the prompts from numpy seed 1 for seed 0, as
``chip_smoke.py`` draws them, else 100 + seed), serves LM_BATCH rows of a
2048-token prompt and 2 greedy decode steps with the unsharded model, then
again with one change each, fed the same tokens:

- ``bonus_product``: the WKV chunk's bonus (r * u) . k as a batched
  (1 x 64) by (64 x 1) product in place of the elementwise product and sum;
- ``lora_row_split``: the decay LoRA's down-projection over a sequence in 2
  row blocks, as the mesh's 2 ``model`` ranks run it, then the
  up-projection on every row;
- ``both``; and ``again``, no change (0 if the card repeats itself).

Prints the card's name and power limit, whether ``torch.linalg.vecdot``
equals the elementwise product and sum bit for bit on the card, then a line
a seed: the largest |logit| and max |variant - unsharded| at prefill and
each decode step.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import api, rwkv6  # noqa: E402
from repro_torch.models.layers import Ctx  # noqa: E402

CHUNK, LORA = rwkv6._chunk, rwkv6._lora


def chunk_bonus_product(state, rr, kk, vv, ll, u, strict):
    """``rwkv6._chunk`` with the bonus as a batched product."""
    L_inc = torch.cumsum(ll, dim=1)
    L_exc = L_inc - ll
    q_dec = (rr * L_exc.exp()).permute(0, 2, 1, 3)
    k_dec = (kk * (-L_inc).exp()).permute(0, 2, 3, 1)
    vh = vv.permute(0, 2, 1, 3)
    A = torch.matmul(q_dec, k_dec).masked_fill(~strict, 0.0)
    diag = torch.matmul((rr * u)[..., None, :], kk[..., None])[..., 0, 0].permute(0, 2, 1)
    o = torch.matmul(A, vh) + diag[..., None] * vh + torch.matmul(q_dec, state)
    last = L_inc[:, -1]
    k_tail = (kk * (last[:, None] - L_inc).exp()).permute(0, 2, 3, 1)
    state = state * last.exp()[..., None] + torch.matmul(k_tail, vh)
    return o.permute(0, 2, 1, 3), state


def lora_two_row_blocks(ctx, p, wx):
    """``rwkv6._lora`` with a sequence's down-projection in 2 row blocks."""
    if wx.dim() == 2:
        return LORA(ctx, p, wx)
    a = p.w_lora_a.float()
    rows = wx.reshape(-1, wx.shape[-1])
    down = torch.cat([blk.float() @ a for blk in rows.split(-(-rows.shape[0] // 2))])
    return (down @ p.w_lora_b).reshape(*wx.shape[:-1], -1)


def serve(model, cfg, prompts, tokens=None):
    """Prefill logits and 2 decode steps' (float32), and the tokens fed."""
    ctx = Ctx(cfg)
    logits, state = api.prefill(ctx, model, prompts, prompts.shape[1] + 2)
    out, toks = [logits.float()], tokens or [logits.argmax(-1)]
    for i in range(2):
        logits, state = api.decode_step(ctx, model, toks[i], state)
        out.append(logits.float())
        if tokens is None:
            toks.append(logits.argmax(-1))
    return out, toks


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    rr, kk = (torch.randn(4, 128, 40, 64, device=dev, generator=g) for _ in range(2))
    u = torch.randn(40, 64, device=dev, generator=g)
    print("bonus: vecdot equals (r * u * k).sum(-1) bitwise:",
          torch.equal(torch.linalg.vecdot(rr * u, kk), (rr * u * kk).sum(-1)), flush=True)
    cfg = get_config("rwkv6-3b")
    for seed in (0, 1, 2):
        t0 = time.perf_counter()
        model = rwkv6.init_params(cfg, seed=seed, device=dev)
        rng = np.random.default_rng(1 if seed == 0 else 100 + seed)
        prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (cs.LM_BATCH, 2048))).to(dev)
        ref, toks = serve(model, cfg, prompts)
        rows = {}
        for name, chunk, lora in (("bonus_product", chunk_bonus_product, LORA),
                                  ("lora_row_split", CHUNK, lora_two_row_blocks),
                                  ("both", chunk_bonus_product, lora_two_row_blocks),
                                  ("again", CHUNK, LORA)):
            rwkv6._chunk, rwkv6._lora = chunk, lora
            try:
                got, _ = serve(model, cfg, prompts, toks)
            finally:
                rwkv6._chunk, rwkv6._lora = CHUNK, LORA
            rows[name] = [round(float((a - b).abs().max()), 4) for a, b in zip(got, ref)]
        print(f"seed {seed}: max |logit| {float(ref[0].abs().max()):.3f}; max |variant - "
              f"unsharded| (prefill, decode 1, decode 2): {rows} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
