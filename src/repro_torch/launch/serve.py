"""Batched LM serving: prefill a batch of prompts, then greedy-decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b --reduced \\
        --batch 4 --prompt-len 64 --gen 32 [--device cpu]

Weights are random, drawn from seed 0 on the device; prompts are numpy
integers from seed 1. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from ..configs import get_config, reduced_config
from ..device import resolve_device
from ..models import Ctx, api
from ..models.config import ModelConfig


class ServeResult(NamedTuple):
    tokens: torch.Tensor  # (B, gen) greedy token ids, int64
    prefill_seconds: float  # the prompt pass, to its logits on the host's clock
    decode_seconds: float  # the gen - 1 decode steps after it


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_serve(cfg: ModelConfig, model, prompts, gen: int, device="cuda") -> ServeResult:
    """Prefill ``prompts`` (B, S) through ``model`` under ``cfg``, then take
    ``gen`` greedy tokens: the first from the prefill's logits, the rest
    from ``gen - 1`` decode steps."""
    if gen < 1:
        raise ValueError(f"gen must be at least 1, got {gen}")
    dev = resolve_device(device)
    ctx = Ctx(cfg)
    prompts = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    max_len = prompts.shape[1] + gen
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, state = api.prefill(ctx, model, prompts, max_len)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, state = api.decode_step(ctx, model, tok, state)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            out.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    return ServeResult(torch.cat(out, dim=1), t_prefill, t_decode)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = api.init_params(cfg, seed=0, device=args.device)
    prompts = np.random.default_rng(1).integers(1, cfg.vocab_size, (args.batch, args.prompt_len))
    res = lm_serve(cfg, model, prompts, args.gen, args.device)
    print(f"arch={cfg.name} batch={args.batch} device={args.device}")
    print(f"prefill: {args.batch * args.prompt_len / res.prefill_seconds:.0f} tok/s "
          f"({res.prefill_seconds * 1e3:.0f} ms)")
    print(f"decode:  {args.batch * (args.gen - 1) / max(res.decode_seconds, 1e-9):.0f} tok/s")
    print("sample token ids:", res.tokens[0, :16].tolist())


if __name__ == "__main__":
    main()
