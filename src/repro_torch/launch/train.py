"""End-to-end training launcher with fault-tolerant supervision.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b --reduced \\
        --steps 100 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt [--device cpu]

    PYTHONPATH=src python -m repro_torch.launch.train --full --arch llama3.2-3b \\
        --steps 4 --batch 4 --seq 2048 --ckpt-every 1000

Trains any family under ``run_supervised`` on the card (on the CPU with
``--device cpu``): random weights from seed 0, the synthetic token stream
from seed 0 (with numpy N(0, 1) frames or patches from the step's seed for
the stub frontends of whisper and phi-3-vision), AdamW with warmup over the
first tenth of the steps.
Attention takes the reference branch: the flash kernel has no backward.
``--fail-at N`` demonstrates checkpoint/restart recovery. The final
checkpoint holds the weights and the float32 moments (about 12 bytes a
weight), so give ``--ckpt-dir`` room for it.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs import get_config, reduced_config
from ..data import DataConfig, SyntheticTokens
from ..device import resolve_device
from ..models import Ctx, api
from ..optim import AdamWConfig
from .serve import stub_inputs
from ..runtime import SupervisorConfig, run_supervised, straggler_report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None,
                    help="override width (e.g. ~100M model)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    upd = {}
    if args.d_model:
        upd["d_model"] = args.d_model
        upd["d_ff"] = args.d_model * 3
        upd["num_heads"] = max(2, args.d_model // 64)
        upd["num_kv_heads"] = max(1, args.d_model // 128)
        upd["head_dim"] = 64
    if args.layers:
        upd["num_layers"] = args.layers
    if args.vocab:
        upd["vocab_size"] = args.vocab
    if upd:
        cfg = dataclasses.replace(cfg, **upd)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=args.steps // 10)

    data = SyntheticTokens(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch)
    )
    ctx = Ctx(cfg=cfg)

    def build():
        params = api.init_params(cfg, seed=0, device=dev)
        opt = api.init_opt(cfg, params, opt_cfg)
        n_params = sum(p.numel() for p in params.parameters())
        print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={dev}")

        def step_fn(params, opt_state, batch):
            return api.train_step(ctx, params, opt_state, batch, opt_cfg)

        return params, opt, step_fn

    sup = SupervisorConfig(
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        total_steps=args.steps,
    )
    def data_for_step(step: int) -> dict:
        batch = data.torch_batch(step, dev)
        stub = stub_inputs(cfg, args.batch, step)
        batch.update({k: torch.as_tensor(v, device=dev) for k, v in stub.items()})
        return batch

    result = run_supervised(sup, build=build, data_for_step=data_for_step, fail_at=args.fail_at)
    first = sum(result.losses[:5]) / max(len(result.losses[:5]), 1)
    last = sum(result.losses[-5:]) / max(len(result.losses[-5:]), 1)
    print(
        f"done: steps={result.final_step + 1} restarts={result.restarts} "
        f"loss {first:.3f} -> {last:.3f}"
    )
    print("stragglers:", straggler_report(result.step_times))


if __name__ == "__main__":
    main()
