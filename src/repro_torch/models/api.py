"""Family-dispatching model API: ``init_params``, ``loss_fn``,
``train_step`` (loss + grad + AdamW) and ``init_opt`` for training;
``prefill``, ``decode_step`` and ``init_decode_state`` for serving; the
spec builders ``param_specs``, ``decode_state_specs``, ``abstract_params``
and ``input_specs`` (meta tensors) for the mesh's step builders and the
dry-run. Six families: dense, MoE and VLM (``transformer``), SSM
(``rwkv6``), hybrid (``zamba2``) and encoder-decoder (``whisper``)."""
from __future__ import annotations

import torch

from ..optim import AdamWConfig, AdamWState, apply_updates
from ..optim import init as adamw_init
from . import rwkv6, sharding as sh, transformer, whisper, zamba2
from .config import ModelConfig
from .layers import Ctx, dtype_of

_FAMILY = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": rwkv6,
    "hybrid": zamba2,
    "encdec": whisper,
}


def module_for(cfg: ModelConfig):
    return _FAMILY[cfg.family]


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    return module_for(cfg).init_params(cfg, seed, device)


def abstract_params(cfg: ModelConfig):
    """The model on the meta device: every parameter's shape and type, no
    memory."""
    return init_params(cfg, device="meta")


def param_specs(cfg: ModelConfig) -> dict:
    """Logical specs keyed by the parameter names (one tensor a layer)."""
    return module_for(cfg).param_specs(cfg)


def loss_fn(ctx: Ctx, params, batch: dict) -> torch.Tensor:
    """Mean next-token CE of ``batch["tokens"]``, with ``batch["frames"]``
    (encdec) or ``batch["patches"]`` (vlm) where the family takes them."""
    return module_for(ctx.cfg).loss_fn(ctx, params, batch)


def loss_and_grads(ctx: Ctx, params, batch: dict, microbatches: int = 1):
    """The loss (0-d float32, detached) and each weight's gradient (a dict
    keyed by the parameter names). With ``microbatches`` > 1 the batch
    splits along its first axis into that many equal rows of microbatches;
    their gradients are accumulated in float32 (``g.float() / m`` each) and
    their losses as ``loss / m``.

    On the ``(data, model)`` mesh (``ctx.mesh`` a rank's view) ``params``
    are the rank's blocks and ``batch`` its rows: each rank seeds its copy
    of the loss with 1 / ranks (the collectives' backwards are exact
    adjoints), and the gradients of the weights a rank holds replicated are
    summed over their replica axes."""
    named = dict(params.named_parameters())
    weights = list(named.values())
    seed = None
    if ctx.mesh is not None:
        seed = torch.full((), 1.0 / sh.axis_size(ctx.mesh, ctx.mesh.axis_names),
                          dtype=torch.float32, device=weights[0].device)
    if microbatches <= 1:
        loss = loss_fn(ctx, params, batch)
        grads = dict(zip(named, torch.autograd.grad(loss, weights, grad_outputs=seed)))
        loss = loss.detach()
    else:
        m = microbatches
        b = next(iter(batch.values())).shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by microbatches {m}")
        rows = b // m
        grads = {n: torch.zeros(w.shape, dtype=torch.float32, device=w.device) for n, w in named.items()}
        loss = torch.zeros((), dtype=torch.float32, device=weights[0].device)
        for i in range(m):
            mb = {key: leaf[i * rows:(i + 1) * rows] for key, leaf in batch.items()}
            l = loss_fn(ctx, params, mb)
            for acc, g in zip(grads.values(), torch.autograd.grad(l, weights, grad_outputs=seed)):
                acc.add_(g.float() / m)
            loss = loss + l.detach() / m
    if ctx.mesh is not None:
        grads = MeshReduce(ctx).sum_replicas(grads)
    return loss, grads


def train_step(
    ctx: Ctx, params, opt_state: AdamWState, batch: dict, opt_cfg: AdamWConfig,
    microbatches: int = 1,
):
    """One optimizer step on the model ``params``, in place, from
    :func:`loss_and_grads` (activation memory / m with ``microbatches``).
    Returns (params, opt_state, metrics) with ``metrics["loss"]`` (0-d
    float32 tensor), ``"grad_norm"`` and ``"lr"``. On the mesh the update
    reduces the norm and the int8 scale over the mesh (:class:`MeshReduce`)."""
    loss, grads = loss_and_grads(ctx, params, batch, microbatches)
    reduce = None if ctx.mesh is None else MeshReduce(ctx)
    params, opt_state, metrics = apply_updates(params, opt_state, grads, opt_cfg, reduce)
    metrics["loss"] = loss
    return params, opt_state, metrics


class MeshReduce:
    """The reductions a rank's optimizer step needs over the mesh of
    ``ctx``: a weight's replica axes are the mesh axes its spec does not
    shard it over."""

    def __init__(self, ctx: Ctx):
        self.mesh = ctx.mesh
        axes = ctx.mesh.axis_names
        self.replicas: dict[str, tuple] = {}
        for name, logical in param_specs(ctx.cfg).items():
            used = {a for e in ctx.rules.spec(*logical) for a in sh.axes_of(e)}
            self.replicas[name] = tuple(a for a in axes if a not in used)

    def sum_replicas(self, grads: dict) -> dict:
        """Each gradient summed over its weight's replica axes."""
        with torch.no_grad():
            return {n: sh.psum(self.mesh, g, self.replicas[n]) for n, g in grads.items()}

    def sum_squares(self, grads: dict) -> torch.Tensor:
        """The squares of every weight's gradient, each replicated block
        counted once, summed over the mesh (0-d float32)."""
        total = sum(g.float().square().sum() / sh.axis_size(self.mesh, self.replicas[n])
                    for n, g in grads.items())
        return sh.psum(self.mesh, total, self.mesh.axis_names)

    def amax(self, t: torch.Tensor) -> torch.Tensor:
        return sh.pmax(self.mesh, t, self.mesh.axis_names)


def init_opt(cfg: ModelConfig, params, opt_cfg: AdamWConfig) -> AdamWState:
    del cfg  # the moments follow the parameters
    return adamw_init(params, opt_cfg)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """The empty decode state: the recurrent state of an SSM, else caches
    sized ``max_len``."""
    if cfg.family == "ssm":
        return rwkv6.init_state(cfg, batch, device)
    return module_for(cfg).init_caches(cfg, batch, max_len, device)


def decode_state_specs(cfg: ModelConfig):
    """Logical specs of the decode state: the SSM's state, else the caches."""
    if cfg.family == "ssm":
        return rwkv6.state_specs(cfg)
    return module_for(cfg).cache_specs(cfg)


def input_specs(cfg: ModelConfig, kind: str, seq_len: int, global_batch: int) -> dict:
    """Every model input of a (shape kind x arch) cell as meta tensors:

    train:   the batch of ``train_step`` (tokens and the modality stubs);
    prefill: the prompt batch;
    decode:  one new token and the decode state sized to ``seq_len``.
    """
    dt = dtype_of(cfg)
    b, s = global_batch, seq_len

    def meta(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind == "train":
        if cfg.family == "encdec":
            return {"tokens": meta((b, s + 1)),
                    "frames": meta((b, cfg.encoder_frames, cfg.d_model), dt)}
        if cfg.family == "vlm":
            return {"tokens": meta((b, s - cfg.num_patches + 1)),
                    "patches": meta((b, cfg.num_patches, cfg.d_model), dt)}
        return {"tokens": meta((b, s + 1))}
    if kind == "prefill":
        out = {"tokens": meta((b, s))}
        if cfg.family == "encdec":
            out["frames"] = meta((b, cfg.encoder_frames, cfg.d_model), dt)
        if cfg.family == "vlm":
            out["patches"] = meta((b, cfg.num_patches, cfg.d_model), dt)
        return out
    if kind == "decode":
        return {"token": meta((b, 1)), "state": init_decode_state(cfg, b, s, device="meta")}
    raise ValueError(f"unknown shape kind {kind}")


def prefill(ctx: Ctx, params, tokens: torch.Tensor, max_len: int, batch: dict | None = None):
    """The prompt pass: (last-token logits, decode state). ``batch`` holds
    the encoder's ``"frames"`` (encdec) or the ``"patches"`` that precede
    the prompt (vlm)."""
    m = module_for(ctx.cfg)
    if ctx.cfg.family == "encdec":
        return m.prefill(ctx, params, tokens, max_len, batch["frames"])
    if ctx.cfg.family == "vlm":
        return m.prefill(ctx, params, tokens, max_len, extra_embeds=batch["patches"])
    return m.prefill(ctx, params, tokens, max_len)


def decode_step(ctx: Ctx, params, token: torch.Tensor, state):
    return module_for(ctx.cfg).decode_step(ctx, params, token, state)
