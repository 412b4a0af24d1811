"""Sharded train, prefill and decode programs for an (arch x shape x mesh)
cell: the logical specs resolved by the rules, and the steps run on the
mesh's rank processes with resident state.

    mesh = make_mesh((2, 2), ("data", "model"), device="cuda")
    train = build_train_programs(cfg, mesh, ShapeSpec("t", "train", 2048, 4))
    train.init(seed=0)                       # each rank draws, keeps its blocks
    metrics = train.step({"tokens": tokens})  # (4, 2049): only tokens travel

The JAX package jits one global program with in/out shardings and donated
buffers. Here every rank holds its blocks of the parameters, the optimizer
moments and the decode state between calls (its ``RankMesh.resident``,
keyed by the programs' ``key``: programs built with one key share the
weights, and a decode program reads the state its prefill left). A call ships the
tokens (every rank keeps its batch rows) and returns the loss, or the
logits assembled from the ranks' vocab blocks. :meth:`CellPrograms.load`
ships whole weights instead of drawing them (the CPU tests carry the JAX
package's weights that way), and the ``gather_*`` methods bring blocks
back whole (the host round trip of a re-mesh, ``runtime/elastic.py``).

Every family runs on the mesh: dense, MoE and VLM (``models/transformer.py``),
SSM (``rwkv6.py``), hybrid (``zamba2.py``, ``mamba2.py``) and encoder-decoder
(``whisper.py``, whose ``frames`` travel with the tokens, each rank keeping
its rows). The decode state is the family's: KV caches, the RWKV state, or
the Mamba states and attention caches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
from torch import nn

from ..configs.shapes import ShapeSpec
from ..convert import shard_params, unshard_params
from ..kernels.flash_attention.kernel import flash_attn
from ..models import api
from ..models import sharding as sh
from ..models.config import ModelConfig
from ..models.layers import DRAW_HOOK, Ctx
from ..models.sharding import Rules, make_rules
from ..optim import AdamWConfig, AdamWState

# per-arch microbatch counts: gradient accumulation for cells whose
# activations exceed memory at the full per-device batch
MICROBATCHES = {"mixtral-8x22b": 4, "zamba2-2.7b": 2}


@dataclasses.dataclass
class CellPrograms:
    """The programs of one cell on a mesh (the JAX package's
    ``CellPrograms``): the caller's context (``ctx.mesh`` is the
    :class:`launch.mesh.DeviceMesh`), the rules, every sharding as specs
    (mesh axes a dim), ``step`` (train: ``step(batch) -> metrics``;
    prefill: ``step(batch) -> last-token logits``; decode: ``step(token)
    -> logits``) and ``abstract_inputs`` (meta tensors)."""

    ctx: Ctx
    rules: Rules
    param_sharding: dict
    batch_sharding: Any = None
    opt_sharding: Any = None
    state_sharding: Any = None
    step: Callable = None
    abstract_inputs: Any = None
    key: str = ""
    microbatches: int = 1
    opt_cfg: "AdamWConfig | None" = None
    last_stats: list = dataclasses.field(default_factory=list)

    @property
    def mesh(self):
        return self.ctx.mesh

    def _static(self) -> dict:
        return dict(key=self.key, cfg=self.ctx.cfg, rules=self.rules)

    def _call(self, body, *args, **static) -> list:
        out = self.mesh.run(body, args, **self._static(), **static)
        self.last_stats = [r["stats"] for r in out]
        return out

    def init(self, seed: int = 0) -> list[dict]:
        """Every rank draws each global weight from ``seed`` in
        ``init_params``' order and keeps its block (a train step starts
        from zero moments). Returns each rank's stats (card memory)."""
        return [r["stats"] for r in self._call(_init_body, seed=seed)]

    def load(self, params: dict, opt_state: AdamWState | None = None) -> None:
        """Ship whole weights (a name-keyed dict) and the optimizer state
        (a train step starts from zero moments without one); each rank
        keeps its blocks."""
        self._call(_load_body, params, opt_state)

    def gather_params(self) -> dict:
        """Every weight whole, from the ranks' blocks."""
        return self._whole(self._call(_blocks_body, what="params"))

    def _whole(self, out: list) -> dict:
        return unshard_params([r["blocks"] for r in out], [r["coords"] for r in out],
                              self.ctx.cfg, self.rules, self.mesh.shape)

    def gather_opt_state(self) -> AdamWState:
        """The optimizer state whole: the step, every moment (and residual)."""
        out = self._call(_blocks_body, what="opt")

        def whole(field):
            if out[0]["blocks"][field] is None:
                return None
            return self._whole([{**r, "blocks": r["blocks"][field]} for r in out])

        return AdamWState(step=out[0]["step"], mu=whole("mu"), nu=whole("nu"),
                          ef_residual=whole("ef_residual"))

    def gather_state(self):
        """The decode state left by the last prefill or decode step, whole."""
        out = self._call(_blocks_body, what="state")
        first = out[0]["blocks"]
        specs = out[0]["state_spec"]
        fields = {}
        for name in first._fields:
            if name == "length":
                fields[name] = first.length
            else:
                fields[name] = sh.unblock([getattr(r["blocks"], name) for r in out],
                                          [r["coords"] for r in out], getattr(specs, name),
                                          self.mesh.shape)
        return type(first)(**fields)

    def loss_and_grads(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """The loss and every weight's gradient, whole, at the resident
        weights (no update): the train step's first half."""
        out = self._call(_grads_body, batch, microbatches=self.microbatches)
        return out[0]["loss"], self._whole(out)

    def release(self) -> None:
        """Drop the ranks' state under this programs' key (weights, moments,
        decode state) and return their cached card memory."""
        self._call(_release_body)

    def drops(self) -> dict:
        """Routed and kept MoE slots in the last call, summed over ranks."""
        return {k: sum(s["drops"][k] for s in self.last_stats) for k in ("routed", "kept")}

    def collectives(self) -> dict:
        """Collective calls and host seconds in the last call, per axis
        (the slowest rank's seconds)."""
        out = {}
        for axis in self.mesh.axis_names:
            rows = [s["counts"][axis] for s in self.last_stats if axis in s["counts"]]
            if rows:
                out[axis] = {"calls": rows[0]["calls"],
                             "seconds": max(r["seconds"] for r in rows)}
        return out


# -- the builders ------------------------------------------------------------------------


def _resolved(cfg: ModelConfig, rules: Rules) -> dict:
    return {name: rules.spec(*logical) for name, logical in api.param_specs(cfg).items()}


def _rules(cfg: ModelConfig, mesh, **kw) -> Rules:
    return make_rules(mesh, num_experts=cfg.num_experts, num_heads=cfg.num_heads,
                      num_kv_heads=cfg.num_kv_heads, vocab_size=cfg.vocab_size, **kw)


def _batch_specs(rules: Rules, inputs: dict) -> dict:
    """Each input's spec: its first dim laid out as ``batch``."""
    return {n: _batch_spec(rules, t.dim()) for n, t in inputs.items()}


def _batch_spec(rules: Rules, ndim: int) -> tuple:
    return rules.spec("batch", *([None] * (ndim - 1)))


def _state_specs(cfg: ModelConfig, rules: Rules):
    specs = api.decode_state_specs(cfg)
    return type(specs)(**{n: () if n == "length" else rules.spec(*getattr(specs, n))
                          for n in specs._fields})


def build_train_programs(cfg: ModelConfig, mesh, shape: ShapeSpec,
                         opt_cfg: AdamWConfig | None = None, microbatches: int | None = None,
                         *, key: str | None = None) -> CellPrograms:
    """The train step (rules with ``seq_shard``; AdamW moments sharded as
    the weights, the step count replicated; :data:`MICROBATCHES`)."""
    opt_cfg = opt_cfg or AdamWConfig()
    rules = _rules(cfg, mesh, seq_shard=True)
    psh = _resolved(cfg, rules)
    params_abs = api.abstract_params(cfg)
    batch_abs = api.input_specs(cfg, "train", shape.seq_len, shape.global_batch)
    progs = CellPrograms(
        ctx=Ctx(cfg, mesh, rules), rules=rules, param_sharding=psh,
        batch_sharding=_batch_specs(rules, batch_abs),
        opt_sharding=AdamWState(step=(), mu=psh, nu=psh,
                                ef_residual=psh if opt_cfg.compress_grads else None),
        abstract_inputs=(params_abs, api.init_opt(cfg, params_abs, opt_cfg), batch_abs),
        key=key or cfg.name,
        microbatches=microbatches or MICROBATCHES.get(cfg.name, 1),
        opt_cfg=opt_cfg,
    )

    def step(batch: dict) -> dict:
        out = progs._call(_train_body, batch, opt_cfg=opt_cfg, microbatches=progs.microbatches)
        return out[0]["metrics"]

    progs.step = step
    return progs


def build_prefill_programs(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
                           key: str | None = None) -> CellPrograms:
    """The prompt pass: caches sized ``shape.seq_len`` stay in the ranks. A
    batch that ``data`` does not divide is replicated over it (GSPMD pads
    it instead; the numbers are the same)."""
    rules = _rules(cfg, mesh, seq_shard=True)
    if shape.global_batch % sh.axis_size(sh.mesh_sizes(mesh), rules.batch):
        rules = dataclasses.replace(rules, batch=None)
    batch_abs = api.input_specs(cfg, "prefill", shape.seq_len, shape.global_batch)
    progs = CellPrograms(
        ctx=Ctx(cfg, mesh, rules), rules=rules, param_sharding=_resolved(cfg, rules),
        batch_sharding=_batch_specs(rules, batch_abs),
        state_sharding=_state_specs(cfg, rules),
        abstract_inputs=(api.abstract_params(cfg), batch_abs),
        key=key or cfg.name,
    )

    def step(batch: dict) -> torch.Tensor:
        out = progs._call(_prefill_body, batch, max_len=shape.seq_len)
        return sh.unblock([r["logits"] for r in out], [r["coords"] for r in out],
                          rules.spec("batch", None, "vocab"), mesh.shape)

    progs.step = step
    return progs


def build_decode_programs(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
                          key: str | None = None) -> CellPrograms:
    """One decode step over the resident state (``long_context`` when the
    batch cannot fill ``data``: the batch replicated, the KV sequence
    sharded over ``data``)."""
    long_ctx = shape.global_batch < mesh.shape["data"]
    rules = _rules(cfg, mesh, long_context=long_ctx)
    if long_ctx:
        rules = dataclasses.replace(rules, batch=None)
    inputs = api.input_specs(cfg, "decode", shape.seq_len, shape.global_batch)
    progs = CellPrograms(
        ctx=Ctx(cfg, mesh, rules), rules=rules, param_sharding=_resolved(cfg, rules),
        batch_sharding={"token": rules.spec("batch", None)},
        state_sharding=_state_specs(cfg, rules),
        abstract_inputs=(api.abstract_params(cfg), inputs["token"], inputs["state"]),
        key=key or cfg.name,
    )

    def step(token: torch.Tensor) -> torch.Tensor:
        out = progs._call(_decode_body, token)
        return sh.unblock([r["logits"] for r in out], [r["coords"] for r in out],
                          rules.spec("batch", None, "vocab"), mesh.shape)

    progs.step = step
    return progs


def build_programs(cfg: ModelConfig, mesh, shape: ShapeSpec, **kw) -> CellPrograms:
    if shape.kind == "train":
        return build_train_programs(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_programs(cfg, mesh, shape, **kw)
    return build_decode_programs(cfg, mesh, shape, **kw)


# -- the rank side ------------------------------------------------------------------------


def _stats(mesh, device: torch.device) -> dict:
    """The call's counts and, on the card, its memory (``peak_bytes``: the
    most allocated since the call began, in the allocator's blocks;
    ``requested_peak_bytes``: the same in the sizes the tensors asked for)."""
    st = {"counts": mesh.counts(),
          "drops": {k: mesh.tallies.get(f"moe_{k}", 0) for k in ("routed", "kept")},
          "flash_launches": flash_attn.launches}
    if device.type == "cuda":
        st["allocated_bytes"] = torch.cuda.memory_allocated(device)
        st["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        st["requested_peak_bytes"] = torch.cuda.memory_stats(device)["requested_bytes.all.peak"]
        st["reserved_bytes"] = torch.cuda.memory_reserved(device)
    return st


def _begin(mesh, device: torch.device) -> None:
    """Zero the call's counts (collectives, MoE slots, flash launches) and
    the card's peak memory."""
    mesh.reset_counts()
    flash_attn.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _reply(mesh, group, **fields) -> dict:
    return {"coords": dict(mesh.coords), "stats": _stats(mesh, group.device), **fields}


def _set_param(model: nn.Module, name: str, t: torch.Tensor) -> None:
    owner, _, attr = name.rpartition(".")
    setattr(model.get_submodule(owner) if owner else model, attr, nn.Parameter(t))


def _draw_order(cfg: ModelConfig) -> list[str]:
    """The names of the weights ``init_params`` draws, in draw order."""
    drawn: list = []

    def record(p):
        drawn.append(p)
        return p

    token = DRAW_HOOK.set(record)
    try:
        model = api.init_params(cfg, device="meta")
    finally:
        DRAW_HOOK.reset(token)
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for p in drawn]


def _local_model(cfg: ModelConfig, mesh, specs: dict, seed: int, device) -> nn.Module:
    """The model holding this rank's blocks, drawn from ``seed``: each
    global weight drawn whole in ``init_params``' order (so the stream is
    the unsharded model's), its block kept, the rest freed at once."""
    drawn = _draw_order(cfg)
    order = iter(drawn)

    def keep(p):
        return nn.Parameter(sh.shard_tensor(mesh, p.data, specs[next(order)]).clone())

    token = DRAW_HOOK.set(keep)
    try:
        model = api.init_params(cfg, seed=seed, device=device)
    finally:
        DRAW_HOOK.reset(token)
    drawn = set(drawn)
    for name, p in list(model.named_parameters()):  # the constants: norms, biases
        if name not in drawn:
            _set_param(model, name, sh.shard_tensor(mesh, p.data, specs[name]).clone())
    return model


def _init_body(rank, world, group, *, key, cfg, rules, seed):
    mesh = group.mesh
    _begin(mesh, group.device)
    t0 = time.perf_counter()
    mesh.resident[key] = {"params": _local_model(cfg, mesh, _resolved(cfg, rules), seed,
                                                 group.device)}
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)
    return _reply(mesh, group, init_s=time.perf_counter() - t0)


def _load_body(rank, world, group, params, opt_state, *, key, cfg, rules):
    mesh = group.mesh
    _begin(mesh, group.device)
    model = api.init_params(cfg, device="meta")
    dtypes = {n: p.dtype for n, p in model.named_parameters()}

    def blocks(named: dict, dtype=None) -> dict:
        return {n: t.to(group.device, dtype or dtypes[n]).clone() for n, t in
                shard_params(named, cfg, rules, mesh.coords, mesh.shape).items()}

    for name, block in blocks(params).items():
        _set_param(model, name, block)
    mesh.resident[key] = {"params": model}
    if opt_state is not None:
        def moments(d):
            return None if d is None else blocks(d, torch.float32)

        mesh.resident[key]["opt"] = AdamWState(
            step=int(opt_state.step), mu=moments(opt_state.mu), nu=moments(opt_state.nu),
            ef_residual=moments(opt_state.ef_residual))
    return _reply(mesh, group)


def _blocks_body(rank, world, group, *, key, cfg, rules, what):
    mesh = group.mesh
    res = mesh.resident[key]
    if what == "params":
        blocks = {n: p.detach() for n, p in res["params"].named_parameters()}
        return _reply(mesh, group, blocks=blocks)
    if what == "opt":
        opt = res["opt"]
        return _reply(mesh, group, step=opt.step, blocks=opt._asdict())
    state = res["state"]  # made under inference mode: copies travel
    state = type(state)(**{n: v if n == "length" else v.clone() for n, v in state._asdict().items()})
    return _reply(mesh, group, blocks=state, state_spec=res["state_spec"])


def _release_body(rank, world, group, *, key, cfg, rules):
    mesh = group.mesh
    _begin(mesh, group.device)
    mesh.resident.pop(key, None)
    if group.device.type == "cuda":
        torch.cuda.empty_cache()
    return _reply(mesh, group)


def _rows(mesh, rules: Rules, t: torch.Tensor, device) -> torch.Tensor:
    """This rank's batch rows of a whole input, on its device."""
    return sh.shard_tensor(mesh, t, _batch_spec(rules, t.dim())).to(device)


def _opt(res: dict, opt_cfg: AdamWConfig) -> AdamWState:
    if res.get("opt") is None:
        res["opt"] = api.init_opt(None, res["params"], opt_cfg)
    return res["opt"]


# -- one rank's step: the rank bodies and the dry-run (launch/dryrun.py) share it ---------


def train_local(ctx: Ctx, res: dict, local: dict, opt_cfg: AdamWConfig,
                microbatches: int) -> dict:
    """One train step on the rank's resident weights and moments (``res``;
    zero moments on the first step) over its batch rows ``local``; the
    metrics as tensors."""
    opt = _opt(res, opt_cfg)
    with torch.enable_grad():
        _, res["opt"], metrics = api.train_step(ctx, res["params"], opt, local, opt_cfg,
                                                microbatches=microbatches)
    return metrics


def prefill_local(ctx: Ctx, res: dict, local: dict, max_len: int) -> torch.Tensor:
    """The prompt pass over the rank's rows ``local`` (tokens and the
    family's frames or patches); the decode state stays in ``res``. The
    rank's block of the last-token logits."""
    local = dict(local)
    tokens = local.pop("tokens")
    logits, state = api.prefill(ctx, res["params"], tokens, max_len, batch=local)
    res["state"], res["state_spec"] = state, _state_specs(ctx.cfg, ctx.rules)
    return logits


def decode_local(ctx: Ctx, res: dict, token: torch.Tensor) -> torch.Tensor:
    """One decode step of the rank's rows ``token`` over the resident state
    (first moved from the prefill's layout to the decode's); the rank's
    block of the logits."""
    spec = _state_specs(ctx.cfg, ctx.rules)
    if res["state_spec"] != spec:  # the prefill's layout -> the decode's
        old, state = res["state_spec"], res["state"]
        res["state"] = type(state)(**{
            n: state.length if n == "length"
            else sh.relayout(ctx.mesh, getattr(state, n), getattr(old, n), getattr(spec, n))
            for n in state._fields})
        res["state_spec"] = spec
    logits, res["state"] = api.decode_step(ctx, res["params"], token, res["state"])
    return logits


def _train_body(rank, world, group, batch, *, key, cfg, rules, opt_cfg, microbatches):
    mesh = group.mesh
    _begin(mesh, group.device)
    res = mesh.resident[key]
    local = {n: _rows(mesh, rules, t, group.device) for n, t in batch.items()}
    t0 = time.perf_counter()
    metrics = train_local(Ctx(cfg, mesh, rules), res, local, opt_cfg, microbatches)
    metrics = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"])}
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)
    return _reply(mesh, group, metrics=metrics, step_s=time.perf_counter() - t0)


def _grads_body(rank, world, group, batch, *, key, cfg, rules, microbatches):
    mesh = group.mesh
    _begin(mesh, group.device)
    res = mesh.resident[key]
    local = {n: _rows(mesh, rules, t, group.device) for n, t in batch.items()}
    with torch.enable_grad():
        loss, grads = api.loss_and_grads(Ctx(cfg, mesh, rules), res["params"], local, microbatches)
    return _reply(mesh, group, loss=loss, blocks=grads)


def _prefill_body(rank, world, group, batch, *, key, cfg, rules, max_len):
    mesh = group.mesh
    _begin(mesh, group.device)
    local = {n: _rows(mesh, rules, t, group.device) for n, t in batch.items()}
    logits = prefill_local(Ctx(cfg, mesh, rules), mesh.resident[key], local, max_len)
    return _reply(mesh, group, logits=logits.clone())


def _decode_body(rank, world, group, token, *, key, cfg, rules):
    mesh = group.mesh
    _begin(mesh, group.device)
    local = _rows(mesh, rules, token, group.device)
    logits = decode_local(Ctx(cfg, mesh, rules), mesh.resident[key], local)
    return _reply(mesh, group, logits=logits.clone())
