"""Roofline terms of one traced rank: the dry-run's byte source, where the
JAX package parses the compiled HLO.

A rank's step runs on the meta device (shapes and types, no memory, no
arithmetic) under :class:`Tracer`, a dispatch mode that sees every aten op
the step dispatches, its backward and its recomputed checkpoints included,
on a :class:`RecordingMesh` whose collectives return empty tensors of their
real shapes and record what they would move. The model code runs as it runs
on a real mesh: it calls the same collectives through ``models/sharding.py``,
so the counts are the real mesh's by construction. Per device and step:

    compute    = matmul FLOPs (``torch.utils.flop_counter``'s formulas) and
                 those of ``torch.linalg.vecdot`` (2 a multiply-add) over
                 the peak of their type: bf16 on the tensor cores, float32
                 outside them
    memory     = operand plus output bytes of every aten op (views and
                 metadata ops skipped): eager PyTorch fuses nothing, so this
                 is the counterpart of the HLO's bytes of non-fused ops
    collective = ring-cost wire bytes of every collective over the link
                 bandwidth

``torch.linalg.vecdot`` reaches the dispatcher as an elementwise product and
a sum, so under a trace it is counted where it is called (:func:`_vecdots`),
as the HLO counts a dot over the same dim. The flash kernel is
a ctypes launch the dispatcher cannot see: under a trace
its calls return an empty output and count ``4 D`` FLOPs a visible (q, k)
pair, the formula ``chip_smoke.py`` bounds the kernel with. The peaks come
from the port's machine file (:func:`~repro_torch.machine.machine.default_machine`:
the H100 SXM's data-sheet figures unless calibrated), never from a TPU's.

Memory keeps the reference's keys with their eager meaning: arguments are
what exists before the step (the rank's weight blocks, moments, batch rows,
decode state), temporaries the peak of what the step allocates, read from
the meta storages' lives, outputs what it leaves behind plus what it
updates in place (the aliases: the AdamW step's weights and moments, the
decode caches), so that ``peak = arguments + outputs + temporaries - aliases``
is the most the rank holds during the step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..machine.machine import BF16_TENSOR_FLOPS, default_machine
from .mesh import MeshShape, RankMesh

aten = torch.ops.aten

#: collective kinds, by the names the HLO gives them
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all"}

# ops that move no bytes of their own: allocation without a write, metadata
_NO_BYTES = {
    aten.detach, aten.alias, aten.lift_fresh, aten.empty, aten.empty_like, aten.empty_strided,
    aten.new_empty, aten.new_empty_strided, aten._local_scalar_dense, aten.set_, aten.resize_,
    aten.sym_size, aten.sym_stride, aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
    aten._unsafe_view,
}


def ring_wire_bytes(kind: str, bytes_in: float, group_size: int) -> float:
    """Bytes a device puts on the wire for one collective of ``bytes_in``
    operand bytes over ``group_size`` devices, by ring costs."""
    g = group_size
    if kind == "all-gather":
        return (g - 1) * bytes_in
    if kind == "all-reduce":
        return 2 * (g - 1) / max(g, 1) * bytes_in
    if kind in ("reduce-scatter", "all-to-all"):
        return (g - 1) / max(g, 1) * bytes_in
    return bytes_in  # a permute


@dataclasses.dataclass
class CollectiveRecord:
    kind: str
    bytes_in: int  # per-device operand bytes (one execution)
    group_size: int
    count: int  # executions per step
    wire_bytes: float  # ring-cost bytes on the wire per device, total


@dataclasses.dataclass
class RooflineReport:
    flops: float  # per device per step
    bytes_hbm: float
    bytes_collective: float  # wire bytes per device
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    collectives: list  # top CollectiveRecords (dicts)
    collective_counts: dict  # kind -> wire bytes

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# -- the recording mesh --------------------------------------------------------------


class RecordingGroup:
    """:class:`~repro_torch.launch.mesh.RankGroup`'s four collectives on one
    axis of a traced rank: each returns an empty tensor of the real output's
    shape and type on the operand's device and records the call."""

    def __init__(self, mesh: "RecordingMesh", axis: str, rank: int, world: int):
        self.owner, self.axis, self.rank, self.world = mesh, axis, rank, world
        self.device = torch.device("meta")
        self.mesh = None
        self.seconds = 0.0
        self.calls = 0

    def _collective(self, kind: str, t: torch.Tensor, out_shape) -> torch.Tensor:
        src = t.contiguous()
        out = torch.empty(out_shape, dtype=src.dtype, device=src.device)
        self.calls += 1
        self.owner.record(KINDS[kind], src.numel() * src.element_size(),
                          out.numel() * out.element_size(), self.world)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        return self._collective("all_gather", t, (self.world * t.shape[0], *t.shape[1:]))

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] % self.world:
            raise ValueError(f"reduce_scatter needs dim 0 ({t.shape[0]}) divisible by {self.world}")
        return self._collective("reduce_scatter", t, (t.shape[0] // self.world, *t.shape[1:]))

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] % self.world:
            raise ValueError(f"all_to_all needs dim 0 ({t.shape[0]}) divisible by {self.world}")
        return self._collective("all_to_all", t, t.shape)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return self._collective("all_reduce", t, t.shape)


class RecordingMesh(RankMesh):
    """Rank 0's view of a mesh of ``MeshShape`` with no processes behind
    it: :class:`RecordingGroup` axes, the counts a ``RankMesh`` keeps, and
    every collective's operand and output bytes by (kind, operand bytes,
    group size). Tallies (MoE slots) are kept unread: a meta tensor holds no
    count."""

    def __init__(self, shape: MeshShape):
        coords = dict.fromkeys(shape.axis_names, 0)
        groups = {a: (RecordingGroup(self, a, coords[a], n) if n > 1 else None)
                  for a, n in zip(shape.axis_names, shape.sizes)}
        super().__init__(0, shape.sizes, shape.axis_names, groups, torch.device("meta"))
        self.records: dict = defaultdict(int)
        self.bytes_moved = 0.0  # operand + output bytes of the collectives

    def record(self, kind: str, bytes_in: int, bytes_out: int, group_size: int) -> None:
        self.records[(kind, bytes_in, group_size)] += 1
        self.bytes_moved += bytes_in + bytes_out

    def tally(self, name: str, n) -> None:
        self.tallies[name] = n

    def collective_records(self) -> list[CollectiveRecord]:
        return [CollectiveRecord(kind=k, bytes_in=b, group_size=g, count=c,
                                 wire_bytes=ring_wire_bytes(k, b, g) * c)
                for (k, b, g), c in self.records.items()]


# -- the dispatch-mode tracer ----------------------------------------------------------


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(values: tuple) -> list:
    """The tensors among an op's arguments or results (lists of tensors
    included)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


class Tracer(TorchDispatchMode):
    """FLOPs by the type of their operands, HBM bytes, and the live bytes
    of every storage created under it (peak, and what is still alive when
    read), plus the bytes of storages made before it that an op wrote in
    place (the aliases)."""

    def __init__(self):
        super().__init__()
        self.flops: dict[torch.dtype, float] = defaultdict(float)
        self.bytes_hbm = 0.0
        self.live = 0
        self.peak = 0
        self._mine: dict[int, int] = {}  # storage -> bytes, for those created here
        self._aliased: dict[int, int] = {}  # storage made before, written here

    @property
    def alias_bytes(self) -> int:
        return sum(self._aliased.values())

    def add_flops(self, dtype: torch.dtype, n: float) -> None:
        self.flops[dtype] += n

    def allocate(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live until it dies, if it is new."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._mine:
            return
        nb = st.nbytes()
        self._mine[key] = nb
        self.live += nb
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._mine.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry:  # a composite (matmul under inference mode): its parts
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(tuple(kwargs.values()))
        outs = _tensors((out,))
        if packet in flop_registry and ins:
            self.flops[ins[0].dtype] += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and packet not in _NO_BYTES:
            self.bytes_hbm += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for a, v in zip(func._schema.arguments, args):
            if isinstance(v, torch.Tensor) and a.alias_info is not None and a.alias_info.is_write:
                key = v.untyped_storage()._cdata
                if key not in self._mine:
                    self._aliased[key] = v.untyped_storage().nbytes()
        rets = out if isinstance(out, (tuple, list)) else (out,)
        for r, t in zip(func._schema.returns, rets):
            if r.alias_info is None:  # a new storage, not a view or an input written back
                for x in _tensors((t,)):
                    self.allocate(x)
        return out


@contextlib.contextmanager
def _vecdots(tracer: Tracer):
    """``torch.linalg.vecdot``'s calls under a trace, recomputed checkpoints
    included, count 2 FLOPs a multiply-add by the first operand's type."""
    vecdot = torch.linalg.vecdot

    def counted(x, y, *args, **kwargs):
        out = vecdot(x, y, *args, **kwargs)
        dim = kwargs.get("dim", args[0] if args else -1)
        tracer.add_flops(x.dtype, 2.0 * out.numel() * torch.broadcast_shapes(x.shape, y.shape)[dim])
        return out

    torch.linalg.vecdot = counted
    try:
        yield
    finally:
        torch.linalg.vecdot = vecdot


def flash_pairs(sq: int, skv: int, causal: bool, window: "int | None") -> int:
    """(q, k) pairs the flash kernel's mask leaves visible, q aligned to the
    kv tail (as the kernel aligns its causal mask and window)."""
    total = 0
    for i in range(sq):
        hi = i + (skv - sq) + 1 if causal else skv
        lo = i + (skv - sq) - window + 1 if window is not None else 0
        total += max(0, min(hi, skv) - max(lo, 0))
    return total


@contextlib.contextmanager
def _flash_stand_in(tracer: Tracer):
    """The flash kernel's calls under a trace: its output (q's shape and
    type) and ``4 D`` FLOPs a visible (q, k) pair a head; q, k and v read,
    the output written once."""
    from ..kernels.flash_attention import ops

    launch = ops.flash_attn

    def stand_in(q, k, v, *, causal=True, window=None, scale=None, block_k=128):
        bhq, sq, d = q.shape
        tracer.add_flops(q.dtype, 4.0 * d * bhq * flash_pairs(sq, k.shape[1], causal, window))
        out = torch.empty_like(q)
        tracer.bytes_hbm += _nbytes(q) + _nbytes(k) + _nbytes(v) + _nbytes(out)
        return out

    ops.flash_attn = stand_in
    try:
        yield
    finally:
        ops.flash_attn = launch


@dataclasses.dataclass
class Trace:
    """What :func:`trace` saw of one call."""

    flops: dict  # dtype name -> FLOPs
    bytes_hbm: float
    temp_peak_bytes: int  # the most the call's own storages held at once
    end_bytes: int  # the call's storages alive after it
    alias_bytes: int


def trace(fn) -> tuple:
    """``fn()`` under a :class:`Tracer` (with :func:`_vecdots` and the
    flash stand-in); returns (its result, the :class:`Trace`). The result is
    held while the trace is read, so what it returns counts as alive at the
    end."""
    tracer = Tracer()
    with _flash_stand_in(tracer), _vecdots(tracer), tracer:
        out = fn()
    return out, Trace(flops={str(k).replace("torch.", ""): v for k, v in tracer.flops.items()},
                      bytes_hbm=tracer.bytes_hbm, temp_peak_bytes=tracer.peak,
                      end_bytes=tracer.live, alias_bytes=tracer.alias_bytes)


def analyze(tr: Trace, mesh: "RecordingMesh | None" = None) -> RooflineReport:
    """The three terms of a traced rank, over the machine file's peaks:
    bf16 and fp16 FLOPs at the tensor cores' dense rate
    (``BF16_TENSOR_FLOPS``), the rest at ``Peaks.flops``."""
    peaks = default_machine().peaks
    rate = {"bfloat16": BF16_TENSOR_FLOPS, "float16": BF16_TENSOR_FLOPS}
    flops = float(sum(tr.flops.values()))
    t_c = sum(n / rate.get(dt, peaks.flops) for dt, n in tr.flops.items())
    colls = mesh.collective_records() if mesh is not None else []
    bts = tr.bytes_hbm + (mesh.bytes_moved if mesh is not None else 0.0)
    cbytes = sum(r.wire_bytes for r in colls)
    by_kind: dict[str, float] = defaultdict(float)
    for r in colls:
        by_kind[r.kind] += r.wire_bytes
    t_m = bts / peaks.hbm_bw
    t_x = cbytes / peaks.ici_bw
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_x)), key=lambda t: t[1])[0]
    top = sorted(colls, key=lambda r: -r.wire_bytes)[:12]
    return RooflineReport(
        flops=flops, bytes_hbm=bts, bytes_collective=cbytes,
        t_compute=t_c, t_memory=t_m, t_collective=t_x, dominant=dom,
        collectives=[dataclasses.asdict(r) for r in top],
        collective_counts=dict(by_kind),
    )


def model_flops(cfg, kind: str, seq_len: int, global_batch: int) -> float:
    """Analytic MODEL_FLOPS for the whole step (all chips): 6·N·D train /
    2·N·D inference, plus the attention term."""
    n = cfg.active_param_count
    if kind == "train":
        tokens = seq_len * global_batch
        base = 6.0 * n * tokens
        attn = 12.0 * cfg.num_layers * cfg.num_heads * cfg.hd * seq_len * seq_len * global_batch
        if cfg.sliding_window:
            attn *= min(1.0, cfg.sliding_window / seq_len)
        if cfg.family in ("ssm", "hybrid"):
            attn = 0.0
        return base + attn
    if kind == "prefill":
        tokens = seq_len * global_batch
        attn = 4.0 * cfg.num_layers * cfg.num_heads * cfg.hd * seq_len * seq_len * global_batch
        if cfg.sliding_window:
            attn *= min(1.0, cfg.sliding_window / seq_len)
        if cfg.family in ("ssm", "hybrid"):
            attn = 0.0
        return 2.0 * n * tokens + attn
    # decode: one token against seq_len of context
    ctx_len = seq_len if not cfg.sliding_window else min(seq_len, cfg.sliding_window)
    attn = 4.0 * cfg.num_layers * cfg.num_heads * cfg.hd * ctx_len * global_batch
    if cfg.family == "ssm":
        attn = 0.0
    return 2.0 * n * global_batch + attn
