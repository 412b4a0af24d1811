"""Meshes of rank processes joined by ``torch.distributed``: the nodelet
mesh (one rank a nodelet, one axis) and the LM's N-D mesh with named axes
(:func:`make_mesh`, :class:`DeviceMesh`: one process group a line of each
axis, a rank's view of it its world group's ``mesh``). :func:`make_mesh` and
:func:`make_mesh_over` are the port's one mesh-construction site, the role
the JAX package's ``compat.py`` plays there; :func:`make_production_mesh`
describes the (16, 16) and (2, 16, 16) meshes without starting processes.

    mesh = make_nodelet_mesh(8, device="cuda")
    outs = mesh.run(_spmv_rank, sharded=(cols, vals), replicated=(x,), grain=g)

The counterpart of the JAX package's ``make_nodelet_mesh`` (a 1-D
``nodelet`` axis) together with ``shard_map``: :meth:`NodeletMesh.run`
hands rank ``r`` block ``r`` of every ``sharded`` tensor (split along dim
0, as a ``P(axis)`` spec does), every ``replicated`` value whole (``P()``)
and the static keywords, runs ``body(rank, world, group, *args, **static)``
there, and returns the ranks' results in rank order. ``group`` is the
rank's :class:`RankGroup`: the collectives the bodies call (``all_gather``,
``all_to_all``, ``all_reduce``), timed on the rank's host clock.

Bodies are module-level functions: the ranks are started with the
``spawn`` method (a fork after CUDA is initialised breaks), which pickles a
function by reference.

**Backend rule** (:func:`backend_for`, printed by :meth:`NodeletMesh.describe`):
``nccl`` when the device is CUDA and ``torch.cuda.device_count() >= P``,
one card a rank; otherwise ``gloo``. On ``gloo`` the ranks share the
caller's device: each holds its shards there, and on CUDA every collective
goes through a pinned host buffer (:data:`COLLECTIVES`, every call, stated
in the description): gloo moves CUDA tensors through the host in any case.
A failed ``init_process_group`` raises; nothing falls back to another
backend.

**Inputs** are shipped per call: CUDA tensors as CUDA IPC handles (the
ranks read the caller's memory in place, no copy), CPU tensors as
shared-memory copies. Results come back the same way; the caller's
``combine`` copies them (a ``cat``). :attr:`NodeletMesh.last_call` splits a
call into shipping (``ship_s``), the ranks' unpickling (``recv_s``), their
bodies and collectives (``body_s``, ``coll_s``), the results' way back
(``reply_s``) and the caller's overhead (everything but the slowest body).

**Failure.** The group is created with ``timeout`` seconds, and the caller
watches its ranks: a rank that dies, raises, or does not answer within the
timeout fails the call with :class:`MeshError` and closes the mesh (every
rank stopped); the next :func:`make_nodelet_mesh` starts a new one. Calls
into one mesh are serialised (a lock), as the reference's mesh is one
committed channel. :meth:`NodeletMesh.close` and interpreter exit stop the
ranks. Rendezvous is a ``FileStore`` in a temporary directory of its own,
so meshes in parallel processes never collide.
"""
from __future__ import annotations

import atexit
import dataclasses
import datetime
import itertools
import math
import os
import shutil
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import wait as _wait
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device

#: seconds a call, a rendezvous or a collective may take before it fails
DEFAULT_TIMEOUT = 120.0
#: the collectives a body can call, by their ``shard_map`` names' counterparts
COLLECTIVES = ("all_gather", "all_to_all", "all_reduce", "reduce_scatter")
BACKEND_RULE = (
    "nccl when the device is CUDA and torch.cuda.device_count() >= P (one card a rank), "
    "otherwise gloo (the ranks share the device)"
)

# all_gather_into_tensor was renamed all_gather_single (same signature)
_ALL_GATHER_INTO = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER_INTO = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


class MeshError(RuntimeError):
    """A rank died, raised, or did not answer in time; the mesh is closed."""


def _cards(device: torch.device, cards: "tuple[int, ...] | None") -> tuple[int, ...]:
    """The cards a mesh on ``device`` may spread over: ``cards``, else every
    card of the host (none off the card)."""
    if device.type != "cuda":
        return ()
    return tuple(cards) if cards is not None else tuple(range(torch.cuda.device_count()))


def backend_for(p: int, device: torch.device, cards: "tuple[int, ...] | None" = None) -> str:
    """The backend rule: ``nccl`` with one card a rank (of ``cards``, else
    of the host), else ``gloo``."""
    if device.type == "cuda" and len(_cards(device, cards)) >= p:
        return "nccl"
    return "gloo"


def staged_collectives(backend: str, device: torch.device) -> tuple[str, ...]:
    """Collectives a rank stages through a pinned host buffer: all of them
    on ``gloo`` with CUDA tensors, none otherwise."""
    return COLLECTIVES if backend == "gloo" and device.type == "cuda" else ()


# -- the rank side ------------------------------------------------------------------


class RankGroup:
    """The collectives of one rank, over the world group or over the
    process group ``pg`` (an axis of an N-D mesh; ``rank`` and ``world``
    are then the rank's place in it and its size). Each returns a new
    tensor on the rank's device and adds its host seconds (staging copies
    included) to :attr:`seconds`."""

    def __init__(self, rank: int, world: int, device: torch.device, backend: str, pg=None):
        self.rank, self.world, self.device, self.backend = rank, world, device, backend
        self.pg = pg
        self.mesh: "RankMesh | None" = None  # the world group's: the rank's N-D mesh view
        self.staged = bool(staged_collectives(backend, device))
        self.seconds = 0.0
        self.calls = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _collective(self, fn: Callable, t: torch.Tensor, out_shape) -> torch.Tensor:
        t0 = time.perf_counter()
        self._sync()
        src = t.contiguous()
        if self.staged:
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src)
            out = torch.empty(out_shape, dtype=src.dtype, pin_memory=True)
            fn(out, host)
            res = out.to(self.device)
        else:
            res = torch.empty(out_shape, dtype=src.dtype, device=src.device)
            fn(res, src)
        self._sync()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return res

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` laid end to end along dim 0 (``tiled=True``)."""
        return self._collective(lambda out, src: _ALL_GATHER_INTO(out, src, group=self.pg), t,
                                (self.world * t.shape[0], *t.shape[1:]))

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, block ``rank`` of its dim 0
        (``psum_scatter`` tiled)."""
        if t.shape[0] % self.world:
            raise ValueError(f"reduce_scatter needs dim 0 ({t.shape[0]}) divisible by {self.world}")
        return self._collective(lambda out, src: _REDUCE_SCATTER_INTO(out, src, group=self.pg), t,
                                (t.shape[0] // self.world, *t.shape[1:]))

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Dim 0 of ``t`` in ``world`` equal blocks, block j to rank j; the
        result holds the blocks received, in source rank order."""
        if t.shape[0] % self.world:
            raise ValueError(f"all_to_all needs dim 0 ({t.shape[0]}) divisible by {self.world}")
        return self._collective(lambda out, src: dist.all_to_all_single(out, src, group=self.pg),
                                t, t.shape)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise ``op`` (sum, min, max) of every rank's ``t``."""

        def reduce(out, src):
            out.copy_(src)
            dist.all_reduce(out, op=_REDUCE_OPS[op], group=self.pg)

        return self._collective(reduce, t, t.shape)


def _rank_info(rank: int, world: int, group: RankGroup) -> dict:
    """A body that reports the rank's process and its allocator's memory."""
    info = {"rank": rank, "pid": os.getpid(), "device": str(group.device)}
    if group.device.type == "cuda":
        info["reserved_bytes"] = torch.cuda.memory_reserved(group.device)
        info["max_reserved_bytes"] = torch.cuda.max_memory_reserved(group.device)
    return info


def _rank_main(rank: int, world: int, init_method: str, backend: str, device_str: str,
               timeout: float, conn) -> None:
    """A rank process: join the group, then serve calls until told to stop
    (``None``) or the caller's end of the pipe closes."""
    # the ranks are processes of one host: gloo's pairs go over loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    device = torch.device(device_str)
    if device.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.zeros(1, device=device)  # the context, before the rendezvous
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        group = RankGroup(rank, world, device, backend)
        group.all_reduce(torch.ones(1, device=device))  # every rank has joined
        conn.send(("ok", _rank_info(rank, world, group), {}))
    except Exception:  # reported to the caller, which raises
        conn.send(("error", f"rank {rank}: {traceback.format_exc()}", {}))
        return
    while True:
        try:
            conn.poll(None)
            t0 = time.perf_counter()
            msg = conn.recv()
        except (EOFError, OSError):
            break
        if msg is None:
            break
        recv_s = time.perf_counter() - t0
        try:
            body, args, static = msg
            del msg
            if device.type == "cuda":  # nccl: the caller's card to this rank's (P2P)
                args = _map_tensors(lambda t: t.to(device) if t.is_cuda else t, args)
            group.seconds, group.calls = 0.0, 0
            if device.type == "cuda":
                torch.cuda.ipc_collect()  # free results the caller has released
            t1 = time.perf_counter()
            with torch.no_grad():  # a mesh body is a forward pass
                out = body(rank, world, group, *args, **static)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            done = time.perf_counter()  # CLOCK_MONOTONIC: one clock for every process
            stats = {"recv_s": recv_s, "body_s": done - t1, "coll_s": group.seconds,
                     "coll_calls": group.calls, "done_t": done}
            reply = ("ok", out, stats)
            del args, out
        except Exception:  # reported to the caller, which raises and closes the mesh
            reply = ("error", f"rank {rank}: {traceback.format_exc()}", {})
        try:
            conn.send(reply)
        except (EOFError, OSError):
            break
        del reply
    if dist.is_initialized():
        dist.destroy_process_group()


# -- the caller side ----------------------------------------------------------------


def _map_tensors(fn: Callable[[torch.Tensor], Any], obj: Any) -> Any:
    """``obj`` with every tensor in it (through tuples, lists, dicts and
    dataclasses) replaced by ``fn(tensor)``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # a named tuple
        return type(obj)(*(_map_tensors(fn, v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(fn, v) for v in obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(fn, v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _map_tensors(fn, getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def _shared_copy(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor as a copy in shared memory (the caller's own storage is
    never moved); CUDA tensors pass as they are (shipped as IPC handles)."""
    if t.is_cuda:
        return t
    out = torch.empty(t.shape, dtype=t.dtype).share_memory_()
    return out.copy_(t)


class NodeletMesh:
    """P rank processes and their process group (module docstring)."""

    def __init__(self, p: int, device: "str | torch.device" = "cuda", *,
                 cards: "tuple[int, ...] | None" = None, timeout: float = DEFAULT_TIMEOUT):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if p < 1:
            raise ValueError(f"a nodelet mesh needs at least one rank, got {p}")
        backend = backend_for(p, dev, cards)
        self.p, self.device, self.backend, self.timeout = p, dev, backend, float(timeout)
        self.staged = staged_collectives(backend, dev)
        self.rank_devices = ([torch.device("cuda", c) for c in _cards(dev, cards)[:p]]
                             if backend == "nccl" else [dev] * p)
        self.closed = False
        self.exit_codes: list = []  # the ranks' exit codes once closed (0: a clean exit)
        self.last_call: "dict | None" = None
        self._lock = threading.Lock()
        self._dir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
        init_method = "file://" + os.path.join(self._dir, "store")
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        t0 = time.perf_counter()
        try:
            for r in range(p):
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_rank_main, name=f"nodelet-rank-{r}", daemon=True,
                    args=(r, p, init_method, backend, str(self.rank_devices[r]), self.timeout,
                          child),
                )
                proc.start()
                child.close()
                self._conns.append(parent)
                self._procs.append(proc)
            self.rank_info = [reply[1] for reply in self._collect(t0 + self.timeout)]
        except BaseException:
            self.close()
            raise
        self.ready_seconds = time.perf_counter() - t0

    # -- description -----------------------------------------------------------------

    @property
    def pids(self) -> list[int]:
        return [proc.pid for proc in self._procs]

    def describe(self) -> str:
        staged = ", ".join(self.staged) if self.staged else "none"
        where = self.rank_devices[0] if self.backend == "gloo" else "one card each"
        return (f"{self.p} ranks on {where}, backend {self.backend} (rule: {BACKEND_RULE}), "
                f"collectives staged through the host: {staged}, "
                f"launch to ready {self.ready_seconds:.2f} s")

    def memory(self) -> list[dict]:
        """Each rank's pid and (on CUDA) its allocator's reserved bytes."""
        return self.run(_rank_info)

    # -- calls -------------------------------------------------------------------------

    def _split(self, t: torch.Tensor) -> list[torch.Tensor]:
        if t.shape[0] % self.p:
            raise ValueError(f"a sharded input's dim 0 ({t.shape[0]}) must divide by "
                             f"{self.p} ranks")
        b = t.shape[0] // self.p
        return [t[r * b:(r + 1) * b] for r in range(self.p)]

    def run(self, body: Callable, sharded: tuple = (), replicated: tuple = (), **static) -> list:
        """Run ``body(rank, world, group, *shards, *replicated, **static)`` on
        every rank; the results in rank order. Raises :class:`MeshError`
        (and closes the mesh) when a rank dies, raises or times out."""
        with self._lock:
            if self.closed:
                raise MeshError("the mesh is closed; make_nodelet_mesh starts a new one")
            t0 = time.perf_counter()
            for r, proc in enumerate(self._procs):
                if not proc.is_alive():
                    self._fail(f"rank {r} (pid {proc.pid}) is dead (exit code {proc.exitcode})")
            blocks = [self._split(t) for t in sharded]
            ship = _shared_copy if self.device.type == "cpu" else (lambda t: t)
            rep = _map_tensors(ship, tuple(replicated))
            try:
                for r, conn in enumerate(self._conns):
                    args = _map_tensors(ship, tuple(b[r] for b in blocks)) + rep
                    conn.send((body, args, static))
            except OSError as e:
                self._fail(f"sending to a rank failed: {e!r}")
            del blocks, rep, args
            t1 = time.perf_counter()
            replies = self._collect(t1 + self.timeout)
            t2 = time.perf_counter()
            stats = [reply[2] for reply in replies]
            body_s = [s["body_s"] for s in stats]
            self.last_call = {
                "call_s": t2 - t0, "ship_s": t1 - t0, "recv_s": [s["recv_s"] for s in stats],
                "body_s": body_s, "coll_s": [s["coll_s"] for s in stats],
                "coll_calls": stats[0]["coll_calls"],
                "reply_s": max(s["reply_s"] for s in stats),
                "overhead_s": (t2 - t0) - max(body_s),
            }
            # nccl ranks answer from their own cards
            return [_map_tensors(lambda t: t.to(self.device), reply[1]) for reply in replies]

    def _collect(self, deadline: float) -> list:
        """One reply from every rank, or :class:`MeshError`."""
        replies: list = [None] * self.p
        pending = set(range(self.p))
        while pending:
            waits = {self._conns[r]: r for r in pending}
            sentinels = {self._procs[r].sentinel: r for r in pending}
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                self._fail(f"rank(s) {sorted(pending)} did not answer within {self.timeout} s")
            ready = _wait(list(waits) + list(sentinels), timeout=min(remaining, 1.0))
            for obj in ready:
                r = waits.get(obj)
                if r is None or r not in pending:
                    continue
                try:
                    reply = obj.recv()
                except (EOFError, OSError):
                    self._fail(f"rank {r} closed its pipe (exit code {self._procs[r].exitcode})")
                if reply[0] == "error":
                    self._fail(reply[1])
                if "done_t" in reply[2]:  # a body's end to its result unpickled here
                    reply[2]["reply_s"] = time.perf_counter() - reply[2]["done_t"]
                replies[r] = reply
                pending.discard(r)
            for obj in ready:
                r = sentinels.get(obj)
                if r is not None and r in pending and not self._conns[r].poll():
                    self._procs[r].join(1.0)
                    self._fail(f"rank {r} (pid {self._procs[r].pid}) died "
                               f"(exit code {self._procs[r].exitcode})")
        return replies

    def _fail(self, why: str) -> None:
        self.close()
        raise MeshError(f"nodelet mesh ({self.p} ranks, {self.backend}): {why}")

    # -- shutdown ------------------------------------------------------------------------

    def close(self, timeout: float = 10.0) -> None:
        """Stop every rank (asked first, then terminated, then killed) and
        remove the rendezvous directory. Idempotent."""
        if self.closed:
            return
        self.closed = True
        _forget(self)
        for conn in self._conns:
            try:
                conn.send(None)
            except OSError:
                pass
        deadline = time.perf_counter() + timeout
        for proc in self._procs:
            proc.join(max(0.0, deadline - time.perf_counter()))
        for proc in self._procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(2.0)
            if proc.is_alive():
                proc.kill()
                proc.join(2.0)
        self.exit_codes = [proc.exitcode for proc in self._procs]
        for conn in self._conns:
            conn.close()
        shutil.rmtree(self._dir, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.ipc_collect()  # the blocks shipped to the ranks are the caller's again

    def alive(self) -> list[bool]:
        return [proc.is_alive() for proc in self._procs]


# -- N-D meshes with named axes (the LM's (data, model) mesh) -------------------------


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axes and sizes, with no processes (a description, such as
    the production mesh the dry-run reads)."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


class RankMesh:
    """A rank's view of its N-D mesh: ``shape`` (axis -> size),
    ``coords`` (axis -> this rank's index) and ``group(axis)``, the
    :class:`RankGroup` of the ranks that differ from this one along that
    axis only (none for an axis of size 1). Ranks are laid out row-major,
    the last axis fastest, as a JAX mesh lays out its devices. It also
    holds what the rank keeps between calls (``resident``) and what a call
    counts besides its collectives (``tallies``, such as MoE slots)."""

    def __init__(self, rank: int, sizes: tuple, axes: tuple, groups: dict, device: torch.device):
        self.rank, self.device = rank, device
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, sizes))
        self.coords = dict(zip(axes, _unravel(rank, sizes)))
        self._groups = groups
        self.resident: dict = {}
        self.tallies: dict[str, int] = {}

    def group(self, axis: str) -> RankGroup:
        return self._groups[axis]

    def tally(self, name: str, n: "int | torch.Tensor") -> None:
        """Add ``n`` (a count, or a 0-d tensor read here) to ``name``."""
        self.tallies[name] = self.tallies.get(name, 0) + int(n)

    def reset_counts(self) -> None:
        """Zero the collective counters and the tallies."""
        self.tallies = {}
        for g in self._groups.values():
            if g is not None:
                g.seconds, g.calls = 0.0, 0

    def counts(self) -> dict:
        """Collective calls and host seconds over each axis since the last
        :meth:`reset_counts`."""
        return {a: {"calls": g.calls, "seconds": g.seconds}
                for a, g in self._groups.items() if g is not None}


def _unravel(rank: int, sizes: tuple) -> tuple[int, ...]:
    coords = []
    for n in reversed(sizes):
        coords.append(rank % n)
        rank //= n
    return tuple(reversed(coords))


def _ravel(coords: tuple, sizes: tuple) -> int:
    r = 0
    for c, n in zip(coords, sizes):
        r = r * n + c
    return r


def _init_axes(rank: int, world: int, group: RankGroup, *, sizes: tuple, axes: tuple) -> dict:
    """A rank body: one process group an axis and a line of ranks along it,
    made by every rank in the same order (``dist.new_group`` is collective),
    kept as ``group.mesh``, the rank's :class:`RankMesh`."""
    mine: dict = {}
    for ai, axis in enumerate(axes):
        mine[axis] = None
        if sizes[ai] == 1:
            continue
        others = [range(n) for j, n in enumerate(sizes) if j != ai]
        for rest in itertools.product(*others):
            line = [_ravel(rest[:ai] + (c,) + rest[ai:], sizes) for c in range(sizes[ai])]
            pg = dist.new_group(line)
            if rank in line:
                mine[axis] = RankGroup(line.index(rank), sizes[ai], group.device, group.backend, pg)
    group.mesh = RankMesh(rank, sizes, axes, mine, group.device)
    return dict(group.mesh.coords)


class DeviceMesh:
    """An N-D mesh of rank processes with named axes: ``prod(shape)`` ranks
    of a :class:`NodeletMesh` (its backend rule, shipping and failure
    contract), and in each rank a :class:`RankMesh` with one process group a
    line of every axis. :meth:`run` is ``shard_map``'s counterpart: every
    rank runs ``body(rank, world, group, *replicated, **static)`` and reads
    its coordinates and axis groups from ``group.mesh`` (a :class:`RankMesh`)."""

    def __init__(self, shape, axes, device: "str | torch.device" = "cuda", *,
                 cards: "tuple[int, ...] | None" = None, timeout: float = DEFAULT_TIMEOUT):
        sizes, axes = tuple(int(n) for n in shape), tuple(axes)
        if len(sizes) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"a mesh needs one distinct name a dim: shape {sizes}, axes {axes}")
        t0 = time.perf_counter()
        self.axis_names, self.sizes = axes, sizes
        self.shape = dict(zip(axes, sizes))
        self.size = math.prod(sizes)
        self.nodes = NodeletMesh(self.size, device, cards=cards, timeout=timeout)
        self.device, self.backend = self.nodes.device, self.nodes.backend
        self.coords = self.nodes.run(_init_axes, sizes=sizes, axes=axes)
        self.ready_seconds = time.perf_counter() - t0
        with _MESHES_LOCK:
            _DEVICE_MESHES.append(self)

    @property
    def exit_codes(self) -> list:
        """The ranks' exit codes once closed (0: a clean exit)."""
        return self.nodes.exit_codes

    def run(self, body: Callable, replicated: tuple = (), **static) -> list:
        """``body`` on every rank, its results in rank order (raises
        :class:`MeshError` and closes the mesh when a rank fails)."""
        return self.nodes.run(body, (), replicated, **static)

    def memory(self) -> list[dict]:
        return self.nodes.memory()

    def describe(self) -> str:
        axes = " x ".join(f"{a} {n}" for a, n in self.shape.items())
        return f"mesh ({axes}): {self.nodes.describe()}"

    def close(self, timeout: float = 10.0) -> None:
        self.nodes.close(timeout)


def make_mesh(shape, axes, device: "str | torch.device" = "cuda", *,
              cards: "tuple[int, ...] | None" = None,
              timeout: float = DEFAULT_TIMEOUT) -> DeviceMesh:
    """The port's one mesh-construction site: ``prod(shape)`` rank processes
    with named axes (one card a rank under nccl when the host has enough,
    else gloo ranks sharing ``device``)."""
    return DeviceMesh(shape, axes, device, cards=cards, timeout=timeout)


def make_mesh_over(devices, axes, *, timeout: float = DEFAULT_TIMEOUT) -> DeviceMesh:
    """A 1-D mesh over an explicit device list (a placement window): one
    rank a device, on those cards (nccl) or on the CPU (gloo)."""
    devs = [torch.device(d) if not isinstance(d, int) else torch.device("cuda", d) for d in devices]
    axes = tuple(axes)
    if len(axes) != 1:
        raise ValueError(f"make_mesh_over builds a 1-D mesh, got axes {axes}")
    if {d.type for d in devs} != {devs[0].type}:
        raise ValueError(f"devices of one type, got {devs}")
    if devs[0].type == "cuda":
        cards = tuple(d.index if d.index is not None else 0 for d in devs)
        return DeviceMesh((len(devs),), axes, torch.device("cuda", cards[0]), cards=cards,
                          timeout=timeout)
    return DeviceMesh((len(devs),), axes, devs[0], timeout=timeout)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod (a
    description: no processes start)."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def make_host_mesh(n: "int | None" = None, device: "str | torch.device" = "cuda", *,
                   timeout: float = DEFAULT_TIMEOUT) -> DeviceMesh:
    """Whatever this host offers, as a 1-D ``data`` mesh: one rank a card
    (nccl) by default, or ``n`` ranks (gloo when the cards are fewer, or on
    the CPU; one rank there by default)."""
    dev = resolve_device(device)
    if n is None:
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return DeviceMesh((n,), ("data",), dev, timeout=timeout)


_DEVICE_MESHES: "list[DeviceMesh]" = []


# -- the process's meshes -------------------------------------------------------------

_MESHES: "dict[tuple, NodeletMesh]" = {}
_MESHES_LOCK = threading.RLock()


def _forget(mesh: NodeletMesh) -> None:
    with _MESHES_LOCK:
        for key, m in list(_MESHES.items()):
            if m is mesh:
                del _MESHES[key]


def make_nodelet_mesh(p: int = 8, device: "str | torch.device" = "cuda", *,
                      cards: "tuple[int, ...] | None" = None,
                      timeout: float = DEFAULT_TIMEOUT) -> NodeletMesh:
    """The process's mesh of ``p`` ranks on ``device`` (8 = one Chick node),
    started on first use and reused while it lives: one a ``(p, device,
    backend, cards)``, the backend by :func:`backend_for`. ``cards``
    narrows the cards an nccl mesh may take (a placement window)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cards = _cards(dev, cards)
    key = (p, str(dev), backend_for(p, dev, cards), cards)
    with _MESHES_LOCK:
        mesh = _MESHES.get(key)
        if mesh is None or mesh.closed:
            mesh = _MESHES[key] = NodeletMesh(p, dev, cards=cards, timeout=timeout)
        return mesh


def close_meshes() -> None:
    """Close every mesh this process started."""
    with _MESHES_LOCK:
        meshes = list(_MESHES.values()) + [m.nodes for m in _DEVICE_MESHES]
        _DEVICE_MESHES.clear()
    for mesh in meshes:
        mesh.close()


atexit.register(close_meshes)
