"""The nodelet mesh: one rank process a nodelet, joined by a
``torch.distributed`` process group.

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
COLLECTIVES = ("all_gather", "all_to_all", "all_reduce")
BACKEND_RULE = (
    "nccl when the device is CUDA and torch.cuda.device_count() >= P (one card a rank), "
    "otherwise gloo (the ranks share the device)"
)

# all_gather_into_tensor was renamed all_gather_single (same signature)
_ALL_GATHER_INTO = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
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
    """The collectives of one rank, over the world group. Each returns a
    new tensor on the rank's device and adds its host seconds (staging
    copies included) to :attr:`seconds`."""

    def __init__(self, rank: int, world: int, device: torch.device, backend: str):
        self.rank, self.world, self.device, self.backend = rank, world, device, backend
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
        return self._collective(_ALL_GATHER_INTO, t, (self.world * t.shape[0], *t.shape[1:]))

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Dim 0 of ``t`` in ``world`` equal blocks, block j to rank j; the
        result holds the blocks received, in source rank order."""
        if t.shape[0] % self.world:
            raise ValueError(f"all_to_all needs dim 0 ({t.shape[0]}) divisible by {self.world}")
        return self._collective(lambda out, src: dist.all_to_all_single(out, src), t, t.shape)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise ``op`` (sum, min, max) of every rank's ``t``."""

        def reduce(out, src):
            out.copy_(src)
            dist.all_reduce(out, op=_REDUCE_OPS[op])

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
        meshes = list(_MESHES.values())
    for mesh in meshes:
        mesh.close()


atexit.register(close_meshes)
