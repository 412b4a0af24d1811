"""STREAM-like microbenchmark suite -> machine file.

The "Microbenchmark Characterization of the Emu Chick" methodology
(arXiv:1809.07696) applied to the device the port runs on: measure what
it *sustains* — not what the data sheet promises — and write it down so
the cost models can speak seconds.

    python -m repro_torch.machine.microbench                  # the card
    python -m repro_torch.machine.microbench --device cpu     # this host's CPU
    python -m repro_torch.machine.microbench --out path.json  # pinned location

On the device it is given, with torch ops as instruments: sustained memory
bandwidth in three access classes (a sequential scale, a random-index
gather, a random-index scatter-add — the latter two are the paper's
irregular-access measurement), the dispatch overhead of a tiny op (the
per-call floor of a synchronized call), one matmul rate, and the host's
parallel capacity. The collectives (``all_gather``, ``all_to_all`` and
``psum``, an ``all_reduce`` sum) are fitted to alpha-beta models over a
nodelet mesh (:func:`measure_collectives`): an explicit one, else one rank
a card. On one card, or on the CPU, with no mesh given there is nothing to
measure across, as for the JAX package on a one-device host: the ``mesh``
entry's terms are then derived from the stream rate and the dispatch
overhead.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Iterable

import numpy as np
import torch

from ..device import resolve_device
from .machine import (
    AlphaBeta,
    MachineProfile,
    Peaks,
    SubstrateProfile,
    default_machine_path,
    machine_fingerprint,
)

# Buffer bytes per device type and mode. On the card every buffer lies well
# past the H100's 50 MB L2, so the rates are device-memory rates, not L2
# rates; on the CPU the sizes stay small so a quick calibration (the tests')
# takes seconds.
STREAM_SIZES = {
    "cpu": {"quick": (1 << 20, 4 << 20), "full": (4 << 20, 16 << 20, 64 << 20)},
    "cuda": {"quick": (512 << 20,), "full": (512 << 20, 2 << 30)},
}
# Square float32 matmul sides: on the card large enough that the launch is a
# rounding error of the time (2 * 8192**3 flops take tens of milliseconds);
# on the CPU a few milliseconds.
MATMUL_N = {"cpu": {"quick": 384, "full": 1024}, "cuda": {"quick": 8192, "full": 16384}}
COLLECTIVE_KINDS = ("all_gather", "all_to_all", "psum")
# Total message bytes (the whole gathered or exchanged array) per device type
# and mode: a message too small for its bytes to show (the latency), then
# sizes where the bytes dominate (the rate; see fit_latency_rate)
COLLECTIVE_SIZES = {
    "cpu": {"quick": (1 << 10, 1 << 16, 1 << 20, 1 << 22),
            "full": (1 << 10, 1 << 16, 1 << 20, 1 << 24)},
    "cuda": {"quick": (1 << 10, 1 << 16, 1 << 20, 1 << 24),
             "full": (1 << 10, 1 << 16, 1 << 20, 1 << 24, 1 << 27)},
}


def _median_seconds(
    fn: Callable[[], object], device: torch.device, iters: int, warmup: int = 1
) -> float:
    """Median host seconds of ``fn`` over ``iters`` calls, each ending in a
    synchronize of the card when ``device`` is one (so the time is the
    device's work plus the call, never only the enqueue)."""

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def fit_latency_rate(nbytes: Iterable[float], seconds: Iterable[float]) -> AlphaBeta:
    """``t = alpha + beta * n`` with alpha the smallest message's time (its
    bytes are within the noise) and beta the least-squares slope of the
    others through that point; both nonnegative.

    The collectives' fit. It departs from the JAX package's on purpose:
    that one fits a free intercept by least squares, and on a host where
    other work runs, gloo's large messages slow down far more than
    linearly, the intercept goes negative, and the latency is clamped to 0
    (PERF.md, the mesh findings)."""
    n = np.asarray(list(nbytes), dtype=np.float64)
    t = np.asarray(list(seconds), dtype=np.float64)
    if n.size < 2:
        raise ValueError("fit_latency_rate needs at least two sizes")
    i = int(np.argmin(n))
    dn, dt = n - n[i], t - t[i]
    beta = float((dn * dt).sum() / max(float((dn * dn).sum()), 1.0))
    return AlphaBeta(alpha=max(0.0, float(t[i])), beta=max(0.0, beta))


def measure_stream_bw(device: torch.device, sizes: "tuple[int, ...]", iters: int = 3) -> float:
    """Sustained bytes/s of a scale (``out = x * s``: reads one buffer,
    writes one, 2 touched bytes per buffer byte), max over buffer sizes —
    the STREAM number the memory term of every prediction divides by."""
    best = 0.0
    for size in sizes:
        x = torch.arange(size // 4, dtype=torch.float32, device=device)
        out = torch.empty_like(x)
        sec = _median_seconds(lambda: torch.mul(x, 1.000001, out=out), device, iters)
        best = max(best, 2.0 * size / max(sec, 1e-9))
        del x, out
    return best


def _random_access_bw(
    kernel, device: torch.device, sizes: "tuple[int, ...]", iters: int
) -> float:
    """Shared harness for the random-access probes: run ``kernel(x, idx,
    aux)`` over random int32 indices at each size (``aux`` a second buffer
    of x's shape: the gather's output, the scatter's source), charge 12
    bytes per element (4 B index read + 4 B random data touch + 4 B
    result), keep the best."""
    gen = torch.Generator(device=device).manual_seed(7)
    best = 0.0
    for size in sizes:
        n = max(1, size // 12)
        x = torch.arange(n, dtype=torch.float32, device=device)
        aux = torch.ones_like(x)
        idx = torch.randint(0, n, (n,), generator=gen, device=device, dtype=torch.int32)
        sec = _median_seconds(lambda: kernel(x, idx, aux), device, iters)
        best = max(best, 12.0 * n / max(sec, 1e-9))
        del x, aux, idx
    return best


def measure_gather_bw(device: torch.device, sizes: "tuple[int, ...]", iters: int = 3) -> float:
    """Sustained bytes/s of a random-index *gather* (``index_select``) —
    the irregular-read analogue of the stream probe. SpMV-style kernels
    (random reads, sequential writes) see this rate."""
    return _random_access_bw(
        lambda x, idx, out: torch.index_select(x, 0, idx, out=out), device, sizes, iters
    )


def measure_scatter_bw(device: torch.device, sizes: "tuple[int, ...]", iters: int = 3) -> float:
    """Sustained bytes/s of a random-index *scatter-add* (``index_add_``)
    — what frontier expansion and remote-write lowering execute: a
    scattered read-modify-write per element."""
    return _random_access_bw(
        lambda x, idx, src: x.index_add_(0, idx, src), device, sizes, iters
    )


def measure_dispatch_overhead(device: torch.device, iters: int = 30) -> float:
    """Seconds per warm call of a tiny op, synchronized — the per-call
    floor (dispatch + launch + sync) that dominates small problems and
    that every engine call pays."""
    x = torch.zeros((8,), dtype=torch.float32, device=device)
    return _median_seconds(lambda: x.add(1.0), device, iters=iters, warmup=3)


def measure_matmul_flops(device: torch.device, n: int, iters: int = 3) -> float:
    """Sustained FLOP/s of one float32 matmul — the calibrated stand-in for
    the peak-FLOPs constant."""
    a = torch.ones((n, n), dtype=torch.float32, device=device)
    out = torch.empty_like(a)
    sec = _median_seconds(lambda: torch.mm(a, a, out=out), device, iters)
    return 2.0 * n**3 / max(sec, 1e-9)


def _collective_rank(rank, world, group, *, kind: str, elems: int, iters: int) -> float:
    """A mesh body: the least seconds (this rank's host clock, staging
    included) of ``iters`` warm collectives of ``kind`` on this rank's
    ``elems // world`` float32 shard, each started with the ranks lined up
    by an untimed ``all_reduce`` (so no sample holds a wait for a late
    rank). The least: other work on a shared host only adds time."""
    x = torch.arange(elems // world, dtype=torch.float32, device=group.device)
    line_up = torch.zeros(1, device=group.device)
    call = {"all_gather": group.all_gather, "all_to_all": group.all_to_all,
            "psum": group.all_reduce}[kind]
    times = []
    for _ in range(iters + 1):
        group.all_reduce(line_up)
        before = group.seconds
        call(x)
        times.append(group.seconds - before)
    return min(times[1:])


def _noop_rank(rank, world, group) -> int:
    return rank


def measure_collectives(
    sizes: "tuple[int, ...]",
    kinds: "tuple[str, ...]" = COLLECTIVE_KINDS,
    *,
    mesh=None,
    device: "str | torch.device" = "cuda",
    iters: int = 10,
) -> dict[str, AlphaBeta]:
    """Alpha-beta models per collective over ``mesh`` (a
    :class:`~repro_torch.launch.mesh.NodeletMesh`), else over a mesh of
    one rank a card of ``device``. Empty with fewer than two cards, or on
    the CPU without a mesh (nothing to measure across). Each size is the
    whole array in bytes; a sample is the slowest rank's least time, and
    the fit :func:`fit_latency_rate`'s."""
    if mesh is None:
        dev = resolve_device(device)
        n = torch.cuda.device_count() if dev.type == "cuda" else 0
        if n < 2:
            return {}
        from ..launch.mesh import make_nodelet_mesh

        mesh = make_nodelet_mesh(n, dev)
    p = mesh.p
    out: dict[str, AlphaBeta] = {}
    for kind in kinds:
        samples = []
        for size in sizes:
            elems = max(p * p, size // 4 // (p * p) * (p * p))
            sec = max(mesh.run(_collective_rank, kind=kind, elems=elems, iters=iters))
            samples.append((elems * 4, sec))
        out[kind] = fit_latency_rate(*zip(*samples))
    return out


def measure_mesh_dispatch(mesh, iters: int = 10) -> float:
    """Median seconds of a warm mesh call that does nothing on the ranks:
    the per-call floor of the ``mesh`` substrate (shipping, the pipes, the
    caller's wait)."""
    times = []
    for _ in range(iters + 1):
        t0 = time.perf_counter()
        mesh.run(_noop_rank)
        times.append(time.perf_counter() - t0)
    times = sorted(times[1:])
    return times[len(times) // 2]


def measure_host_parallel_capacity(quick: bool = True) -> float:
    """How much the host scales two concurrent GIL-releasing workers vs one
    (2.0 = perfect). Recorded so host-bound readings on a shared host stay
    interpretable."""
    import threading

    n = 192 if quick else 384
    reps = 6 if quick else 12
    a = np.random.default_rng(0).standard_normal((n, n))

    def work():
        for _ in range(reps):
            a @ a  # numpy dot releases the GIL

    def timed(k: int) -> float:
        threads = [threading.Thread(target=work) for _ in range(k)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.perf_counter() - t0

    timed(1)  # warm the BLAS pool
    one, two = timed(1), timed(2)
    return max(1.0, 2.0 * one / max(two, 1e-9))


def calibrate(*, device: "str | torch.device" = "cuda", quick: bool = True,
              mesh=None) -> MachineProfile:
    """Run the suite on ``device`` (default the card; raises without one)
    and assemble a calibrated, fingerprinted :class:`MachineProfile`. The
    ``cuda`` substrate's entry is measured on the same device as
    ``local``'s; the ``mesh`` entry's collectives over ``mesh`` (else one
    rank a card, see :func:`measure_collectives`), derived when there is
    nothing to measure across. Does not save — callers decide the path
    (:meth:`MachineProfile.save`)."""
    dev = resolve_device(device)
    mode = "quick" if quick else "full"
    sizes = STREAM_SIZES[dev.type][mode]
    stream = measure_stream_bw(dev, sizes)
    gather = measure_gather_bw(dev, sizes)
    scatter = measure_scatter_bw(dev, sizes)
    dispatch = measure_dispatch_overhead(dev)
    flops = measure_matmul_flops(dev, MATMUL_N[dev.type][mode])
    capacity = measure_host_parallel_capacity(quick=quick)
    collectives = measure_collectives(COLLECTIVE_SIZES[dev.type][mode], mesh=mesh, device=dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the probes' buffers are the caller's memory again
    # one device: the collective classes' terms are derived from the memory
    # system so predictions stay finite and honest about their provenance
    # (one dispatch of latency, a write and a read per byte)
    derived = {k: AlphaBeta(alpha=dispatch, beta=2.0 / stream) for k in COLLECTIVE_KINDS}
    local = SubstrateProfile(
        stream_bw=stream, dispatch_overhead=dispatch, collectives=derived,
        source="measured", gather_bw=gather, scatter_bw=scatter,
    )
    if collectives:
        # the mesh's per-call floor: a warm call of a body that does nothing
        floor = measure_mesh_dispatch(mesh) if mesh is not None else collectives["all_gather"].alpha
        mesh_profile = SubstrateProfile(
            stream_bw=stream, dispatch_overhead=max(dispatch, floor), collectives=collectives,
            source="measured", gather_bw=gather, scatter_bw=scatter,
        )
        ici = max(1.0 / max(ab.beta, 1e-18) for ab in collectives.values())
    else:
        mesh_profile = dataclasses.replace(local, source="derived")
        ici = stream / 2.0
    return MachineProfile(
        fingerprint=machine_fingerprint(dev),
        peaks=Peaks(flops=flops, hbm_bw=stream, ici_bw=ici),
        substrates={"local": local, "cuda": local, "mesh": mesh_profile},
        host_parallel_capacity=capacity,
        calibrated=True,
        quick=quick,
        created=time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    )


def describe(profile: MachineProfile) -> str:
    """One line of the profile's measured rates, for logs."""
    local = profile.substrate("local")
    return (
        f"stream {local.stream_bw / 1e9:.2f} GB/s, "
        f"gather {local.access_bw('gather') / 1e9:.2f} GB/s, "
        f"scatter {local.access_bw('scatter') / 1e9:.3f} GB/s, "
        f"dispatch {local.dispatch_overhead * 1e6:.1f} us; "
        f"matmul {profile.peaks.flops / 1e12:.2f} TFLOP/s; "
        f"host capacity {profile.host_parallel_capacity:.2f}x"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="device to measure (default: cuda)")
    ap.add_argument("--full", action="store_true", help="more and larger buffers")
    ap.add_argument("--out", default=None, help="machine file path "
                    "(default: experiments/torch_machine.json)")
    args = ap.parse_args(argv)
    profile = calibrate(device=args.device, quick=not args.full)
    path = profile.save(args.out if args.out else default_machine_path())
    print(f"# machine file -> {path}")
    print(f"# fingerprint: {profile.fingerprint}")
    print(f"# {args.device}: {describe(profile)}")


if __name__ == "__main__":
    main()
