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
parallel capacity. The port has no mesh, so there are no collectives to
measure: their alpha-beta terms are derived from the stream rate and the
dispatch overhead, as for a one-device host.
"""
from __future__ import annotations

import argparse
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


def fit_alpha_beta(
    nbytes: Iterable[float], seconds: Iterable[float]
) -> AlphaBeta:
    """Least-squares fit of ``t = alpha + beta * n`` with both terms clamped
    nonnegative (noisy small-message timings can produce a negative
    intercept; a negative latency or bandwidth is never meaningful)."""
    n = np.asarray(list(nbytes), dtype=np.float64)
    t = np.asarray(list(seconds), dtype=np.float64)
    if n.size == 0:
        raise ValueError("fit_alpha_beta needs at least one sample")
    if n.size == 1:
        return AlphaBeta(alpha=0.0, beta=float(t[0] / max(n[0], 1.0)))
    coeffs, *_ = np.linalg.lstsq(np.stack([np.ones_like(n), n], axis=1), t, rcond=None)
    alpha, beta = float(coeffs[0]), float(coeffs[1])
    if beta < 0:  # degenerate (timings not increasing): bandwidth-only refit
        beta = float(t.sum() / max(n.sum(), 1.0))
        alpha = 0.0
    return AlphaBeta(alpha=max(0.0, alpha), beta=max(0.0, beta))


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


def calibrate(*, device: "str | torch.device" = "cuda", quick: bool = True) -> MachineProfile:
    """Run the suite on ``device`` (default the card; raises without one)
    and assemble a calibrated, fingerprinted :class:`MachineProfile`. The
    ``cuda`` substrate's entry is measured on the same device as
    ``local``'s. Does not save — callers decide the path
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
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the probes' buffers are the caller's memory again
    # one device, no mesh: the collective classes' terms are derived from
    # the memory system so predictions stay finite and honest about their
    # provenance (one dispatch of latency, a write and a read per byte)
    local = SubstrateProfile(
        stream_bw=stream, dispatch_overhead=dispatch,
        collectives={k: AlphaBeta(alpha=dispatch, beta=2.0 / stream) for k in COLLECTIVE_KINDS},
        source="measured", gather_bw=gather, scatter_bw=scatter,
    )
    return MachineProfile(
        fingerprint=machine_fingerprint(dev),
        peaks=Peaks(flops=flops, hbm_bw=stream, ici_bw=stream / 2.0),
        substrates={"local": local, "cuda": local},
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
