"""The benchmark's engine: finds a cell's configuration, traffic mix, op and
metric readers by the names in ``BENCHMARK.json``, builds the inputs from the
seed, warms every shape the cell uses, drives the program for a fixed window,
and reduces what it saw to metrics, a breakdown and the correctness check.

Everything that belongs to one configuration, mix, op or metric is a file of
its own, so a later cell adds files and edits none:

- ``bench/configs/<config>.json``: sizes, strategy, the kernels it builds,
  the guarantees it states, and the limit of each number its check compares;
- ``bench/mixes/<traffic>.json``: the load, read by :func:`drive` (a closed
  loop of clients, or open-loop arrivals at a fixed rate) over the engine
  entry (``engine.run``) or the serving plane (``EngineService``);
- ``bench/ops/<op>.py`` and ``bench/reference/<op>.py``: see ``bench.ops``;
  an op whose requests may be bound by operations rather than bytes gives its
  ``Cell`` the optional ``roofline_ops(tag)`` (see :func:`roofline_percent`);
- ``bench/metrics/<metric>.py``: ``read(run) -> float | None``;
- for the CPU checks in ``bench/tests/``: ``bench/tests/tiny/<config>.json``,
  the keys a configuration's tiny copy changes, and
  ``bench/tests/faults/<op>.py``, whose ``broken(fault)`` plants each of the
  faults the check must catch under the op's timed path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import queue
import random
import threading
import time
from pathlib import Path
from typing import Any, Callable

import torch

from bench import stats
from bench.stats import Sample

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# top-level modules the timed process must never hold: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
# sampled results kept for the check, over all clients (reservoir per client)
CHECK_SAMPLES = 16
# the traced run traces the first seconds of its window (the profiler's
# events of a whole window take minutes to reduce)
TRACE_SECONDS = 10.0
REQUEST_TIMEOUT_S = 120.0


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(spec: dict, workload: str) -> "tuple[dict, dict, dict, dict]":
    """(cell entry, config entry, config file, mix file) of a workload name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    mix = json.loads((BENCH / "mixes" / f"{cell['traffic']}.json").read_text())
    return cell, cfg_entry, config, mix


def metrics_of(spec: dict, workload: str, trace: bool) -> "list[dict]":
    """The metrics a run of ``workload`` reports: end-to-end ones untraced,
    per-layer ones traced; a metric without ``workloads`` is in every cell."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def op_cell_class(op: str):
    return importlib.import_module(f"bench.ops.{op}").Cell


def metric_reader(name: str) -> Callable[["Run"], "float | None"]:
    """``bench/metrics/<name>.py``'s ``read`` (names may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def published_peak(device_name: "str | None", key: str) -> "float | None":
    """A published peak of the card from ``bench/peaks.json``:
    ``hbm_bytes_per_s`` or ``fp32_flops_per_s``; None where it has none
    (and off the card, ``device_name`` None)."""
    entry = json.loads((BENCH / "peaks.json").read_text()).get(device_name, {})
    return float(entry[key]) if key in entry else None


@dataclasses.dataclass
class Run:
    """What one run saw: the readers' input."""

    op: str
    mix: dict
    cell: Any
    samples: "list[Sample]"
    t_start: float
    setup_s: float
    bytes_of: "dict[int, int]"
    roofline_bytes_of: "dict[int, int]"
    roofline_ops_of: "dict[int, int]"  # empty where the op's Cell counts no operations
    trace: Any = None  # bench.trace.Trace of the traced run's traced part
    trace_end: "float | None" = None  # perf_counter when the traced part closed
    peak_bytes_per_s: "float | None" = None
    peak_flops_per_s: "float | None" = None  # float32, outside the tensor cores
    generator_late_ms: "float | None" = None  # open loop: p99 of submit - due


class _Reservoir:
    """A uniform sample of ``k`` of the results offered, drawn from the
    seed (Algorithm R), so the check sees requests from the whole window."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _caller(mix: dict, cell, device: torch.device):
    """(call(request) -> (result, report), the service or None) for the
    mix's path."""
    from repro_torch.engine import EngineService, run

    if mix["path"] == "engine":
        return (lambda req: run(req, iters=1, warmup=0)), None
    if mix["path"] != "service":
        raise ValueError(f"unknown path {mix['path']!r}: engine | service")
    svc = EngineService(substrate=cell.substrate, workers=int(mix["workers"]), device=device).start()

    def call(req):
        resp = svc.submit(req).result(timeout=REQUEST_TIMEOUT_S)
        return resp.result, resp.report

    return call, svc


def _warm(cell, call: Callable, clients: int) -> None:
    """Every input's first call through the engine entry (kernel load, plan,
    the op's host models), then a round of each client's own requests
    through the cell's path."""
    from repro_torch.engine import run

    for tag in range(cell.tags):
        run(cell.request(0, tag)[0], iters=1, warmup=0)
    threads = [threading.Thread(target=lambda c=c: [call(cell.request(c, i)[0]) for i in range(cell.tags)])
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _closed_loop(cell, call, clients: int, seconds: float, seed: int, tracer: "Tracer", span=None):
    """``clients`` threads, each sending its next request when the last
    returns, until the deadline; every request issued is waited for.
    ``span`` (the traced run's ``record_function``) names each call, so the
    trace tells the program's Python inside a call from the loop's own."""
    span = span or (lambda name: contextlib.nullcontext())
    per = max(1, math.ceil(CHECK_SAMPLES / clients))
    samples: "list[list[Sample]]" = [[] for _ in range(clients)]
    res = [_Reservoir(per, random.Random(f"{seed}:{c}")) for c in range(clients)]
    start = threading.Barrier(clients + 1)
    clock: dict = {}

    def client(c: int) -> None:
        start.wait()
        t_end, i = clock["t_end"], 0
        while True:
            req, tag = cell.request(c, i)
            t0 = time.perf_counter()
            if t0 >= t_end:
                return
            with span("bench.request"):
                ok, result, svc_s = _timed(call, req)
            samples[c].append(Sample(c, tag, t0, time.perf_counter(), svc_s, ok))
            if ok:
                res[c].offer((tag, result))
            i += 1

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    for t in threads:
        t.start()
    tracer.start()
    clock["t_start"] = time.perf_counter()
    clock["t_end"] = clock["t_start"] + seconds
    start.wait()
    tracer.stop_at(min(clock["t_end"], clock["t_start"] + TRACE_SECONDS))
    for t in threads:
        t.join()
    tracer.stop()
    flat = [s for lane in samples for s in lane]
    return flat, clock["t_start"], [x for r in res for x in r.items], None


def _open_loop(cell, svc, rate: float, lanes: int, seconds: float, seed: int, tracer: "Tracer"):
    """Arrivals at ``rate`` a second on one submitter thread, whatever the
    service's progress; each request timed from when it was due. The gaps
    are the same set of exponential quantiles for every seed, in a seeded
    order, so seeds change the order of arrivals and not their load.
    ``lanes`` threads each wait, in order, for every ``lanes``-th future."""
    rng = random.Random(seed)
    m = 4096
    gaps = [-math.log(1.0 - (k + 0.5) / m) / rate for k in range(m)]
    rng.shuffle(gaps)
    per = max(1, math.ceil(CHECK_SAMPLES / lanes))
    samples: "list[list[Sample]]" = [[] for _ in range(lanes)]
    res = [_Reservoir(per, random.Random(f"{seed}:{c}")) for c in range(lanes)]
    qs = [queue.SimpleQueue() for _ in range(lanes)]
    late: "list[float]" = []

    def waiter(c: int) -> None:
        while True:
            item = qs[c].get()
            if item is None:
                return
            fut, due, tag = item
            try:
                resp = fut.result(timeout=REQUEST_TIMEOUT_S)
                ok, result, svc_s = True, resp.result, resp.report.seconds
            except Exception:  # noqa: BLE001  a failed request is counted and the run goes on
                ok, result, svc_s = False, None, None
            samples[c].append(Sample(c, tag, due, time.perf_counter(), svc_s, ok))
            if ok:
                res[c].offer((tag, result))

    threads = [threading.Thread(target=waiter, args=(c,)) for c in range(lanes)]
    for t in threads:
        t.start()
    tracer.start()
    t_start = time.perf_counter()
    t_end, due, i = t_start + seconds, t_start, 0
    t_trace = t_start + TRACE_SECONDS
    while due < t_end:
        now = time.perf_counter()
        if now >= t_trace:
            tracer.stop()
        if now < due:
            time.sleep(min(due - now, 0.0005))
            continue
        req, tag = cell.request(0, i)
        fut = svc.submit(req)
        late.append(time.perf_counter() - due)
        qs[i % lanes].put((fut, due, tag))
        due += gaps[i % m]
        i += 1
    tracer.stop()
    for q in qs:
        q.put(None)
    for t in threads:
        t.join()
    flat = [s for lane in samples for s in lane]
    return flat, t_start, [x for r in res for x in r.items], stats.percentile(late, 99.0) * 1e3


def _timed(call, req):
    try:
        result, report = call(req)
        return True, result, report.seconds
    except Exception:  # noqa: BLE001  a failed request is counted and the run goes on
        return False, None, None


def drive(cell, mix: dict, seconds: float, seed: int, device: torch.device, tracer: "Tracer"):
    """Warm the cell's path, then run its mix for ``seconds``. Returns
    (samples, window start, sampled (tag, result) pairs, generator lateness)."""
    if mix["loop"] not in ("closed", "open"):
        raise ValueError(f"unknown loop {mix['loop']!r}: closed | open")
    closed = mix["loop"] == "closed"
    call, svc = _caller(mix, cell, device)
    try:
        _warm(cell, call, int(mix["clients"] if closed else mix["lanes"]))
        _sync(device)
        gc.collect()
        if not closed:
            return _open_loop(cell, svc, float(mix["rate_per_s"]), int(mix["lanes"]), seconds, seed,
                              tracer)
        span = None
        if tracer.on:
            from torch.profiler import record_function as span
        return _closed_loop(cell, call, int(mix["clients"]), seconds, seed, tracer, span)
    finally:
        if svc is not None:
            svc.stop()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_kernels(config: dict, device: torch.device) -> None:
    """Build (first run in a checkout) or find this configuration's own CUDA
    sources in the checkout's ``build/``."""
    if device.type == "cuda":
        from repro_torch.kernels.build import build

        build(tuple(config["kernels"]))


def run_cell(config: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device: torch.device, t_process: float) -> "tuple[Run, dict, list[str], int]":
    """One run of one cell. Returns (run, compared numbers, earlier lines,
    memory peak bytes); the numbers are read once the window has closed and
    the peak has been read."""
    from repro_torch.engine import CudaSubstrate

    lines = []
    t = time.perf_counter()
    build_kernels(config, device)
    t_build = time.perf_counter() - t
    t = time.perf_counter()
    cell = op_cell_class(config["op"])(config, seed, device)
    cell.substrate = CudaSubstrate(device)
    _sync(device)
    t_inputs = time.perf_counter() - t
    tracer = Tracer(trace, device)
    t = time.perf_counter()
    samples, t_start, results, late = drive(cell, mix, seconds, seed, device, tracer)
    setup_s = t_start - t_process
    lines.append(f"setup: {setup_s:.4f} s = kernels {t_build:.4f} + inputs {t_inputs:.4f} + "
                 f"warm {t_start - t:.4f} + process start {setup_s - t_build - t_inputs - (t_start - t):.4f}")
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    tr = tracer.reduce()
    tracer.prof = None
    by_tag = {tag: [] for tag in range(cell.tags)}
    for s in samples:
        if s.ok:
            by_tag[s.tag].append(s.latency_s * 1e3)
    medians = {tag: stats.percentile(v, 50.0) if v else None for tag, v in by_tag.items()}
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else None
    run = Run(op=config["op"], mix=mix, cell=cell, samples=samples, t_start=t_start, setup_s=setup_s,
              bytes_of={tag: cell.useful_bytes(tag) for tag in range(cell.tags)},
              roofline_bytes_of={tag: cell.roofline_bytes(tag) for tag in range(cell.tags)},
              roofline_ops_of={tag: cell.roofline_ops(tag) for tag in range(cell.tags)}
              if hasattr(cell, "roofline_ops") else {},
              trace=tr, trace_end=tracer.t_end, generator_late_ms=late,
              peak_bytes_per_s=published_peak(card, "hbm_bytes_per_s"),
              peak_flops_per_s=published_peak(card, "fp32_flops_per_s"))
    lines += cell.lines(medians)
    failed = sum(not s.ok for s in samples)
    numbers = dict(cell.check(results))
    numbers["failed_requests"] = float(failed)
    numbers["checked_results"] = float(len(results))
    lines.append(f"requests: {len(samples)} attempted, {failed} failed, {len(results)} checked; "
                 f"median {stats.median_ms(samples):.4f} ms, p95 {stats.p95_ms(samples):.4f} ms, "
                 f"window {stats.window_seconds(samples, t_start):.4f} s"
                 + (f", generator p99 late {late:.4f} ms" if late is not None else ""))
    return run, numbers, lines, peak


class Tracer:
    """The traced run's profiler: ``torch.profiler`` (host and card) over the
    first ``TRACE_SECONDS`` of the window, a steady part of it (every shape
    is warm), annotated ``bench.window``. Started and stopped on the thread
    that opens the window; without tracing every call does nothing."""

    def __init__(self, on: bool, device: torch.device):
        self.on, self.device = on, device
        self.prof = self.mark = None
        self.t_end: "float | None" = None

    def start(self) -> None:
        if self.on:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
            try:  # the clients run on threads of their own; an older torch records only this one
                from torch._C._profiler import _ExperimentalConfig

                config = _ExperimentalConfig(profile_all_threads=True)
            except (ImportError, TypeError):
                config = None
            self.prof = profile(activities=acts, experimental_config=config)
            self.prof.__enter__()
            self.mark = record_function("bench.window")
            self.mark.__enter__()

    def stop(self) -> None:
        """Close the traced part (once): wait for the card, end the annotation."""
        if self.prof is not None and self.t_end is None:
            _sync(self.device)
            self.mark.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.t_end = time.perf_counter()

    def stop_at(self, t: float) -> None:
        if self.prof is not None:
            time.sleep(max(0.0, t - time.perf_counter()))
            self.stop()

    def reduce(self):
        from bench.trace import reduce_profile

        return None if self.prof is None else reduce_profile(self.prof)


def limits_met(numbers: "dict[str, float]", limits: "dict[str, float]") -> bool:
    """Every compared number at or under its limit, and a result checked."""
    if numbers.get("checked_results", 0) < 1:
        return False
    return all(numbers[k] <= limits[k] for k in limits)


def forbidden_loaded() -> "list[str]":
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    import sys

    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN_MODULES))


def roofline_percent(run: Run, op: str) -> "float | None":
    """The op's bound time as a share of the device time of every operation
    the traced part ran: the same work whatever kernels implement the op.

    Each request done within the traced part is bound by the larger of its
    roofline bytes at the card's peak bandwidth and its roofline operations
    at the card's float32 peak, and the bound time is their sum. The peak
    counts 2 for each float32 lane instruction (an FMA as two FLOPs), so an
    op's ``roofline_ops`` counts 2 for every such instruction, an add, min,
    multiply or compare as well as an FMA. An op that counts no operations,
    or a card with no float32 peak, is bound by its bytes alone."""
    if run.op != op or run.trace is None or run.peak_bytes_per_s is None:
        return None
    done = [s for s in run.samples if s.ok and s.t1 <= run.trace_end]
    flops = run.peak_flops_per_s
    bound_s = sum(max(run.roofline_bytes_of[s.tag] / run.peak_bytes_per_s,
                      run.roofline_ops_of.get(s.tag, 0) / flops if flops else 0.0) for s in done)
    return 100.0 * bound_s / run.trace.device_op_s
