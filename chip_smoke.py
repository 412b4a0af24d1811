#!/usr/bin/env python3
"""On-card check of the PyTorch port's main path (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit; exits non-zero, printing no
result, without them or outside a checkout of the repository. In order:

1. builds the four CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
   source, all at once);
2. builds the paper's inputs on the card: SpMV on ``laplacian_2d(2048)``
   (4,194,304 rows, P=8), BFS on ``erdos_renyi_edges(20, 16)`` (2^20
   vertices, P=8, root 0), GSANA on ``generate_alignment_pair(131072)`` with
   a 64x64 grid (36,864 PAIR tasks, k=4);
3. drives the main path through ``engine.run(Request(..., "cuda"))``: SpMV
   with x replicated and striped, BFS with both comm strategies, GSANA with
   the HCB and BLK layouts, each with the kernels' launch counts set to 0
   just before and read just after, and checks the results (SpMV against
   the CSR reference, BFS parents validated, GSANA against the ``local``
   substrate);
4. autotunes on the card (phase "autotune + calibration (cuda)"): ranks
   SpMV and BFS (probes of the top 3) and GSANA (a probe of the top 1) on
   the same inputs with the uncalibrated profile, runs ``strategy="auto"``
   for each (a plan-cache hit, launches counted, results checked as in 3),
   sweeps the cuda kernels' grains (``CUDA_BLOCK_CANDIDATES``: request
   seconds and kernel milliseconds), calibrates the card into a temporary
   machine file, ranks again under it and prints each pick's predicted
   against measured seconds (``model_error``);
5. serves the dense LM at the full width of llama3.2-3b (28 layers, bf16,
   random weights from seed 0) through ``lm_serve`` with ``attn_impl="flash"``:
   4 prompts of 2048 tokens, 32 greedy tokens, the flash kernel's launch
   count set to 0 just before and checked to be 28 (one prefill) just after;
   then holds the flash prefill's logits against the reference attention
   branch on the same weights, and 4 teacher-forced decode steps after each;
6. holds the ``cuda`` substrate against the ``local`` one on small inputs;
7. profiles one request of each op, one LM prefill and one decode step
   (device busy time against wall time, kernel count, top kernels);
8. holds every kernel against its plain PyTorch version at the main path's
   shapes and times kernel, plain version and a one-call PyTorch yardstick
   with CUDA events, beside the least time the card could take (bound),
   the share of it reached and the rate (GB/s where bytes bound the
   kernel, TFLOP/s where operations do); bfs_expand in every round of the
   main path's BFS, on the graph's (P, V_p, K) planes as ``bfs_cuda`` hands
   them over, with its occupancy at the main path's grain and the sums of
   the round times and bounds; flash attention on layer 0's q, k,
   v captured from the prefill, at the bf16 kernel's k tile, and on small
   float32 cases of every mask kind; topk_sim also at a 32x32 grid, whose
   buckets (past 64 slots) take its wide instance; and counts the tensor-core
   instructions (``cuobjdump -sass``) in the built flash_attn library.

Prints RunReport rows, then a ``{"kernels": [...]}`` line, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32
# outside the tensor cores, bf16 dense on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
SPMV_RTOL = SPMV_ATOL = 1e-5  # fp32 sums in another order than the plain version
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN, LM_TEACHER_STEPS = "llama3.2-3b", 4, 2048, 32, 4
# flash vs reference attention through 28 bf16 layers, on the logits (whose
# largest magnitude is 5 to 6 here): the flash branch rounds p to bf16
# before PV and the reference does not, each bf16 rounding is 2**-8
# relative, and every later layer carries the difference on. On an H100 the
# two differed by 0.16 to 0.22; an error in either branch (a mask, a head
# map, a position) moves logits by whole units
LM_LOGIT_ATOL = 0.5
# the flash kernel against its plain version at the same k blocks
# (KERNEL_BLOCK_K in bf16): the output rounds to bf16, one ulp is 2**-8
# relative
FLASH_BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
FLASH_F32_TOL = dict(rtol=1e-5, atol=1e-5)  # float32 sums in another order


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float, peak_ops: float = PEAK_FP32_PER_S) -> tuple[float, str]:
    """(least milliseconds, what bounds it) for work that must move
    ``n_bytes`` and do ``n_ops`` operations at ``peak_ops`` per second."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


class Smoke:
    """Runs the phases in order, records failures, keeps going where a phase
    does not depend on a failed one."""

    def __init__(self):
        self.failures: list[str] = []
        self.kernels: list[dict] = []

    def phase(self, name, fn, *args):
        t0 = time.perf_counter()
        print(f"== {name}", flush=True)
        try:
            out = fn(*args)
        except Exception:  # a failed phase is reported and fails the run at the end
            traceback.print_exc()
            self.failures.append(name)
            print(f"== {name}: FAILED after {time.perf_counter() - t0:.1f} s", flush=True)
            return None
        print(f"== {name}: ok in {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    def check(self, cond: bool, what: str) -> None:
        if not cond:
            raise AssertionError(what)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; run it on a machine with the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    smoke = Smoke()
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    def build_all():
        for name, log in build.build().items():
            for line in log.splitlines():
                if "registers" in line or "bytes smem" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        return True

    if smoke.phase("build kernels (nvcc, in parallel)", build_all) is None:
        return finish(smoke)
    inputs = smoke.phase("build inputs on the card", make_inputs, dev)
    if inputs is None:
        return finish(smoke)
    launches = smoke.phase("main path through engine.run on the cuda substrate",
                           main_path, smoke, inputs)
    smoke.phase("autotune + calibration (cuda)", autotune_path, smoke, inputs)
    lm = smoke.phase(f"LM serve ({LM_ARCH}, flash)", lm_serve_path, smoke, dev)
    if lm is not None:
        smoke.phase("LM flash prefill and decode vs the reference attention branch",
                    lm_vs_reference, smoke, lm)
    smoke.phase("cuda vs local substrate on small inputs", small_agreement, smoke, dev)
    smoke.phase("device time per request (torch.profiler)", profile_requests, inputs, lm)
    if launches is not None:
        smoke.phase("kernels vs plain versions, timed", kernels_vs_plain, smoke, inputs, launches)
    if lm is not None:
        smoke.phase("flash_attn vs plain version, timed", flash_vs_plain, smoke, lm)
    return finish(smoke)


def make_inputs(dev):
    from repro_torch.core import bucketize, generate_alignment_pair, partition_ell, pick_grid
    from repro_torch.engine import BFSInputs, GSANAInputs, SpMVInputs
    from repro_torch.sparse import edges_to_csr, erdos_renyi_edges, laplacian_2d, partition_graph

    t0 = time.perf_counter()
    a = laplacian_2d(2048, device=dev)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(a.n_cols).astype(np.float32),
                        device=dev)
    spmv_in = SpMVInputs(partition_ell(a, 8, device=dev), x)
    print(f"  spmv: {a.n_rows} rows, {a.nnz} nnz, ELL {tuple(spmv_in.a.cols.shape)} "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n_v = 1 << 20
    edges = erdos_renyi_edges(20, 16)
    t1 = time.perf_counter()
    csr = edges_to_csr(edges, n_v, device=dev)
    t2 = time.perf_counter()
    g = partition_graph(csr, 8, device=dev)
    print(f"  bfs: {n_v} vertices, {g.n_edges} adjacency entries, adj {tuple(g.adj.shape)} "
          f"({t1 - t0:.1f} s edges, {t2 - t1:.1f} s CSR, {time.perf_counter() - t2:.1f} s partition)")
    t0 = time.perf_counter()
    n = 131072
    vs1, vs2, pi = generate_alignment_pair(n, device=dev)
    grid = pick_grid(n, 32)
    cap = max(bucketize(vs1, grid, device=dev).cap, bucketize(vs2, grid, device=dev).cap)
    gsana_in = GSANAInputs(vs1, vs2, bucketize(vs1, grid, cap=cap, device=dev),
                           bucketize(vs2, grid, cap=cap, device=dev), k=4, ground_truth=pi)
    print(f"  gsana: n={n}, grid {grid}x{grid}, cap {cap}, {grid * grid * 9} PAIR tasks "
          f"({time.perf_counter() - t0:.1f} s)")
    return {"csr": a, "spmv": spmv_in, "bfs": BFSInputs(g, 0), "gsana": gsana_in}


def counted(kernel_fn, body):
    """Run ``body`` with ``kernel_fn``'s launch count set to 0; return
    (body's result, launches it made)."""
    kernel_fn.launches = 0
    out = body()
    return out, kernel_fn.launches


def main_path(smoke: Smoke, inputs: dict) -> dict:
    from repro_torch.core import Comm, Layout, MigratoryStrategy, Scheme, gather_result
    from repro_torch.core import validate_parents
    from repro_torch.engine import CudaSubstrate, LocalSubstrate, Request, run
    from repro_torch.kernels.bfs.kernel import bfs_expand
    from repro_torch.kernels.spmv.kernel import spmv_ell
    from repro_torch.kernels.topk_sim.kernel import topk_sim
    from repro_torch.sparse import spmv_csr_ref

    dev = inputs["spmv"].x.device
    sub = CudaSubstrate(dev)
    launches = {}

    def show(report):
        print("report " + report.to_json(), flush=True)

    def spmv_path():
        results = []
        for rep in (True, False):
            y, report = run(Request("spmv", inputs["spmv"], MigratoryStrategy(replicate_x=rep), sub))
            show(report)
            results.append(y)
        return results

    ys, launches["spmv_ell"] = counted(spmv_ell, spmv_path)
    want = spmv_csr_ref(inputs["csr"], inputs["spmv"].x)
    for y in ys:
        got = gather_result(y, inputs["csr"].n_rows)
        err = (got - want).abs()
        smoke.check(bool((err <= SPMV_ATOL + SPMV_RTOL * want.abs()).all()),
                    f"spmv disagrees with the CSR reference: max abs err {float(err.max())}")

    def bfs_path():
        results = []
        for comm in (Comm.REMOTE_WRITE, Comm.MIGRATE):
            parents, report = run(Request("bfs", inputs["bfs"], MigratoryStrategy(comm=comm), sub))
            show(report)
            results.append(parents)
        return results

    parents, launches["bfs_expand"] = counted(bfs_expand, bfs_path)
    smoke.check(torch.equal(parents[0], parents[1]), "bfs: the two comm strategies disagree")
    smoke.check(validate_parents(inputs["bfs"].g, 0, parents[0]), "bfs: invalid parent tree")

    def gsana_path():
        results = []
        for layout in (Layout.HCB, Layout.BLK):
            st = MigratoryStrategy(layout=layout, scheme=Scheme.PAIR)
            result, report = run(Request("gsana", inputs["gsana"], st, sub))
            show(report)
            results.append((result, report))
        return results

    results, launches["topk_sim"] = counted(topk_sim, gsana_path)
    (cand, score), report = results[0]
    n = inputs["gsana"].vs2.n
    smoke.check(tuple(cand.shape) == (n, 4) and tuple(score.shape) == (n, 4), "gsana: shape")
    smoke.check(bool(torch.isfinite(score).all()), "gsana: non-finite scores")
    smoke.check(torch.equal(cand, results[1][0][0]), "gsana: HCB and BLK disagree")
    # the plain-torch oracle at the same size: equal candidates. (Recall is
    # about 0.79 here, not above 0.9 as at small n: the generator's position
    # noise is fixed while a 64x64 grid's buckets shrink, so about a fifth of
    # the true partners land outside the 3x3 bucket window.)
    (c_local, s_local), _ = run(Request("gsana", inputs["gsana"], None, LocalSubstrate(dev)),
                                iters=1, warmup=0)
    smoke.check(torch.equal(cand, c_local), "gsana: cuda and local candidates differ")
    torch.testing.assert_close(score, s_local, rtol=0, atol=1e-6)
    print(f"  gsana recall@4: {report.metrics['recall_at_k']}")
    print(f"  main-path launches: {launches}")
    for name, count in launches.items():
        smoke.check(count > 0, f"kernel {name} was never launched on the main path")
    return launches


def bfs_frontiers(g) -> list:
    """The frontier mask of every round of a BFS from vertex 0 on the
    graph's planes, recorded through the plain expansion round."""
    from repro_torch.core.bfs import bfs_rounds
    from repro_torch.kernels.bfs.kernel import bfs_expand_plain

    n_pad = g.P * g.v_per_nodelet
    frontiers = []

    def record(adj_, frontier):
        frontiers.append(frontier.clone())
        return bfs_expand_plain(adj_, frontier)

    bfs_rounds(g.adj, 0, n_pad, record, n_pad)
    return frontiers


def autotune_path(smoke: Smoke, inputs: dict) -> None:
    """``autotune`` and ``strategy="auto"`` on the card, the grain sweep, and
    the calibration plane: predicted against measured seconds per op."""
    import os
    import tempfile

    from repro_torch.core import MigratoryStrategy, gather_result, validate_parents
    from repro_torch.core.cost import cost_model_for
    from repro_torch.engine import (
        CUDA_BLOCK_CANDIDATES, CudaSubstrate, Request, autotune, rank_strategies, run,
        strategy_dict,
    )
    from repro_torch.kernels.bfs.kernel import bfs_expand
    from repro_torch.kernels.spmv.kernel import spmv_ell
    from repro_torch.kernels.topk_sim.kernel import topk_sim
    from repro_torch.machine import PerformanceModel, calibrate, reset_default_machine_cache
    from repro_torch.machine.microbench import describe
    from repro_torch.sparse import spmv_csr_ref

    dev = inputs["spmv"].x.device
    sub = CudaSubstrate(dev)
    kernels = {"spmv": spmv_ell, "bfs": bfs_expand, "gsana": topk_sim}
    probes = {"spmv": 3, "bfs": 3, "gsana": 1}  # gsana: its rank 1 is PAIR, the kernel's scheme
    want_y = spmv_csr_ref(inputs["csr"], inputs["spmv"].x)

    def check_result(op, result):
        if op == "spmv":
            got = gather_result(result, inputs["csr"].n_rows)
            err = (got - want_y).abs()
            smoke.check(bool((err <= SPMV_ATOL + SPMV_RTOL * want_y.abs()).all()),
                        f"auto spmv disagrees with the CSR reference: max abs err {float(err.max())}")
        elif op == "bfs":
            smoke.check(validate_parents(inputs["bfs"].g, 0, result), "auto bfs: invalid parent tree")
        else:
            cand, score = result
            n = inputs["gsana"].vs2.n
            smoke.check(tuple(cand.shape) == (n, 4) and bool(torch.isfinite(score).all()),
                        "auto gsana: shape or non-finite scores")
            (want_c, _), _ = run(Request("gsana", inputs["gsana"], MigratoryStrategy(), sub),
                                 iters=1, warmup=0)
            smoke.check(torch.equal(cand, want_c), "auto gsana differs from the main path's PAIR run")

    def strategy_of(st) -> str:
        return "/".join(str(v) for v in st.cache_key())

    old_env = {k: os.environ.get(k) for k in ("REPRO_TORCH_MACHINE_PATH", "REPRO_TORCH_PROBES_PATH")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_machine_") as tmp:
        try:
            # the uncalibrated profile first: no machine file anywhere
            os.environ["REPRO_TORCH_MACHINE_PATH"] = os.path.join(tmp, "absent.json")
            os.environ["REPRO_TORCH_PROBES_PATH"] = os.path.join(tmp, "probes.json")
            reset_default_machine_cache()
            for op in ("spmv", "bfs", "gsana"):
                t0 = time.perf_counter()
                cost_model_for(op, inputs[op])
                model_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                tuned = autotune(op, inputs[op], sub, probe_top_k=probes[op])
                rows = tuned.table()
                print(f"  autotune {op}: {len(rows)} candidates ranked by {tuned.ranked_by}, "
                      f"cost model {model_s:.2f} s (host, numpy), autotune with probes "
                      f"{time.perf_counter() - t0:.2f} s; best {strategy_of(tuned.best)}", flush=True)
                for row, cand in zip(rows, tuned.candidates):
                    if row["rank"] <= 6 or cand.probe is not None:
                        probe = f"{cand.probe.seconds * 1e3:.4f} ms" if cand.probe else "-"
                        print(f"    rank {row['rank']}: {strategy_of(cand.estimate.strategy)} "
                              f"traffic_bytes {row['traffic_bytes']} balance_penalty "
                              f"{row['balance_penalty']} probe {probe}", flush=True)
                smoke.check(rows[0]["probe_seconds"] > 0, f"autotune {op}: rank 1 was not probed")
                (result, report), n_launch = counted(
                    kernels[op], lambda op=op: run(Request(op, inputs[op], "auto", sub)))
                print(f"  auto {op}: {strategy_of(tuned.candidates[0].estimate.strategy)}, "
                      f"seconds {report.seconds * 1e3:.4f} ms, cache_hit {report.cache_hit}, "
                      f"{kernels[op].__name__} launches {n_launch}", flush=True)
                smoke.check(report.cache_hit, f"auto {op}: not a plan-cache hit after the probes")
                smoke.check(n_launch > 0, f"auto {op}: {kernels[op].__name__} never launched")
                smoke.check(report.strategy == strategy_dict(tuned.candidates[0].estimate.strategy),
                            f"auto {op} ran another strategy than rank 1")
                check_result(op, result)

            grain_sweep(smoke, inputs, sub, CUDA_BLOCK_CANDIDATES)

            t0 = time.perf_counter()
            profile = calibrate(device=dev)
            path = profile.save(os.path.join(tmp, "machine.json"))
            print(f"  calibrate(device={str(dev)!r}) in {time.perf_counter() - t0:.1f} s: "
                  f"{describe(profile)}", flush=True)
            print(f"  fingerprint {json.dumps(profile.fingerprint)}", flush=True)
            local = profile.substrate("cuda")
            rates = [local.stream_bw, local.gather_bw, local.scatter_bw, local.dispatch_overhead,
                     profile.peaks.flops]
            smoke.check(all(np.isfinite(v) and v > 0 for v in rates), f"calibrate: rates {rates}")
            smoke.check(profile.fingerprint["backend"] == "cuda" and torch.cuda.get_device_name(0)
                        in profile.fingerprint["device_kinds"], "calibrate: fingerprint misses the card")

            os.environ["REPRO_TORCH_MACHINE_PATH"] = str(path)
            reset_default_machine_cache()
            model = PerformanceModel(profile)
            for op in ("spmv", "bfs", "gsana"):
                ranked = rank_strategies(op, inputs[op], substrate=sub, machine=profile)
                top = ", ".join(f"{strategy_of(e.strategy)} {e.predicted_seconds * 1e3:.4f} ms"
                                for e in ranked[:3])
                print(f"  calibrated ranking {op}: {top}", flush=True)
                _, report = run(Request(op, inputs[op], "auto", sub))
                smoke.check(report.predicted_seconds is not None, f"calibrated auto {op}: no prediction")
                parts = model.predict_parts(ranked[0], "cuda", bytes_moved=report.bytes_moved)
                print("  model " + json.dumps({
                    "op": op, "strategy": strategy_of(ranked[0].strategy),
                    "predicted_ms": report.predicted_seconds * 1e3, "seconds_ms": report.seconds * 1e3,
                    "model_error": report.model_error,
                    "parts_ms": {k: v * 1e3 for k, v in parts.items()}}), flush=True)
                smoke.check(report.strategy == strategy_dict(ranked[0].strategy),
                            f"calibrated auto {op} ran another strategy than rank 1")
        finally:
            for k, v in old_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            reset_default_machine_cache()


def grain_sweep(smoke: Smoke, inputs: dict, sub, grains) -> None:
    """The main path's strategy at every grain of the cuda candidate set:
    the request's seconds and the kernel's own time at that grain (SpMV one
    launch, BFS the sum over the rounds of the main path's BFS)."""
    from repro_torch.core import MigratoryStrategy, validate_parents
    from repro_torch.engine import Request, run
    from repro_torch.kernels.bfs.kernel import bfs_expand, bfs_expand_occupancy
    from repro_torch.kernels.spmv.kernel import spmv_ell

    a = inputs["spmv"].a
    p, rp, k = a.cols.shape
    cols, vals, x = a.cols.reshape(p * rp, k), a.vals.reshape(p * rp, k), inputs["spmv"].x
    g = inputs["bfs"].g
    n_pad = g.P * g.v_per_nodelet
    frontiers = bfs_frontiers(g)
    for grain in grains:
        st = MigratoryStrategy(grain=grain)
        block = max(1, min(st.dynamic_grain(rp), p * rp))
        _, report = run(Request("spmv", inputs["spmv"], st, sub))
        ms = time_ms(lambda: spmv_ell(cols, vals, x, block_rows=block), 50)
        print(f"  sweep spmv grain {grain} (block {block}, {-(-p * rp // block)} CTAs): seconds "
              f"{report.seconds * 1e3:.4f} ms, spmv_ell {ms:.4f} ms", flush=True)
        block = max(1, min(st.dynamic_grain(n_pad), n_pad))
        parents, report = run(Request("bfs", inputs["bfs"], st, sub))
        smoke.check(validate_parents(g, 0, parents), f"sweep bfs grain {grain}: invalid tree")
        rounds = [time_ms(lambda f=f: bfs_expand(g.adj, f, block_rows=block), 20) for f in frontiers]
        shape = bfs_expand_occupancy(block)
        print(f"  sweep bfs grain {grain} (block {block}, {-(-n_pad // block)} CTAs of "
              f"{shape['threads_per_block']} threads, {shape['blocks_per_sm']} an SM): seconds "
              f"{report.seconds * 1e3:.4f} ms, bfs_expand {sum(rounds):.4f} ms over "
              f"{len(rounds)} rounds (largest {max(rounds):.4f} ms)", flush=True)


def lm_serve_path(smoke: Smoke, dev) -> dict:
    """The LM's main path: ``lm_serve`` at the full width of the arch, flash
    attention at prefill. A short warm-up serve first (cuBLAS, the kernel's
    library) captures layer 0's attention inputs for the kernel check."""
    import dataclasses

    import repro_torch.models.layers as layers
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attn
    from repro_torch.launch.serve import lm_serve
    from repro_torch.models import api

    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="flash")
    t0 = time.perf_counter()
    model = api.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {sum(p.numel() for p in model.parameters())} weights in {cfg.dtype}, "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(1).integers(1, cfg.vocab_size, (LM_BATCH, LM_PROMPT))

    captured = []
    flash_attention = layers.flash_attention

    def capture(q, k, v, **kw):
        if not captured:
            captured.append((q, k, v))
        return flash_attention(q, k, v, **kw)

    layers.flash_attention = capture
    try:
        lm_serve(cfg, model, prompts, 2, dev)
    finally:
        layers.flash_attention = flash_attention

    torch.cuda.reset_peak_memory_stats(dev)
    res, launches = counted(flash_attn, lambda: lm_serve(cfg, model, prompts, LM_GEN, dev))
    toks = res.tokens
    smoke.check(tuple(toks.shape) == (LM_BATCH, LM_GEN), f"lm_serve: token shape {tuple(toks.shape)}")
    smoke.check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "lm_serve: token ids out of range")
    steps = LM_GEN - 1
    stats = {
        "arch": cfg.name, "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
        "prefill_ms": res.prefill_seconds * 1e3,
        "prefill_tok_s": LM_BATCH * LM_PROMPT / res.prefill_seconds,
        "decode_ms_per_step": res.decode_seconds * 1e3 / steps,
        "decode_tok_s": LM_BATCH * steps / res.decode_seconds,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "flash_attn_launches": launches,
    }
    print("  lm " + json.dumps(stats), flush=True)
    print(f"  sample token ids: {toks[0, :16].tolist()}")
    smoke.check(launches == cfg.num_layers,
                f"flash_attn launched {launches} times in one prefill, want {cfg.num_layers}")
    return {"cfg": cfg, "model": model, "prompts": prompts, "launches": launches,
            "qkv": captured[0]}


def lm_vs_reference(smoke: Smoke, lm: dict) -> None:
    """The flash prefill against the reference attention branch (q-chunked
    plain PyTorch) on the same weights, then teacher-forced decode steps:
    the same tokens into both caches. Free-running greedy tokens are not
    compared: random weights give near-tied logits."""
    import dataclasses

    from repro_torch.models import Ctx, api

    cfg, model = lm["cfg"], lm["model"]
    dev = model.embed.device
    tokens = torch.as_tensor(lm["prompts"], device=dev)
    ctx_f, ctx_r = Ctx(cfg), Ctx(dataclasses.replace(cfg, attn_impl="reference"))
    max_len = LM_PROMPT + LM_TEACHER_STEPS
    lf, cf = api.prefill(ctx_f, model, tokens, max_len)
    t0 = time.perf_counter()
    lr, cr = api.prefill(ctx_r, model, tokens, max_len)
    torch.cuda.synchronize()
    print(f"  reference-branch prefill: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    print(f"  KV caches after prefill, max abs diff: k {float((cf.k - cr.k).abs().max())}, "
          f"v {float((cf.v - cr.v).abs().max())}")

    def compare(what, a, b):
        a, b = a.float(), b.float()
        smoke.check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()), f"{what}: non-finite logits")
        err = float((a - b).abs().max())
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        print(f"  {what}: max abs diff {err} (largest |logit| {float(b.abs().max())}; "
              f"argmax agrees on {agree:.2f} of rows)")
        smoke.check(err <= LM_LOGIT_ATOL, f"{what}: flash and reference logits differ by {err}")

    compare("prefill last-token logits", lf, lr)
    for i, tok in enumerate(np.random.default_rng(2).integers(1, cfg.vocab_size, (LM_TEACHER_STEPS, LM_BATCH, 1))):
        t = torch.as_tensor(tok, device=dev)
        lf, cf = api.decode_step(ctx_f, model, t, cf)
        lr, cr = api.decode_step(ctx_r, model, t, cr)
        compare(f"teacher-forced decode step {i}", lf, lr)


def small_agreement(smoke: Smoke, dev) -> None:
    from repro_torch.core import Comm, MigratoryStrategy, bucketize, generate_alignment_pair
    from repro_torch.core import partition_ell, pick_grid
    from repro_torch.engine import (
        BFSInputs, CudaSubstrate, GSANAInputs, LocalSubstrate, Request, SpMVInputs, run,
    )
    from repro_torch.sparse import edges_to_csr, laplacian_2d, partition_graph, rmat_edges

    local, card = LocalSubstrate(dev), CudaSubstrate(dev)
    a = laplacian_2d(33, device=dev)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(a.n_cols).astype(np.float32),
                        device=dev)
    spmv_in = SpMVInputs(partition_ell(a, 8, device=dev), x)
    for rep in (True, False):
        st = MigratoryStrategy(replicate_x=rep, grain=16)
        y_l, _ = run(Request("spmv", spmv_in, st, local), iters=1, warmup=0)
        y_c, _ = run(Request("spmv", spmv_in, st, card), iters=1, warmup=0)
        torch.testing.assert_close(y_c, y_l, rtol=SPMV_RTOL, atol=SPMV_ATOL)
    g = partition_graph(edges_to_csr(rmat_edges(10, 8, seed=1), 1024, device=dev), 8, device=dev)
    for comm in Comm:
        st = MigratoryStrategy(comm=comm)
        p_l, _ = run(Request("bfs", BFSInputs(g, 5), st, local), iters=1, warmup=0)
        p_c, _ = run(Request("bfs", BFSInputs(g, 5), st, card), iters=1, warmup=0)
        smoke.check(torch.equal(p_l, p_c), "small bfs: cuda and local parents differ")
    vs1, vs2, pi = generate_alignment_pair(1024, seed=1, device=dev)
    grid = pick_grid(1024, 32)
    cap = max(bucketize(vs1, grid, device=dev).cap, bucketize(vs2, grid, device=dev).cap)
    gi = GSANAInputs(vs1, vs2, bucketize(vs1, grid, cap=cap, device=dev),
                     bucketize(vs2, grid, cap=cap, device=dev), ground_truth=pi)
    (c_l, s_l), _ = run(Request("gsana", gi, None, local), iters=1, warmup=0)
    (c_c, s_c), _ = run(Request("gsana", gi, None, card), iters=1, warmup=0)
    smoke.check(torch.equal(c_l, c_c), "small gsana: cuda and local candidates differ")
    torch.testing.assert_close(s_c, s_l, rtol=0, atol=1e-6)


def profile_requests(inputs: dict, lm: "dict | None") -> None:
    """One warm request of each op, one LM prefill and one decode step under
    torch.profiler: the device's busy time (sum of kernel time; one stream,
    so nothing overlaps) against the call's wall time, and the kernels that
    take it. The profiler's own overhead is inside the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import MigratoryStrategy
    from repro_torch.engine import CudaSubstrate, Request, build_plan, compile_plan
    from repro_torch.models import Ctx, api

    sub = CudaSubstrate(inputs["spmv"].x.device)
    requests = {
        "spmv (S1 on)": Request("spmv", inputs["spmv"], MigratoryStrategy(), sub),
        "spmv (S1 off)": Request("spmv", inputs["spmv"], MigratoryStrategy(replicate_x=False), sub),
        "bfs": Request("bfs", inputs["bfs"], None, sub),
        "gsana (PAIR)": Request("gsana", inputs["gsana"], None, sub),
    }
    calls = {name: compile_plan(build_plan(req.op, req.inputs, req.strategy, req.substrate))
             for name, req in requests.items()}
    if lm is not None:
        ctx, model = Ctx(lm["cfg"]), lm["model"]
        tokens = torch.as_tensor(lm["prompts"], device=model.embed.device)
        _, caches = api.prefill(ctx, model, tokens, LM_PROMPT + LM_GEN)
        # each call writes the same cache entry (the caches' length stays)
        calls[f"LM prefill ({LM_BATCH}x{LM_PROMPT}, flash)"] = (
            lambda: api.prefill(ctx, model, tokens, LM_PROMPT + LM_GEN))
        calls[f"LM decode step ({LM_BATCH} rows, {LM_PROMPT} cached)"] = (
            lambda: api.decode_step(ctx, model, tokens[:, -1:], caches))
    for name, call in calls.items():
        call()  # warm: the plan cache already holds each executor
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
                  and e.self_device_time_total > 0]
        if not events:
            print(f"  {name}: wall {wall_ms:.3f} ms, device time not measured "
                  "(the profiler recorded no kernel)", flush=True)
            continue
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
        share = ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                          for e in top)
        print(f"  {name}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
              f"(idle {100 * (1 - busy_ms / wall_ms):.1f} %), {sum(e.count for e in events)} kernels; "
              f"{share}", flush=True)


def kernel_row(smoke: Smoke, launches: dict, name, source, replaces, err, ms, plain_ms, n_bytes,
               n_ops, library_ms, peak_ops: float = PEAK_FP32_PER_S, **extra) -> None:
    """One kernel's row: its bound from the bytes and operations its inputs
    need, the share of that bound reached, the rate that bounds it, and any
    ``extra`` columns."""
    bound_ms, bound_by = bound(n_bytes, n_ops, peak_ops)
    row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": launches[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
           "bound_share": bound_ms / ms}
    if bound_by == "bytes":
        row["gbps"] = n_bytes / ms / 1e6
    else:
        row["tflops"] = n_ops / ms / 1e9
    row.update(extra)
    smoke.kernels.append(row)
    print("  " + json.dumps(row), flush=True)


def kernels_vs_plain(smoke: Smoke, inputs: dict, launches: dict) -> None:
    from repro_torch.core import MigratoryStrategy, UNVISITED, bucketize, pick_grid
    from repro_torch.core.bfs import global_rows
    from repro_torch.core.gsana import DEFAULT_VOCAB, pair_tasks
    from repro_torch.kernels.bfs.kernel import bfs_expand, bfs_expand_occupancy, bfs_expand_plain
    from repro_torch.kernels.spmv.kernel import spmv_ell, spmv_ell_plain
    from repro_torch.kernels.spmv.ops import spmv
    from repro_torch.kernels.spmv.stripe import build_stripe_plan
    from repro_torch.kernels.topk_sim.kernel import topk_sim, topk_sim_plain
    from repro_torch.kernels.topk_sim.ops import pair_planes

    def entry(*args, **extra):
        kernel_row(smoke, launches, *args, **extra)

    # -- SpMV: the cuda adapter's (P*R_p, K) planes and grain -------------------
    a = inputs["spmv"].a
    p, rp, k = a.cols.shape
    cols, vals = a.cols.reshape(p * rp, k), a.vals.reshape(p * rp, k)
    x = inputs["spmv"].x
    grain = max(1, min(MigratoryStrategy().dynamic_grain(rp), p * rp))
    y_k = spmv_ell(cols, vals, x, block_rows=grain)
    y_p = spmv_ell_plain(cols, vals, x)
    err = (y_k - y_p).abs()
    smoke.check(bool((err <= SPMV_ATOL + SPMV_RTOL * y_p.abs()).all()),
                f"spmv_ell disagrees with its plain version: max abs err {float(err.max())}")
    csr = inputs["csr"]
    try:
        with warnings.catch_warnings():  # sparse CSR is "beta": keep its notices out of the log
            warnings.simplefilter("ignore", UserWarning)
            a_lib = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data, size=csr.shape)
        torch.mv(a_lib, x)
        library_ms = time_ms(lambda: torch.mv(a_lib, x), 50)
    except (RuntimeError, NotImplementedError) as e:  # no sparse CSR product in this build
        print(f"  torch.sparse CSR yardstick unavailable: {e}")
        library_ms = None
    r, n = p * rp, a.shape[1]
    entry("spmv_ell", "src/repro_torch/csrc/spmv_ell.cu", "src/repro/kernels/spmv/kernel.py:31",
          float(err.max()), time_ms(lambda: spmv_ell(cols, vals, x, block_rows=grain), 50),
          time_ms(lambda: spmv_ell_plain(cols, vals, x), 20), r * k * 8 + n * 4 + r * 4, 2 * r * k,
          library_ms)
    plan = build_stripe_plan(cols, grain)
    y_s = spmv(cols, vals, x, variant="stripe", stripe_plan=plan)
    err = (y_s - y_p).abs()
    smoke.check(bool((err <= SPMV_ATOL + SPMV_RTOL * y_p.abs()).all()),
                f"spmv stripe variant disagrees with spmv_ell_plain: max abs err {float(err.max())}")
    stripe_ms = time_ms(lambda: spmv(cols, vals, x, variant="stripe", stripe_plan=plan), 20)
    print(f"  spmv stripe variant (same kernel, per-width launches): {stripe_ms} ms, "
          f"max abs err vs spmv_ell_plain {float(err.max())}")

    # -- BFS: every round of the main path, on the planes bfs_cuda hands over --
    g = inputs["bfs"].g
    planes = g.adj  # (P, V_p, K), read in place
    n_pad, kk = g.P * g.v_per_nodelet, g.k
    frontiers = bfs_frontiers(g)
    block = MigratoryStrategy().dynamic_grain(n_pad)
    shape = bfs_expand_occupancy(block)
    n_sm = torch.cuda.get_device_properties(planes.device).multi_processor_count
    n_ctas = -(-n_pad // block)
    warps_per_sm = shape["blocks_per_sm"] * shape["threads_per_block"] // 32
    print(f"  bfs_expand launch at grain {block}: {n_ctas} CTAs of {shape['threads_per_block']} "
          f"threads; {shape['blocks_per_sm']} CTAs ({warps_per_sm} warps of 64) resident an SM, "
          f"{min(n_ctas, shape['blocks_per_sm'] * n_sm)} of the {n_ctas} CTAs at once on {n_sm} SMs")
    rounds = []
    for i, frontier in enumerate(frontiers):
        smoke.check(torch.equal(bfs_expand(planes, frontier, block_rows=block),
                                bfs_expand_plain(planes, frontier)),
                    f"bfs_expand disagrees with its plain version in round {i}")
        n_front = int(frontier.sum())
        ms = time_ms(lambda f=frontier: bfs_expand(planes, f, block_rows=block), 20)
        bound_ms, _ = bound(*bfs_expand_work(n_pad, kk, n_front))
        rounds.append((n_front, ms, bound_ms))
        print(f"  bfs round {i}: frontier {n_front}, kernel {ms} ms, bound {bound_ms} ms", flush=True)
    largest = int(np.argmax([r[0] for r in rounds]))
    frontier = frontiers[largest]
    rows = global_rows(planes).contiguous()
    print(f"  bfs largest round on an (N, K) copy of the planes: "
          f"{time_ms(lambda: bfs_expand(rows, frontier, block_rows=block), 20)} ms")
    src = frontier.nonzero()  # (n_frontier, 1)
    nbrs = rows[src[:, 0]]
    valid = nbrs >= 0
    dst, prop = nbrs[valid].long(), src.expand(-1, kk)[valid].to(torch.int32)
    out = torch.empty(n_pad, dtype=torch.int32, device=planes.device)

    def library():  # scatter_reduce_ over the round's valid proposals, precomputed
        out.fill_(UNVISITED)
        out.scatter_reduce_(0, dst, prop, "amin")

    entry("bfs_expand", "src/repro_torch/csrc/bfs_expand.cu",
          "src/repro/kernels/bfs/kernel.py:31", 0.0, rounds[largest][1],
          time_ms(lambda: bfs_expand_plain(planes, frontier), 10),
          *bfs_expand_work(n_pad, kk, rounds[largest][0]), time_ms(library, 10),
          rounds=len(rounds), rounds_ms=sum(r[1] for r in rounds),
          rounds_bound_ms=sum(r[2] for r in rounds))

    # -- topk_sim: the PAIR planes of the main path ----------------------------
    gi = inputs["gsana"]
    tasks = pair_tasks(gi.b2.grid, gi.b2.vid.device)
    fv, fu, mv, mu, _ = pair_planes(gi.vs1, gi.vs2, gi.b1, gi.b2, *tasks)
    kw = dict(zip(("t1", "t2", "t3"), DEFAULT_VOCAB), k=min(gi.k, gi.b1.cap))
    s_k, i_k = topk_sim(fv, fu, mv, mu, **kw)
    s_p, i_p = topk_sim_plain(fv, fu, mv, mu, **kw)
    smoke.check(torch.equal(i_k, i_p), "topk_sim slots disagree with its plain version")
    finite = torch.isfinite(s_p)
    smoke.check(torch.equal(finite, torch.isfinite(s_k)), "topk_sim: -inf pattern differs")
    err = float((s_k[finite] - s_p[finite]).abs().max())
    smoke.check(err <= 1e-6, f"topk_sim scores differ by {err}")
    entry("topk_sim", "src/repro_torch/csrc/topk_sim.cu",
          "src/repro/kernels/topk_sim/kernel.py:50", err,
          time_ms(lambda: topk_sim(fv, fu, mv, mu, **kw), 10),
          time_ms(lambda: topk_sim_plain(fv, fu, mv, mu, **kw), 3, warmup=1),
          *topk_sim_work(fv, fu, mv, mu, kw), None)

    # -- topk_sim past 64 u slots: the paper's larger buckets (|B| about 128,
    # a 32x32 grid) take the kernel's wide instance; held and timed here,
    # off the main path
    grid = pick_grid(gi.vs1.n, 128)
    b1, b2 = bucketize(gi.vs1, grid, device=fv.device), bucketize(gi.vs2, grid, device=fv.device)
    cap = max(b1.cap, b2.cap)
    b1, b2 = bucketize(gi.vs1, grid, cap=cap, device=fv.device), bucketize(gi.vs2, grid, cap=cap, device=fv.device)
    planes = pair_planes(gi.vs1, gi.vs2, b1, b2, *pair_tasks(grid, fv.device))[:4]
    s_k, i_k = topk_sim(*planes, **kw)
    s_p, i_p = topk_sim_plain(*planes, **kw)
    smoke.check(torch.equal(i_k, i_p), f"topk_sim slots disagree with its plain version at cap {cap}")
    finite = torch.isfinite(s_p)
    smoke.check(torch.equal(finite, torch.isfinite(s_k)), f"topk_sim: -inf pattern differs at cap {cap}")
    err = float((s_k[finite] - s_p[finite]).abs().max())
    smoke.check(err <= 1e-6, f"topk_sim scores differ by {err} at cap {cap}")
    bound_ms, bound_by = bound(*topk_sim_work(*planes, kw))
    print(f"  topk_sim past 64 u slots: {grid}x{grid} grid, {planes[0].shape[0]} tasks of "
          f"{cap}x{cap} slots, max abs err {err}; "
          f"{time_ms(lambda: topk_sim(*planes, **kw), 5)} ms, plain version "
          f"{time_ms(lambda: topk_sim_plain(*planes, **kw), 1, warmup=0)} ms, "
          f"bound {bound_ms} ms ({bound_by})", flush=True)


def bfs_expand_work(n: int, k: int, n_frontier: int) -> tuple[int, int]:
    """(bytes, operations) of one expansion round: the frontier mask, the
    frontier rows' adjacency and the proposals out; no arithmetic to speak of."""
    return n + n_frontier * k * 4 + n * 4, 0


def topk_sim_work(fv, fu, mv, mu, kw) -> tuple[float, float]:
    """(bytes, operations) that topk_sim must move and do on these planes:
    the masks, the scored columns of the valid rows only (a masked slot
    scores -inf whatever its features), the scores and slots out; the
    histogram min-sums and five terms of every valid pair."""
    n_tasks, a_rows, _ = fv.shape
    width = 5 + kw["t1"] + kw["t2"] + kw["t3"]
    n_bytes = (n_tasks * (a_rows + fu.shape[1]) * 4 + float(mv.sum() + mu.sum()) * width * 4
               + n_tasks * a_rows * kw["k"] * 8)
    pairs = float((mv.sum(1) * mu.sum(1)).sum())
    return n_bytes, pairs * (2 * (width - 5) + 19)


# (bh_q, bh_kv, sq, skv, causal, window): GQA, MQA, q the tail of a longer
# kv, a sliding window, non-causal, lengths that are not tile multiples
FLASH_SMALL_CASES = [
    (8, 4, 64, 64, True, None), (8, 1, 96, 96, True, None), (4, 4, 64, 192, True, None),
    (8, 4, 130, 130, True, 48), (2, 1, 100, 70, False, None), (2, 2, 70, 40, True, None),
    (2, 1, 64, 200, False, 16),
]


def causal_pairs(sq: int, skv: int) -> int:
    """(q, k) pairs the causal mask leaves visible, q aligned to the kv tail."""
    return int(np.clip(np.arange(sq) + (skv - sq) + 1, 0, skv).sum())


def tensor_core_instructions(lib: Path, nvcc: str) -> "dict[str, int] | None":
    """Counts of HGMMA (wgmma) and HMMA (mma.sync) instructions in a built
    library's SASS, from the toolkit's cuobjdump (beside ``nvcc``) or the
    copy in Triton's package; None where neither is found."""
    cands = [Path(nvcc).with_name("cuobjdump")]
    spec = importlib.util.find_spec("triton")  # located, not imported
    if spec is not None and spec.submodule_search_locations:
        cands.append(Path(spec.submodule_search_locations[0]) / "backends" / "nvidia" / "bin" / "cuobjdump")
    tool = next((c for c in cands if c.exists()), None)
    if tool is None:
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout.splitlines()
    return {op: sum(f" {op}." in line or f" {op} " in line for line in sass) for op in ("HGMMA", "HMMA")}


def flash_vs_plain(smoke: Smoke, lm: dict) -> None:
    """flash_attn against its plain version (at the bf16 kernel's k tile) on
    layer 0's q, k, v from the prefill, then on small float32 cases (at the
    float32 kernel's 64-key tile); times kernel, plain version and
    scaled_dot_product_attention (a yardstick, never called by the port)."""
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import (
        KERNEL_BLOCK_K, flash_attention_plain, flash_attn,
    )

    counts = tensor_core_instructions(build.library_path("flash_attn"), build.nvcc())
    if counts is None:
        print("  flash_attn tensor-core instructions: not measured (no cuobjdump)")
    else:
        print(f"  flash_attn tensor-core instructions (cuobjdump -sass): {counts}")
        smoke.check(counts["HGMMA"] + counts["HMMA"] > 0, "flash_attn: no tensor-core instruction")

    q, k, v = lm["qkv"]  # (B, Hq, S, D), (B, Hkv, S, D), as the model hands them over
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qf, kf, vf = q.reshape(b * hq, sq, d), k.reshape(b * hkv, skv, d), v.reshape(b * hkv, skv, d)
    got = flash_attn(qf, kf, vf)
    want = flash_attention_plain(qf, kf, vf, block_k=KERNEL_BLOCK_K)
    err = float((got.float() - want.float()).abs().max())
    torch.testing.assert_close(got.float(), want.float(), **FLASH_BF16_TOL)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    try:
        lib_err = float((library().reshape(got.shape).float() - got.float()).abs().max())
        library_ms = time_ms(library, 20)
    except RuntimeError as e:  # no GQA attention in this build
        print(f"  scaled_dot_product_attention yardstick unavailable: {e}")
        lib_err, library_ms = None, None
    print(f"  layer 0, q {tuple(qf.shape)} k/v {tuple(kf.shape)} {q.dtype}: max abs err "
          f"{err} vs the plain version, {lib_err} vs scaled_dot_product_attention")

    gen = torch.Generator().manual_seed(0)
    for bhq, bhkv, s_q, s_kv, causal, window in FLASH_SMALL_CASES:
        for dd in (64, 128):
            qs, ks, vs = (torch.randn((n, s, dd), generator=gen).to(q.device)
                          for n, s in ((bhq, s_q), (bhkv, s_kv), (bhkv, s_kv)))
            torch.testing.assert_close(
                flash_attn(qs, ks, vs, causal=causal, window=window),
                flash_attention_plain(qs, ks, vs, causal=causal, window=window, block_k=64),
                **FLASH_F32_TOL, msg=lambda m: f"float32 case {(bhq, bhkv, s_q, s_kv, causal, window, dd)}: {m}")
    print(f"  {2 * len(FLASH_SMALL_CASES)} small float32 cases agree within {FLASH_F32_TOL}")

    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()  # q, k, v in; o out
    n_ops = 4 * d * b * hq * causal_pairs(sq, skv)  # QK^T and PV, 2 flops a MAC
    kernel_row(smoke, {"flash_attn": lm["launches"]}, "flash_attn", "src/repro_torch/csrc/flash_attn.cu",
               "src/repro/kernels/flash_attention/kernel.py:25", err,
               time_ms(lambda: flash_attn(qf, kf, vf), 20),
               time_ms(lambda: flash_attention_plain(qf, kf, vf, block_k=KERNEL_BLOCK_K), 3, warmup=1),
               n_bytes, n_ops, library_ms, PEAK_BF16_PER_S)


def finish(smoke: Smoke) -> int:
    if smoke.failures:
        print(f"chip_smoke: FAILED phases: {smoke.failures}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": smoke.kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
