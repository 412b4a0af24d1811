"""Serving entry points.

LM path: prefill a batch of prompts, then greedy-decode, for any of the
configs' families (dense, MoE, VLM, SSM, hybrid, encoder-decoder).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b --reduced \\
        --batch 4 --prompt-len 64 --gen 32 [--device cpu]

Weights are random, drawn from seed 0 on the device; prompts are numpy
integers from seed 1, and the stub frontends' frames (whisper) or patches
(phi-3-vision) numpy N(0, 1) from seed 2.

Irregular-op path: drive an ``EngineService`` on the ``cuda`` substrate with a
mixed SpMV/BFS request stream (autotuned strategies, one shared plan cache)
and print its throughput report. ``--ops`` uses the batched drain;
``--ops-async`` starts the worker loop (``--ops-workers`` executor slots, each
on a CUDA stream of its own on the card) and feeds it from an *open-loop*
generator: requests arrive at ``--ops-rate`` per second with jitter, whatever
the service's progress, under ``--ops-admission block|reject``, with BFS at
twice the QoS weight.

    PYTHONPATH=src python -m repro_torch.launch.serve --ops --ops-requests 32
    PYTHONPATH=src python -m repro_torch.launch.serve --ops-async --ops-workers 2 \\
        --ops-rate 100 --ops-admission reject [--device cpu]

Cluster path (``--cluster N``): the same mixed SpMV/BFS stream served by N
worker processes (``repro_torch.cluster``), each with its own
``EngineService`` on the ``cuda`` substrate and its own CUDA context, every
response held against single-process ``engine.run`` with ``torch.equal``;
``--cluster-kill-one`` SIGKILLs one worker mid-stream (its in-flight
requests are retried once on a survivor).

    PYTHONPATH=src python -m repro_torch.launch.serve --ops --cluster 2 \\
        [--cluster-kill-one] [--device cpu]

MoE decode path (``--decode-serve``): continuous-batched decode of the
``serve-moe`` config through ``DecodeServer``, each step
one request through the ``EngineService`` worker loop with an SLO target,
the served tokens checked token-for-token against the single-process oracle.

    PYTHONPATH=src python -m repro_torch.launch.serve --decode-serve \
        --serve-dispatch ep_pull --serve-nodelets 4 [--device cpu]

Every path runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from ..configs import get_config, reduced_config
from ..device import resolve_device
from ..models import Ctx, api
from ..models.config import ModelConfig


class ServeResult(NamedTuple):
    tokens: torch.Tensor  # (B, gen) greedy token ids, int64
    prefill_seconds: float  # the prompt pass, to its logits on the host's clock
    decode_seconds: float  # the gen - 1 decode steps after it


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_serve(cfg: ModelConfig, model, prompts, gen: int, device="cuda",
             batch: dict | None = None) -> ServeResult:
    """Prefill ``prompts`` (B, S) through ``model`` under ``cfg``, then take
    ``gen`` greedy tokens: the first from the prefill's logits, the rest
    from ``gen - 1`` decode steps. ``batch`` holds the stub inputs the
    family takes (``"frames"`` for encdec, ``"patches"`` for vlm), moved to
    ``device``; the caches hold the patches as well."""
    if gen < 1:
        raise ValueError(f"gen must be at least 1, got {gen}")
    dev = resolve_device(device)
    ctx = Ctx(cfg)
    prompts = torch.as_tensor(prompts, dtype=torch.long, device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in (batch or {}).items()}
    max_len = prompts.shape[1] + gen + (cfg.num_patches or 0)
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, state = api.prefill(ctx, model, prompts, max_len, batch)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, state = api.decode_step(ctx, model, tok, state)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            out.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    return ServeResult(torch.cat(out, dim=1), t_prefill, t_decode)


def _ops_workload(shapes: tuple[int, ...], seed: int, device):
    """The demo's rotating problem signatures: a pool of SpMV problems
    (``laplacian_2d`` of each shape, P=8) and one BFS graph
    (``erdos_renyi_edges(9, 6)``, P=8, root 0), on ``device``."""
    from ..core import partition_ell
    from ..engine import BFSInputs, SpMVInputs
    from ..sparse import edges_to_csr, erdos_renyi_edges, laplacian_2d, partition_graph

    rng = np.random.default_rng(seed)
    spmv_pool = []
    for n in shapes:
        a = laplacian_2d(n, device=device)
        x = torch.as_tensor(rng.standard_normal(n * n).astype(np.float32), device=device)
        spmv_pool.append(SpMVInputs(partition_ell(a, 8, device=device), x))
    g = edges_to_csr(erdos_renyi_edges(9, 6, seed=seed), 512, device=device)
    bfs_inputs = BFSInputs(partition_graph(g, 8, device=device), 0)

    def pick(i: int):
        if i % 3 == 2:
            return "bfs", bfs_inputs
        return "spmv", spmv_pool[i % len(spmv_pool)]

    return pick


def _print_summary(stats, n_requests: int) -> None:
    print(f"served {stats.requests}/{n_requests} requests ({stats.rejected} rejected) "
          f"in {stats.wall_seconds * 1e3:.0f} ms ({stats.requests_per_second:.0f} req/s)")
    print(f"compiles: {stats.compiles} ({stats.compile_seconds * 1e3:.0f} ms), "
          f"cache hits: {stats.cache_hits}, amortization: {stats.amortization:.1f} req/compile")


def ops_demo(n_requests: int, shapes: tuple[int, ...] = (16, 24), seed: int = 0,
             device="cuda") -> dict:
    """Serve a mixed SpMV/BFS stream through the batched EngineService:
    each drain compiles once per signature and serves the rest from the
    plan cache."""
    from ..engine import EngineService, Request

    pick = _ops_workload(shapes, seed, device)
    svc = EngineService(substrate="cuda", autotune=True, device=device)
    for i in range(n_requests):
        svc.submit(Request(*pick(i)))
    svc.drain()
    report = svc.throughput_report()
    _print_summary(svc.stats(), n_requests)
    print(json.dumps(report, default=str))
    return report


def ops_demo_async(
    n_requests: int,
    rate: float = 100.0,
    admission: str = "block",
    max_queue_depth: int = 64,
    shapes: tuple[int, ...] = (16, 24),
    seed: int = 0,
    workers: "int | str" = 1,
    device="cuda",
) -> dict:
    """Open-loop async serving: a generator submits at ``rate`` req/s
    (jittered, never waiting for responses) while the worker pipeline
    overlaps first calls with execution. BFS requests get a 2x QoS weight,
    so mixed bursts schedule BFS groups first."""
    from ..engine import AdmissionError, EngineService, Request

    pick = _ops_workload(shapes, seed, device)
    rng = np.random.default_rng(seed)
    interval = 1.0 / rate if rate > 0 else 0.0
    svc = EngineService(
        substrate="cuda", autotune=True, device=device, workers=workers,
        max_queue_depth=max_queue_depth, admission=admission, qos={"bfs": 2.0},
        batch_window=0.02,
    )
    svc.start()
    futures = []
    try:
        for i in range(n_requests):
            try:
                futures.append(svc.submit(Request(*pick(i))))
            except AdmissionError:
                pass  # open loop drops on the floor; counted in stats.rejected
            if interval:
                time.sleep(interval * (0.5 + rng.random()))  # jittered arrivals
        for f in futures:
            f.result(timeout=600)
    finally:
        svc.stop()
    report = svc.throughput_report()
    stats = svc.stats()
    _print_summary(stats, n_requests)
    print(f"overlap: {stats.overlap_seconds * 1e3:.0f} ms ({stats.overlap_ratio:.0%} of "
          f"first-call time hidden under execution), busy {stats.busy_seconds * 1e3:.0f} / "
          f"wall {stats.wall_seconds * 1e3:.0f} ms, queue hwm {stats.queue_depth_hwm}")
    if stats.workers > 1:
        print(f"pool: {stats.workers} workers, {stats.steals} steals, "
              f"occupancy {[round(o, 2) for o in stats.worker_occupancy]}")
    print(json.dumps(report, default=str))
    return report


def cluster_demo(
    n_workers: int,
    n_requests: int = 24,
    shapes: tuple[int, ...] = (16, 24),
    seed: int = 0,
    kill_one: bool = False,
    device="cuda",
) -> dict:
    """Serve the mixed SpMV/BFS stream on an ``n_workers``-process cluster
    whose workers run the ``cuda`` substrate on ``device``, and hold every
    response bit for bit against single-process ``engine.run``.
    ``kill_one=True`` SIGKILLs one worker mid-stream: every future still
    terminates and parity still holds (in-flight requests are retried once
    on a survivor)."""
    from ..cluster import launch_cluster
    from ..engine import CudaSubstrate, Request, run
    from ..engine.wire import to_device

    dev = resolve_device(device)
    pick = _ops_workload(shapes, seed, dev)
    sub = CudaSubstrate(dev)
    requests = [Request(*pick(i), None, sub) for i in range(n_requests)]
    t_start = time.perf_counter()
    with launch_cluster(n_workers, device=str(dev)) as cluster:
        t_up = time.perf_counter() - t_start
        t0 = time.perf_counter()
        futures = [cluster.submit(r) for r in requests]
        if kill_one and n_workers > 1:
            victim = cluster.coordinator.healthy_workers()[0].worker_id
            print(f"SIGKILLing worker {victim} mid-stream ...")
            cluster.kill_worker(victim)
        responses = [f.result(timeout=600) for f in futures]  # every future terminates
        wall = time.perf_counter() - t0
        # results cross the wire as CPU tensors
        mismatches = sum(
            not torch.equal(response.result, to_device(run(request, iters=1, warmup=0)[0], "cpu"))
            for request, response in zip(requests, responses)
        )
        stats = cluster.stats()
    per_worker = {w["worker_id"]: w["served"] for w in stats["workers"]}
    print(f"cluster up ({n_workers} workers, device={dev}) in {t_up:.1f}s; served "
          f"{len(responses)} requests in {wall * 1e3:.0f} ms "
          f"({len(responses) / max(wall, 1e-9):.0f} req/s)")
    print(f"per-worker served: {per_worker}, retries: {stats['retries']}, "
          f"failovers: {stats['failovers']}, mismatches: {mismatches}")
    report = {
        "n_workers": n_workers,
        "requests": len(responses),
        "wall_seconds": wall,
        "mismatches": mismatches,
        "cluster": stats,
    }
    print(json.dumps(report, default=str))
    if mismatches:
        raise SystemExit(f"{mismatches} responses diverged from engine.run")
    return report


def decode_serve_demo(
    n_seqs: int = 8,
    capacity: int = 8,
    max_new: int = 8,
    workers: "int | str" = 2,
    slo_ms: float = 5000.0,
    nodelets: int = 4,
    dispatch: str = "ep_pull",
    seed: int = 0,
    device="cuda",
) -> dict:
    """Continuous-batched MoE decode serving: serve-moe's expert FFNs run
    behind ``moe_dispatch`` transport, every decode step travels as one
    :class:`Request` through the worker-loop service (on ``LocalSubstrate``
    on ``device``) with an SLO target, and the served tokens are
    cross-checked token-for-token against the single-process oracle."""
    from ..core import Comm, MigratoryStrategy
    from ..engine import DecodeServer, EngineService, LocalSubstrate
    from ..models.transformer import moe_decode_params

    dev = resolve_device(device)
    cfg = get_config("serve-moe")
    params = moe_decode_params(cfg, seed, dev)
    strategy = {
        "ep_pull": MigratoryStrategy(comm=Comm.MIGRATE),
        "ep_push": MigratoryStrategy(comm=Comm.REMOTE_WRITE),
    }.get(dispatch)
    nod = 1 if dispatch == "tp" else nodelets
    rng = np.random.default_rng(seed)
    prompts = [
        rng.integers(1, cfg.vocab_size, size=int(rng.integers(2, 6))).tolist()
        for _ in range(n_seqs)
    ]
    sub = LocalSubstrate(dev)
    mk = dict(capacity=capacity, max_len=32, nodelets=nod, strategy=strategy, substrate=sub,
              device=dev)

    def drive(server):
        # staggered joins: half the sequences arrive while others are decoding
        for i, prompt in enumerate(prompts):
            server.add(prompt, max_new_tokens=max_new)
            if i % 2:
                server.step()
        server.run_until_drained()
        return dict(server.results)

    svc = EngineService(substrate=sub, device=dev, workers=workers,
                        slo_target_seconds=slo_ms / 1e3)
    svc.start()
    try:
        served = drive(DecodeServer(cfg, params, service=svc, **mk))
    finally:
        svc.stop()
    stats = svc.stats()
    oracle = drive(DecodeServer(cfg, params, oracle=True, **mk))
    parity = served == oracle
    print(f"served {len(served)} sequences of {cfg.name} (dispatch={dispatch}, nodelets={nod}, "
          f"workers={workers}, device={dev}), oracle parity: {parity}")
    print(f"latency p50/p99: {stats.total_p50 * 1e3:.1f}/{stats.total_p99 * 1e3:.1f} ms; "
          f"SLO {slo_ms:.0f} ms -> {stats.slo_violations}/{stats.slo_checked} violations "
          f"(attainment {stats.slo_attainment})")
    report = {**svc.throughput_report(), "oracle_parity": parity}
    print(json.dumps(report, default=str))
    return report


def stub_inputs(cfg: ModelConfig, batch: int, seed: int) -> dict:
    """The stub frontends' inputs: float32 N(0, 1) frame embeddings (encdec,
    ``encoder_frames`` of them) or patch embeddings (vlm, ``num_patches``)
    from a numpy generator, as numpy; none for the other families."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal((batch, cfg.encoder_frames, cfg.d_model), dtype=np.float32)}
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal((batch, cfg.num_patches, cfg.d_model), dtype=np.float32)}
    return {}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ops", action="store_true",
                    help="serve a mixed SpMV/BFS stream through the batched EngineService")
    ap.add_argument("--ops-async", action="store_true",
                    help="open-loop arrivals into the EngineService worker loop")
    ap.add_argument("--ops-requests", type=int, default=24)
    ap.add_argument("--ops-rate", type=float, default=100.0,
                    help="open-loop arrival rate (req/s) for --ops-async")
    ap.add_argument("--ops-admission", choices=("block", "reject"), default="block",
                    help="admission policy when the async queue is full")
    ap.add_argument("--ops-workers", default="1",
                    help="executor-pool width for --ops-async (int or 'auto')")
    ap.add_argument("--decode-serve", action="store_true",
                    help="continuous-batched MoE decode serving with SLO stats")
    ap.add_argument("--serve-seqs", type=int, default=8)
    ap.add_argument("--serve-dispatch", choices=("ep_pull", "ep_push", "tp"), default="ep_pull")
    ap.add_argument("--serve-nodelets", type=int, default=4)
    ap.add_argument("--serve-slo-ms", type=float, default=5000.0,
                    help="per-request SLO target in ms for --decode-serve")
    ap.add_argument("--cluster", type=int, default=0, metavar="N",
                    help="serve the mixed-op stream on an N-worker localhost cluster (worker "
                         "processes), every response held against engine.run")
    ap.add_argument("--cluster-kill-one", action="store_true",
                    help="with --cluster: SIGKILL one worker mid-stream to show failover")
    args = ap.parse_args(argv)

    if args.cluster:
        cluster_demo(args.cluster, n_requests=args.ops_requests, kill_one=args.cluster_kill_one,
                     device=args.device)
        return
    if args.decode_serve:
        workers = args.ops_workers if args.ops_workers == "auto" else int(args.ops_workers)
        report = decode_serve_demo(
            args.serve_seqs, dispatch=args.serve_dispatch, nodelets=args.serve_nodelets,
            slo_ms=args.serve_slo_ms, device=args.device,
            workers=max(2, workers) if workers != "auto" else workers)
        if not report["oracle_parity"]:
            raise SystemExit("served tokens differ from the oracle's")
        return

    if args.ops_async:
        workers = args.ops_workers if args.ops_workers == "auto" else int(args.ops_workers)
        ops_demo_async(args.ops_requests, rate=args.ops_rate, admission=args.ops_admission,
                       workers=workers, device=args.device)
        return
    if args.ops:
        ops_demo(args.ops_requests, device=args.device)
        return

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = api.init_params(cfg, seed=0, device=args.device)
    prompts = np.random.default_rng(1).integers(1, cfg.vocab_size, (args.batch, args.prompt_len))
    res = lm_serve(cfg, model, prompts, args.gen, args.device, stub_inputs(cfg, args.batch, 2))
    print(f"arch={cfg.name} batch={args.batch} device={args.device}")
    print(f"prefill: {args.batch * args.prompt_len / res.prefill_seconds:.0f} tok/s "
          f"({res.prefill_seconds * 1e3:.0f} ms)")
    print(f"decode:  {args.batch * (args.gen - 1) / max(res.decode_seconds, 1e-9):.0f} tok/s")
    print("sample token ids:", res.tokens[0, :16].tolist())


if __name__ == "__main__":
    main()
