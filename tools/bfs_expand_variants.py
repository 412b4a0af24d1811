#!/usr/bin/env python3
"""Time ``csrc/bfs_expand.cu`` against edits of its own source, round by
round of the main path's BFS, on one CUDA card.

    python3 tools/bfs_expand_variants.py

Builds the kernel and each variant below (one nvcc each, all at once, into
``build/variants/``), replays the BFS of ``chip_smoke.py``'s main path
(``erdos_renyi_edges(20, 16)``, P=8, root 0, grain 2048) to collect every
round's frontier, holds each exact variant against the plain version in
every round, then times every round with CUDA events (the output filled
with UNVISITED before each launch, as ``bfs_expand`` does), variants in the
order A B ... B A. Last, the read-first variant on an output that already
holds the round's result, where every read skips its atomic: the cost of
the reads alone. Prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
ATOMIC = "if (static_cast<unsigned>(d) < n) atomicMin(proposals + d, s);"
# name -> (text to replace, replacement, output equals the plain version)
VARIANTS = {
    "kernel": (None, None, True),
    "read-first": (ATOMIC, "if (static_cast<unsigned>(d) < n && __ldcg(proposals + d) > s) "
                           "atomicMin(proposals + d, s);", True),
    "cta256": ("constexpr int kMaxThreads = 512;\nconstexpr int kMinBlocksPerSm = 4;",
               "constexpr int kMaxThreads = 256;\nconstexpr int kMinBlocksPerSm = 8;", True),
    "plain-store": (ATOMIC, "if (static_cast<unsigned>(d) < n) proposals[d] = s;", False),
    "no-proposal": (ATOMIC, "if (d == 0x7ffffff0) proposals[0] = s;", False),
}


def build_variants(build) -> dict[str, Path]:
    src = (build.CSRC / "bfs_expand.cu").read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (old, new, _) in VARIANTS.items():
        text = src
        if old is not None:
            lines = [line.split("//")[0].rstrip() for line in src.splitlines()]
            stripped = "\n".join(lines)
            if old not in stripped:
                raise SystemExit(f"variant {name}: its edit no longer applies to bfs_expand.cu")
            text = stripped.replace(old, new)
        cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        regs = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        print(f"  {name}: {'; '.join(regs)}")
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = lib
    return libs


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("bfs_expand_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import MigratoryStrategy
    from repro_torch.core.bfs import UNVISITED, bfs_rounds
    from repro_torch.kernels import build
    from repro_torch.kernels.bfs.kernel import bfs_expand_plain
    from repro_torch.sparse import edges_to_csr, erdos_renyi_edges, partition_graph

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    libs = build_variants(build)
    dev = torch.device("cuda", 0)
    g = partition_graph(edges_to_csr(erdos_renyi_edges(20, 16), 1 << 20, device=dev), 8, device=dev)
    n = g.P * g.v_per_nodelet
    frontiers = []

    def record(adj, frontier):
        frontiers.append(frontier.clone())
        return bfs_expand_plain(adj, frontier)

    bfs_rounds(g.adj, 0, n, record, n)
    block = MigratoryStrategy().dynamic_grain(n)
    print(f"  frontiers by round: {[int(f.sum()) for f in frontiers]}, grain {block}")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def launcher(lib_path, frontier, out, refill=True):
        fn = ctypes.CDLL(str(lib_path)).bfs_expand_i32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def launch():
            if refill:
                out.fill_(UNVISITED)
            err = fn(g.adj.data_ptr(), frontier.data_ptr(), out.data_ptr(), g.P, g.v_per_nodelet,
                     g.k, block, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        return launch

    out = torch.empty(n, dtype=torch.int32, device=dev)
    for name, lib in libs.items():
        if not VARIANTS[name][2]:
            continue
        for i, frontier in enumerate(frontiers):
            launcher(lib, frontier, out)()
            if not torch.equal(out, bfs_expand_plain(g.adj, frontier)):
                raise SystemExit(f"variant {name} disagrees with the plain version in round {i}")
    print("  exact variants equal the plain version in every round")
    fill = time_ms(lambda: out.fill_(UNVISITED))
    print(f"  fill alone: {fill} ms")
    for name in list(libs) + list(libs)[::-1]:
        times = [time_ms(launcher(libs[name], f, out)) for f in frontiers]
        print(f"  {name}: rounds {times} ms, sum {sum(times)} ms", flush=True)
    largest = max(frontiers, key=lambda f: int(f.sum()))
    launcher(libs["kernel"], largest, out)()  # out now holds the round's result
    print(f"  read-first on the largest round's own result (every atomic skipped): "
          f"{time_ms(launcher(libs['read-first'], largest, out, refill=False))} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
