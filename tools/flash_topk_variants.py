#!/usr/bin/env python3
"""Time ``csrc/flash_attn.cu`` and ``csrc/topk_sim.cu`` against edits of
their own sources on one CUDA card.

    python3 tools/flash_topk_variants.py

Builds each kernel and each variant below (one nvcc each, all at once, into
``build/variants/``) and prints every variant's registers and spills.
flash_attn: bf16, causal, B = 4 and S = 2048 at llama3.2-3b's heads (24 q,
8 kv, head dim 128) and at 32 q/kv heads with head dims 96, 80 and 32; each
variant held against the plain version at the kernel's k tile. topk_sim:
GSANA's PAIR planes of ``generate_alignment_pair(131072)`` at the main
path's 64x64 grid and at a 16x16 grid (buckets of 574 slots, the wide
instance), each variant's slots held equal to the plain version's.
Variants are timed with CUDA events in the order A B ... B A. Prints the
card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# name -> [(text to replace, replacement), ...]; no edit: the kernel itself
FLASH_VARIANTS = {
    "kernel": [],
    # S = Q K^T stops after ceil(d / 16) steps: a branch between the wgmmas
    "stop-early": [
        ("__device__ __forceinline__ void issue_s(float* sc, uint32_t q_base, uint32_t k_base) {\n"
         "#pragma unroll\n  for (int kk = 0; kk < DP / 16; ++kk) {",
         "__device__ __forceinline__ void issue_s(float* sc, uint32_t q_base, uint32_t k_base,\n"
         "                                        int k_steps) {\n"
         "#pragma unroll\n  for (int kk = 0; kk < DP / 16; ++kk) {\n    if (kk >= k_steps) break;"),
        ("issue_s<DP>(sc, q_base, smem_addr(sm.k[0]));", "issue_s<DP>(sc, q_base, smem_addr(sm.k[0]), (d + 15) / 16);"),
        ("issue_s<DP>(sc, q_base, smem_addr(sm.k[s]));", "issue_s<DP>(sc, q_base, smem_addr(sm.k[s]), (d + 15) / 16);"),
    ],
    # every head dim through the epilogue that tests each column against d
    "tested-epilogue": [("d == DP ? flash_tc_kernel<DP, true> : flash_tc_kernel<DP, false>",
                         "flash_tc_kernel<DP, false>")],
}
TOPK_VARIANTS = {
    "kernel": [],  # the wide instance at 2 u rows a lane, 8 v rows a warp
    "j4r4": [("wide_shared<2, 8>", "wide_shared<4, 4>"), ("launch_wide<2, 8>", "launch_wide<4, 4>")],
    "j2r4": [("wide_shared<2, 8>", "wide_shared<2, 4>"), ("launch_wide<2, 8>", "launch_wide<2, 4>")],
    # loops bounded at run time by the chunk's valid rows
    "tested-loops": [("pair_sums<J, R>(s, su, sv, ld, nu, J, warp, R, t1, t2, t3);",
                      "pair_sums<J, R>(s, su, sv, ld, nu, max((nu + 31) / 32, 1), warp, n_rows, t1, t2, t3);")],
    # running top-k lists in the rows' outputs (device memory) for every k
    "device-lists": [("const bool lists = pass == 0 && k <= LIST_K_MAX;", "const bool lists = false;")],
}


def build_variants(build, source: str, variants: dict) -> dict[str, ctypes.CDLL]:
    src = (build.CSRC / f"{source}.cu").read_text()
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{source} variant {name}: its edit no longer applies")
            text = text.replace(old, new)
        cu, lib = out_dir / f"{source}-{name}.cu", out_dir / f"lib{source}-{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {source} variant {name}:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        print(f"  {source} {name}: {'; '.join(regs)}; {log.count('C7515')} C7515 warnings", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def time_ms(fn, iters: int) -> float:
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


def in_turns(names, run) -> dict[str, list[float]]:
    """``run(name)`` for every variant, in the order A B ... B A."""
    out = {name: [] for name in names}
    for name in [*names, *names[::-1]]:
        out[name].append(run(name))
    return out


def show(what: str, times: dict) -> None:
    print(f"  {what}: " + ", ".join(f"{n} {min(t):.4f} ms ({', '.join(f'{x:.4f}' for x in t)})"
                                    for n, t in times.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_topk_variants: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import bucketize, generate_alignment_pair, pick_grid
    from repro_torch.core.gsana import DEFAULT_VOCAB, pair_tasks
    from repro_torch.kernels import build
    from repro_torch.kernels.build import stream_of
    from repro_torch.kernels.flash_attention.kernel import flash_attention_plain, kernel_block_k
    from repro_torch.kernels.topk_sim.kernel import topk_sim_plain
    from repro_torch.kernels.topk_sim.ops import pair_planes

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    flash = build_variants(build, "flash_attn", FLASH_VARIANTS)
    topk = build_variants(build, "topk_sim", TOPK_VARIANTS)
    for lib in flash.values():
        lib.flash_attn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    for lib in topk.values():
        lib.topk_sim_f32.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]

    gen = torch.Generator().manual_seed(0)
    for hq, hkv, d in [(24, 8, 128), (32, 32, 96), (32, 32, 80), (32, 32, 32)]:
        q, k, v = (torch.randn((4 * h, 2048, d), generator=gen).cuda().bfloat16() for h in (hq, hkv, hkv))
        o = torch.empty_like(q)
        want = flash_attention_plain(q, k, v, block_k=kernel_block_k(q.dtype, d)).float()

        def launch(name):
            err = flash[name].flash_attn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                         q.shape[0], k.shape[0], 2048, 2048, d, 1, 2048, d ** -0.5,
                                         stream_of(o))
            if err:
                raise SystemExit(f"flash_attn variant {name}: CUDA error {err}")

        def run(name):
            launch(name)
            torch.testing.assert_close(o.float(), want, rtol=1.6e-2, atol=1e-2)
            return time_ms(lambda: launch(name), 20)

        show(f"flash_attn {hq}/{hkv} heads, head dim {d}", in_turns(list(flash), run))

    n = 131072
    dev = torch.device("cuda")
    vs1, vs2, _ = generate_alignment_pair(n, device=dev)
    t1, t2, t3 = DEFAULT_VOCAB
    for bucket in (32, 512):
        grid = pick_grid(n, bucket)
        cap = max(bucketize(vs1, grid, device=dev).cap, bucketize(vs2, grid, device=dev).cap)
        b1, b2 = bucketize(vs1, grid, cap=cap, device=dev), bucketize(vs2, grid, cap=cap, device=dev)
        fv, fu, mv, mu = pair_planes(vs1, vs2, b1, b2, *pair_tasks(grid, dev))[:4]
        p, a, f = fv.shape
        _, i_p = topk_sim_plain(fv, fu, mv, mu, t1=t1, t2=t2, t3=t3, k=4)
        s, i = torch.empty((p, a, 4), device=dev), torch.empty((p, a, 4), dtype=torch.int32, device=dev)

        def launch(name):
            err = topk[name].topk_sim_f32(fv.data_ptr(), fu.data_ptr(), mv.data_ptr(), mu.data_ptr(),
                                          s.data_ptr(), i.data_ptr(), p, a, fu.shape[1], f, t1, t2, t3,
                                          4, stream_of(s))
            if err:
                raise SystemExit(f"topk_sim variant {name}: CUDA error {err}")

        def run(name):
            launch(name)
            if not torch.equal(i, i_p):
                raise SystemExit(f"topk_sim variant {name}: slots differ from the plain version")
            return time_ms(lambda: launch(name), 20 if cap <= 64 else 5)

        show(f"topk_sim {grid}x{grid} grid, {p} tasks of {cap} slots", in_turns(list(topk), run))
    return 0


if __name__ == "__main__":
    sys.exit(main())
