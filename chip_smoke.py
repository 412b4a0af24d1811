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
   substrate); then two more paths, counted the same way: the CSR-stripe
   SpMV through ``spmv(variant="stripe")`` (one launch a call; ``"auto"``
   too) on the Laplacian's planes and on ``skewed_matrix(2^20, 8, 512)``,
   each held against the ELL product and timed beside spmv_ell and
   torch.mv; and GSANA at a coarse grid (``pick_grid(n, 512)``: 16x16,
   buckets of about 570 vertices, topk_sim's wide instance) through
   ``engine.run`` on ``cuda``, held equal to ``local``, with the kernel
   timed there and its registers and spills printed (``cuobjdump
   -res-usage``);
3a. serves the main path through ``EngineService`` on ``cuda`` (phase
   "serving plane"): 24 requests rotating over the six signatures of 3, in
   batch mode and in the worker loop at 1, 2 and 4 workers (each worker on
   a CUDA stream of its own) under jittered open-loop arrivals at twice the
   rate one worker sustains; every result ``torch.equal`` to ``engine.run``,
   the kernels' launches through the service equal to ``engine.run``'s, a
   ``service {...}`` line per width (requests/s, latency percentiles,
   occupancy, steals); then a request whose inputs the default stream is
   still writing, dedup of 8 identical requests (with the content hash's
   host time), a rejected burst, a shed deadline and ``autotune=True``;
3b. serves the same stream through worker processes (phase "cluster plane"):
   clusters of 1, 2 and 4 processes (``repro_torch.cluster``), each worker an
   ``EngineService`` on ``cuda`` with its own CUDA context, the kernels built
   once before they start; the coordinator submits host copies of the
   inputs, each worker keeps the blobs it serves on the card (the blob
   budget set to hold the stream's inputs); the stream open loop at the
   serving phase's rate, then as one burst, every result ``torch.equal`` to
   ``engine.run``, at least two workers serving at 2 and 4; a ``cluster
   {...}`` line per size (requests/s, latency, served per worker, launch to
   ready, card memory per worker, blob hits and misses, the largest blob's
   verify ms, bytes on the wire against inline base64 encoding, held at 3x,
   kernel launches per worker); at 2 workers also ``EngineService(substrate=
   "cluster")`` forwarding the kernels, and a SIGKILL mid-burst whose
   futures all terminate with equal results. The workers stop before the LM
   phases;
3c. runs the main path on the ``mesh`` substrate (phase "mesh substrate"):
   8 rank processes on the card joined by a gloo group (one card: every
   collective through pinned host memory), the six signatures through
   ``engine.run`` on the same full-size inputs, each equal to ``local`` (SpMV
   and BFS bit for bit) and printed beside its ``cuda`` and ``local``
   seconds with the call split into the ranks' compute, their collectives
   and the caller's overhead (``mesh_row`` lines); ``moe_dispatch`` at the
   moonshot layer width in ep_push, ep_pull (8 ranks) and tp (1), equal to
   ``local``; ``DecodeServer`` for serve-moe through
   ``EngineService(substrate="mesh")`` at 4 ranks, tokens equal to the
   ``local`` run's; the collectives' alpha-beta fits; every mesh closed,
   even after a failure, before the LM phases, with no rank process left,
   every rank's exit code 0 and no CUDA IPC counter still held;
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
   then serves the reduced config (head dim 32) in bf16 and float32 the
   same way: flash launches counted, layer 0's q, k, v from the prefill
   held against the kernel's plain version, the logits held against the
   reference branch;
6. holds the ``cuda`` substrate against the ``local`` one on small inputs,
   and ``moe_dispatch``/``moe_decode`` on the card against the CPU;
7. profiles one request of each op, one LM prefill and one decode step
   (device busy time against wall time, kernel count, top kernels);
7a. frees llama's weights and serves the MoE LM at the full width of
   moonshot-v1-16b-a3b (48 layers, 64 experts top-6, bf16, 28.06e9 random
   weights from seed 0 drawn on the card) through ``lm_serve`` with flash
   attention: 4 prompts of 2048 tokens, 8 greedy tokens, 48 flash launches
   a prefill (an ``lm {...}`` line); holds the flash prefill and 4
   teacher-forced decode steps against the reference attention branch
   (``LM_LOGIT_ATOL``; routing flips per layer between the branches and the
   prefill's drop share printed, the slots each layer kept held against a
   host recount; a 2-layer stack of the same width under
   ``SHALLOW_LOGIT_RTOL`` where flips explain a full-depth difference),
   profiles one prefill and one decode step; then runs ``moe_dispatch`` at
   its layer width (x (8192, 2048) bf16 i.i.d., and layer 24's input in the
   served prefill, where slots are dropped; layer 24's experts) through
   ``engine.run`` on ``LocalSubstrate`` in ep_push, ep_pull (P = 8) and tp,
   each equal to ``moe_dispatch_reference``, its dropped slots to a plain
   recount and its traffic to the replay's, ``"auto"`` a plan-cache hit, the
   ``cuda`` substrate refusing the op; and ``DecodeServer`` through the
   ``EngineService`` worker loop at W = 1 and 2 for serve-moe (float32) and
   moonshot's one-block decode params (bf16, full width), every mode's
   tokens equal to the oracle's (``decode {...}`` lines);
7b. serves the other families at full width (phases "LM serve (<arch>,
   <family>, full width)"), each freed before the next: zamba2-2.7b (54
   Mamba-2 layers, the shared attention block at 9 points, 2048-token
   prompts), rwkv6-3b (32 layers, no attention), whisper-small (12 + 12
   layers over 1500 stub frames, 224-token prompts, 32 tokens) and
   phi-3-vision-4.2b (32 layers, 576 stub patches before 1472-token
   prompts), each at B = 4 with an ``lm {...}`` line and its flash launches
   counted by instance (9, 0, 36 a prefill + 12 a decode step, 32); layer 0
   of each flash instance against the plain version and the flash prefill
   and 4 teacher-forced decode steps against the reference attention
   branch (``FAMILY_LOGIT_RTOL``); for zamba2 and rwkv6 prefill(S) against
   prefill(S - 4) and 4 decode steps; the reduced float32 rwkv6 on the card
   against the CPU; one prefill and one decode step of each profiled;
7c. trains (phases "LM train ..."): llama3.2-3b at full width (28 layers,
   bf16, weights from seed 0 on the card, remat on, the reference attention
   branch: the flash kernel has no backward) for 4 ``api.train_step``s on
   ``SyntheticTokens`` batches of 4 x 2048, with a ``train {...}`` line (step
   ms, tokens/s, ``apply_updates`` ms timed alone, peak GiB, losses and grad
   norms, all finite) and one step under torch.profiler; the grads of
   ``loss_fn`` (remat, chunked CE, checkpointed q tiles) against the plain
   path's (no remat, dense attention, full-logits cross-entropy) at llama's
   widths cut to 2 layers in float32; the reduced float32 config trained
   5 steps on the card and on the CPU (losses equal within 1e-4) and under
   ``run_supervised`` on the card with a failure injected at step 8 (one
   restart, the unfailed run's last losses); moonshot-v1-16b-a3b at full
   width cut to 2 of 48 layers, bf16, 3 steps (grads through routing and
   capacity buffers; the forward's drop share printed); rwkv6-3b,
   zamba2-2.7b (its chunks of 256), whisper-small (4 x 448 over 1500
   frames) and phi-3-vision-4.2b (576 patches + 1472 tokens) unsharded at
   full width and depth, a warm and a timed step each (phases "LM train
   (<arch>, full width, unsharded)": step ms, positions/s, peak GiB, finite
   losses and grad norms);
7d. runs the LM on its ``(data, model)`` mesh (phase "LM (data, model)
   mesh, 2 x 2 rank processes on the card"): flash_attn first at a rank's
   head counts against its plain version; then 4 gloo rank processes share
   the card (collectives staged through pinned host memory), each drawing
   every weight from seed 0 and keeping its block: llama3.2-3b at full
   width, a 4 x 2048 flash prefill (28 flash launches a rank), 2 decode
   steps fed the unsharded model's greedy tokens and one train step, held
   to the unsharded model (logits ``LM_LOGIT_ATOL``, loss
   ``MESH_LOSS_ATOL``); moonshot-v1-16b-a3b cut to 4 layers in ep_push,
   ep_pull and tp at factor 11 (no slot dropped; logits held) and 1.25
   (each mode's drop share); ``lm_mesh {...}`` lines with ms, collective
   calls and seconds a call per axis, flash launches and memory a rank;
   every rank closed and its exit code 0;
7e. runs the ssm, hybrid and encdec families on a new 2 x 2 mesh of rank
   processes on the card (phase "LM (data, model) mesh: ssm, hybrid,
   encdec"): rwkv6-3b, zamba2-2.7b and whisper-small at full width and
   depth, each drawn from seed 0 by the ranks, a prefill at its
   ``FAMILIES`` prompt and LM_BATCH and 2 decode steps fed the unsharded
   model's greedy tokens, held to its logits (``LM_LOGIT_ATOL``); then one
   train step at full width and cut depth (``MESH_FAMILY_TRAIN``), its loss
   held to the unsharded loss (``MESH_LOSS_ATOL``); flash launches a rank a
   prefill as ``flash_per_serve`` counts them; an ``lm_mesh {...}`` line a
   family and an ``lm_mesh_families_summary`` line (``model`` calls a
   call); every rank closed and its exit code 0; then phi-3-vision-4.2b the
   same way on a mesh of its own (phase "LM mesh (phi-3-vision-4.2b, 2 x 2,
   one card)": 576 stub patches before 1472 tokens, 32 flash launches a
   rank at D 96, the train step at 4 of 32 layers; ``lm_mesh_vlm_summary``);
7f. holds the dry-run against the card (phase "dry-run vs the card"):
   every call of 7d and 7e and every unsharded train run of 7c traced by
   ``launch/dryrun.py`` (rank 0 on the meta device, 6 processes at once)
   at the same config, depth, batch, sequence and mesh shape; the traced
   collective calls per axis equal to the mesh's, the predicted peak a rank
   within ``DRYRUN_PEAK_BAND`` of the measured one, and the roofline's
   compute, memory and collective terms printed beside the measured ms (a
   ``dryrun {...}`` line a cell); then traces rwkv6-3b's and zamba2-2.7b's
   train_4k and prefill_32k cells on the single-pod mesh (phase "dry-run
   compute term"; a ``dryrun_split {...}`` line a cell with its three
   terms);
8. holds every kernel against its plain PyTorch version at the main path's
   shapes and times kernel, plain version and a one-call PyTorch yardstick
   with CUDA events, beside the least time the card could take (bound),
   the share of it reached and the rate (GB/s where bytes bound the
   kernel, TFLOP/s where operations do); bfs_expand in every round of the
   main path's BFS, on the graph's (P, V_p, K) planes as ``bfs_cuda`` hands
   them over, with its occupancy at the main path's grain and the sums of
   the round times and bounds; flash attention on layer 0's q, k, v
   captured from the prefill, on moonshot-v1-16b-a3b's (head dim 128, 16
   kv heads for 16 q heads) and on each instance the families of 7b
   captured (whisper's encoder, decoder and cross attention at prefill and
   its cross attention at decode, zamba2's D 80, phi-3-vision's D 96)
   likewise, at full layer shapes of head dim 32 (bf16 and float32), each
   at its kernel's k tile, and on small cases of every mask kind at head
   dims 20 to 128; topk_sim also at a 32x32 grid; and counts the
   tensor-core instructions (``cuobjdump -sass``) in the built flash_attn
   library.

Prints RunReport rows, then a ``{"kernels": [...]}`` line, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
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
# the same on 2-layer stacks, relative to the reference's largest |logit|.
# On the CPU (the kernels' plain versions) the two branches differed by
# 0.004 of 0.68 (reduced llama, bf16), 0.047 of 4.9 (phi-3 text stack, bf16)
# and 3.4e-7 of 0.67 (reduced llama, float32); a non-causal mask moved them
# by 0.27 and 1.3, and a zero attention output by 0.47 and 6.5
SHALLOW_LOGIT_RTOL = {"bfloat16": 2**-4, "float32": 1e-4}
# the flash kernel against its plain version at the same k blocks
# (kernel_block_k): in bf16 the output rounds to bf16, one ulp is 2**-8
# relative
FLASH_BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
FLASH_F32_TOL = dict(rtol=1e-5, atol=1e-5)  # float32 sums in another order
# the stripe kernel's second matrix: 2^20 rows, average degree 8, 524 hub
# rows of degree 512 (dense ELL planes of 4.3 GB), striped at this grain
SKEWED, SKEWED_GRAIN = dict(n=1 << 20, avg_deg=8.0, max_deg=512, seed=0), 256
# GSANA's coarse grid: buckets of about this many vertices (a 16x16 grid at
# n = 131072), which take topk_sim's wide instance
COARSE_BUCKET = 512
# the reduced LM (head dim 32) served in both types: batch, prompt, tokens
REDUCED_BATCH, REDUCED_PROMPT, REDUCED_GEN = 4, 256, 8
# the families past dense and MoE, each served at full width through
# lm_serve at the LM's batch (bf16, random weights from seed 0, flash
# attention where the family has attention) after the MoE phases: (arch,
# prompt tokens, greedy tokens). whisper-small's 224 + 32 positions stay
# within its decoder's 448 over 1500 frames; phi-3-vision-4.2b's prompt
# follows its 576 patches, 2048 positions in all. phi-3-vision-4.2b runs
# flash_attn's tensor-core instance for head dims below 128 at D 96
# (flash_tc_kernel<128, false>), zamba2-2.7b the same at D 80
FAMILIES = (("zamba2-2.7b", 2048, 8), ("rwkv6-3b", 2048, 8), ("whisper-small", 224, 32),
            ("phi-3-vision-4.2b", 2048 - 576, 8))
# those families' flash prefill and teacher-forced decode against the
# reference attention branch, and the recurrent families' prefill(S)
# against prefill(S - STEPWISE_STEPS) and STEPWISE_STEPS decode steps (the
# chunked scan against the one-token recurrence), at full depth in bf16:
# relative to the reference's largest |logit|, as SHALLOW_LOGIT_RTOL. The
# two sides round to bf16 at other places (p before PV in flash; GEMMs of
# other heights; the scan's chunk outputs against one token's), 2**-8
# relative each, carried through 32 to 54 layers; an error in either (a
# mask, a position, a decay, a dropped state) moves logits by a share of
# their size, as the 2-layer stacks' faults did (0.27 and 0.4 of it). On an
# H100 the two sides differed by 0.013 (whisper-small) to 0.047
# (phi-3-vision-4.2b) of it against the reference branch, and by 0.040
# (zamba2-2.7b) and 0.056 (rwkv6-3b) prefill against stepwise decode
FAMILY_LOGIT_RTOL, STEPWISE_STEPS = 2**-3, 4
# the reduced float32 rwkv6 config served on the card and on the CPU:
# cuBLAS sums in other orders than the CPU's BLAS (TF32 off)
CARD_VS_CPU_TOL = dict(rtol=1e-4, atol=1e-4)
# the serving phase: requests of the mixed stream (the six main-path
# signatures in turn) and the executor-pool widths it is served at
SERVE_REQUESTS, SERVE_WORKERS = 24, (1, 2, 4)
# the cluster phase: worker processes a cluster (one EngineService each, one
# pool slot), and the least ratio of the bytes an inline base64 wire would
# have sent for the stream to what the framed wire sent (the JAX package's
# data-plane gate, benchmarks/cluster_suite.py --require-wire-reduction)
CLUSTER_WORKERS, CLUSTER_WIRE_REDUCTION = (1, 2, 4), 3.0
# the MoE LM served at full width (48 layers, 64 experts top-6, bf16) at the
# LM's batch and prompt, greedy tokens; the depth of the stack the flash
# and reference branches are held on instead if routing flips explain a
# full-depth difference past LM_LOGIT_ATOL (fixed before the first run)
MOE_ARCH, MOE_GEN, MOE_FALLBACK_LAYERS = "moonshot-v1-16b-a3b", 8, 2
# the served prefill's layer whose MoE input, router and experts moe_dispatch
# also runs on: routing of real hidden states fills experts past capacity,
# which i.i.d. inputs at the router's init scale do not
MOE_DISPATCH_LAYER = 24
# DecodeServer: (config, nodelets of the ep modes) served in bf16 and
# float32 as the configs give them; sequences, new tokens each, batch slots
DECODE_CONFIGS = (("serve-moe", 4), ("moonshot-v1-16b-a3b", 8))
DECODE_SEQS, DECODE_NEW, DECODE_CAPACITY = 8, 8, 8
# the mesh phase: the main path's nodelets as rank processes, and the
# DecodeServer's expert-parallel width there (serve-moe's 8 experts over 4)
MESH_RANKS, MESH_DECODE_RANKS = 8, 4
# training at full width: batch x sequence (8,192 tokens a step), AdamW, the
# steps of llama3.2-3b and of moonshot-v1-16b-a3b cut to 2 of its 48 layers
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 4
TRAIN_OPT = dict(lr=3e-4, warmup_steps=1, total_steps=4)
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 3
# remat + chunked CE + checkpointed q tiles against the plain path at
# llama's widths cut to 2 layers, float32 without TF32: each parameter's
# relative Frobenius error. The two do the same float32 operations summed in
# other orders (the CE by chunks, scores by q tiles, the embedding's grad by
# atomics), a few ulps; a dropped or doubled activation is off by whole
# units
REMAT_LAYERS, REMAT_GRAD_RTOL = 2, 1e-4
# the LM's (data, model) mesh on the card: the mesh shape (4 rank processes
# sharing the card, gloo, every collective staged through pinned host
# memory), llama3.2-3b's decode steps on it (2.9-4.8 s each on an H100; 8 of
# them took the phase to 128-162 s, 4 to 110 s; 2 since the families' mesh
# phase follows it), moonshot-v1-16b-a3b cut to
# MESH_MOE_LAYERS of its 48 layers, a capacity factor at which no slot can
# drop (at least experts / top-k = 64 / 6: every expert's buffer holds every
# token, in every mode and in the unsharded sublayer; at 8, 651 of 196,608
# slots dropped on an H100, real hidden states routing unevenly), and the step-1
# loss bound: the sharded and unsharded steps sum the same bf16 products in
# other orders (a few 1e-3 of the loss; a wrong shard is off by whole units)
MESH_LM_SHAPE, MESH_LM_GEN = (2, 2), 2
MESH_MOE_LAYERS, MESH_NODROP_CF, MESH_LOSS_ATOL = 4, 11.0, 0.01
MESH_LM_TIMEOUT_S = 900.0
# the ssm, hybrid and encdec families on a 2 x 2 mesh on the card: served at
# full width and depth (their FAMILIES prompt, LM_BATCH rows, greedy decode
# steps), and one train step at full width, TRAIN_BATCH rows, cut to (layers,
# sequence): rwkv6-3b 4 of 32 layers, zamba2-2.7b one shared-attention group
# (6 of 54 layers, 2 microbatches), whisper-small whole at its decoder's 448
# positions over its 1500 frames
MESH_FAMILIES, MESH_FAMILY_GEN = ("rwkv6-3b", "zamba2-2.7b", "whisper-small"), 2
MESH_FAMILY_TRAIN = {"rwkv6-3b": (4, TRAIN_SEQ), "zamba2-2.7b": (6, TRAIN_SEQ),
                     "whisper-small": (12, 448), "phi-3-vision-4.2b": (4, TRAIN_SEQ)}
# the vlm family on its own 2 x 2 mesh on the card, as the families above:
# served at full width and depth (576 stub patches before its FAMILIES
# prompt, flash at D 96 over a rank's 16 / 16 heads), one train step at full
# width cut to 4 of 32 layers over 2048 positions (the patches and 1472
# tokens)
MESH_VLM = "phi-3-vision-4.2b"
# the dry-run's terms of the production cells of rwkv6-3b (its time mix and
# decay LoRA split over "model" as GSPMD splits them) and zamba2-2.7b (its
# Mamba-2 scores local), on the single-pod mesh: traced on the meta device
# in DRYRUN_WORKERS processes.
# The train and prefill cells only: decode's trace takes a second from the
# CLI (``python -m repro_torch.launch.dryrun``), and these run at once
DRYRUN_SPLIT_ARCHS, DRYRUN_SPLIT_SHAPES = ("rwkv6-3b", "zamba2-2.7b"), ("train_4k", "prefill_32k")
# the reduced float32 LM trained on the card and on the CPU, and the
# supervised run's recovery: losses, relative. cuBLAS sums in other orders
# than the CPU's BLAS, and the backward of a row gather (the embedding; the
# MoE capacity buffers) adds with float atomics in no fixed order on the
# card, so grads agree to rounding, not bit for bit
REDUCED_TRAIN_STEPS, TRAIN_LOSS_RTOL = 5, 1e-4
# the families past the dense and MoE LMs trained unsharded on the card at
# full width and depth (bf16, remat, the reference attention branch, AdamW
# as the llama train cell), TRAIN_BATCH rows of (arch, positions a row):
# TRAIN_SEQ where the family takes it, whisper-small's decoder at its 448
# positions over its 1500 frames, phi-3-vision-4.2b's 576 stub patches
# before 1472 tokens; zamba2-2.7b at its own ssm_chunk (256). One warm step
# and one timed step each
FAMILY_TRAIN = (("rwkv6-3b", TRAIN_SEQ), ("zamba2-2.7b", TRAIN_SEQ), ("whisper-small", 448),
                ("phi-3-vision-4.2b", TRAIN_SEQ))
FAMILY_TRAIN_STEPS = 2
# the dry-run (launch/dryrun.py) against the card: the traced peak a rank
# over the measured one (a mesh rank's peak during the call; an unsharded
# step's peak less what the process held before its weights were drawn)
# must lie in this band, fixed before the dry-run first met the card; the
# cells are traced in this many processes at once
DRYRUN_PEAK_BAND, DRYRUN_WORKERS = (0.8, 1.25), 6


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
        self.cells: list[dict] = []  # calls the dry-run phase traces (dryrun_vs_card)

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
    serving = smoke.phase("serving plane (EngineService on cuda)", serving_path, smoke, inputs)
    if serving is not None:
        smoke.phase("cluster plane (worker processes on the card)", cluster_path, smoke, inputs,
                    serving)
    smoke.phase(f"mesh substrate (P = {MESH_RANKS} rank processes on the card)", mesh_path, smoke,
                inputs)
    smoke.phase("CSR-stripe SpMV through spmv(variant='stripe'), timed", stripe_path, smoke,
                inputs)
    smoke.phase(f"GSANA at a coarse grid (pick_grid(n, {COARSE_BUCKET})) through engine.run, "
                "topk_sim timed", coarse_gsana_path, smoke, inputs)
    smoke.phase("autotune + calibration (cuda)", autotune_path, smoke, inputs)
    lm = smoke.phase(f"LM serve ({LM_ARCH}, flash)", lm_serve_path, smoke, dev)
    if lm is not None:
        smoke.phase("LM flash prefill and decode vs the reference attention branch",
                    lm_vs_reference, smoke, lm)
    reduced = smoke.phase(f"LM serve (reduced {LM_ARCH}, head dim 32, flash) vs the reference "
                          "attention branch", reduced_lm_path, smoke, dev)
    smoke.phase("cuda vs local substrate on small inputs", small_agreement, smoke, dev)
    smoke.phase("device time per request (torch.profiler)", profile_requests, inputs, lm)
    if lm is not None:  # later phases read only llama's captured q, k, v and launches
        del lm["model"]
    torch.cuda.empty_cache()
    moe = smoke.phase(f"LM serve ({MOE_ARCH}, MoE, flash)", lm_serve_path, smoke, dev, MOE_ARCH,
                      MOE_GEN)
    if moe is not None:
        held = smoke.phase(f"LM ({MOE_ARCH}) flash prefill and decode vs the reference attention "
                           "branch, routing flips and drop share", moe_lm_vs_reference, smoke, moe)
        smoke.phase(f"device time of one {MOE_ARCH} prefill and decode step (torch.profiler)",
                    profile_lm, moe)
        # one layer's experts stay for moe_dispatch; the rest of the stack goes
        blk = moe.pop("model").blocks[MOE_DISPATCH_LAYER].moe
        experts = tuple(w.detach() for w in (blk.w_gate, blk.w_up, blk.w_down))
        del blk
        torch.cuda.empty_cache()
        smoke.phase("moe_dispatch through engine.run (moonshot layer width)", moe_dispatch_path,
                    smoke, experts, held and held["served"], dev)
        del experts, held
        torch.cuda.empty_cache()
    smoke.phase("DecodeServer through EngineService", decode_server_path, smoke, dev)
    torch.cuda.empty_cache()
    families = family_phases(smoke, dev)
    smoke.phase(f"LM train ({LM_ARCH}, full width)", lm_train_path, smoke, dev)
    smoke.phase("LM train: remat and chunked loss vs the plain loss", remat_vs_plain, smoke, dev)
    smoke.phase(f"LM train (reduced {LM_ARCH}): card vs CPU, supervised recovery",
                reduced_train_path, smoke, dev)
    smoke.phase(f"LM train ({MOE_ARCH}, full width, {MOE_TRAIN_LAYERS} of 48 layers)",
                moe_train_path, smoke, dev)
    for arch, seq in FAMILY_TRAIN:
        smoke.phase(f"LM train ({arch}, full width, unsharded)", family_train_path, smoke, dev,
                    arch, seq)
    torch.cuda.empty_cache()
    smoke.phase("flash_attn at the LM mesh ranks' head counts vs plain version",
                flash_at_rank_shapes, smoke, dev)
    smoke.phase(f"LM (data, model) mesh, {MESH_LM_SHAPE[0]} x {MESH_LM_SHAPE[1]} rank processes "
                "on the card", lm_mesh_path, smoke, dev)
    smoke.phase("LM (data, model) mesh: ssm, hybrid, encdec, "
                f"{MESH_LM_SHAPE[0]} x {MESH_LM_SHAPE[1]} rank processes on the card",
                lm_mesh_families_path, smoke, dev)
    smoke.phase(f"LM mesh ({MESH_VLM}, {MESH_LM_SHAPE[0]} x {MESH_LM_SHAPE[1]}, one card)",
                lm_mesh_vlm_path, smoke, dev)
    smoke.phase("dry-run vs the card", dryrun_vs_card, smoke)
    smoke.phase(f"dry-run compute term, {' and '.join(DRYRUN_SPLIT_ARCHS)} production cells "
                "(single pod)", dryrun_split_cells, smoke)
    if launches is not None:
        smoke.phase("kernels vs plain versions, timed", kernels_vs_plain, smoke, inputs, launches)
    if lm is not None:
        smoke.phase("flash_attn vs plain version, timed", flash_vs_plain, smoke, lm, reduced, moe,
                    families)
    return finish(smoke)


def family_phases(smoke: Smoke, dev) -> dict:
    """The :data:`FAMILIES` at full width, one after another, each freed
    before the next: the serve, its flash prefill and decode against the
    reference attention branch (the families with attention), prefill(S)
    against prefill(S - 4) and 4 decode steps (the recurrent families), the
    reduced float32 rwkv6 on the card against the CPU, and the profiler rows
    of a prefill and a decode step. Returns each served family's captures
    and flash tallies (its weights dropped)."""
    from repro_torch.configs import get_config

    served = {}
    for arch, prompt, gen in FAMILIES:
        family = get_config(arch).family
        fam = smoke.phase(f"LM serve ({arch}, {family}, full width)", lm_serve_path, smoke, dev,
                          arch, gen, prompt)
        if fam is None:
            continue
        if fam["captures"]:
            smoke.phase(f"LM ({arch}) flash prefill and decode vs the reference attention branch",
                        lm_vs_reference, smoke, fam, FAMILY_LOGIT_RTOL)
        if family in ("ssm", "hybrid"):
            smoke.phase(f"LM ({arch}) prefill(S) vs prefill(S - {STEPWISE_STEPS}) and "
                        f"{STEPWISE_STEPS} decode steps", chunked_vs_stepwise, smoke, fam)
        if family == "ssm":
            smoke.phase(f"LM (reduced {arch}, float32): card vs CPU", reduced_card_vs_cpu, smoke, dev, arch)
        smoke.phase(f"device time of one {arch} prefill and decode step (torch.profiler)",
                    profile_lm, fam)
        del fam["model"]
        torch.cuda.empty_cache()
        served[arch] = fam
    return served


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


def serve_signatures(inputs: dict) -> list:
    """The six main-path signatures ``(op, inputs, strategy)`` the serving
    phase rotates over: SpMV with S1 on and off, BFS remote_write and
    migrate, GSANA HCB/PAIR and BLK/PAIR."""
    from repro_torch.core import Comm, Layout, MigratoryStrategy, Scheme

    return [
        ("spmv", inputs["spmv"], MigratoryStrategy()),
        ("spmv", inputs["spmv"], MigratoryStrategy(replicate_x=False)),
        ("bfs", inputs["bfs"], MigratoryStrategy(comm=Comm.REMOTE_WRITE)),
        ("bfs", inputs["bfs"], MigratoryStrategy(comm=Comm.MIGRATE)),
        ("gsana", inputs["gsana"], MigratoryStrategy(layout=Layout.HCB, scheme=Scheme.PAIR)),
        ("gsana", inputs["gsana"], MigratoryStrategy(layout=Layout.BLK, scheme=Scheme.PAIR)),
    ]


def same_result(got, want) -> bool:
    if isinstance(want, tuple):
        return len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))
    return torch.equal(got, want)


def serving_path(smoke: Smoke, inputs: dict) -> None:
    """The main path served by ``EngineService`` on the cuda substrate: batch
    mode, the worker loop at each width of ``SERVE_WORKERS`` under open-loop
    arrivals (every result ``torch.equal`` to ``engine.run``, every kernel
    launched through the service, counted exactly), a request whose inputs
    are still being written on the default stream when it is submitted,
    dedup and coalescing (with the content hash's host time), admission
    rejection, a deadline, and ``autotune=True``."""
    from repro_torch.engine import (
        AdmissionError, CudaSubstrate, EngineService, PlanCache, Request, ServiceTimeout,
        SpMVInputs, choose_strategy, run, strategy_dict,
    )
    from repro_torch.engine.service import _content_hash
    from repro_torch.kernels.bfs.kernel import bfs_expand
    from repro_torch.kernels.spmv.kernel import spmv_ell
    from repro_torch.kernels.topk_sim.kernel import topk_sim

    dev = inputs["spmv"].x.device
    sub = CudaSubstrate(dev)
    kernels = (spmv_ell, bfs_expand, topk_sim)
    sigs = serve_signatures(inputs)
    order = [i % len(sigs) for i in range(SERVE_REQUESTS)]

    def launches_of(body):
        for k in kernels:
            k.launches = 0
        out = body()
        return out, {k.__name__: k.launches for k in kernels}

    # engine.run of each signature: the results to hold the service to, and
    # the launches one call of it makes
    want, per_call = [], []
    for op, inp, st in sigs:
        (result, _), counts = launches_of(lambda: run(Request(op, inp, st, sub), iters=1, warmup=0))
        want.append(result)
        per_call.append(counts)
    expected = {k.__name__: sum(per_call[i][k.__name__] for i in order) for k in kernels}

    def check_results(responses, what):
        for i, resp in zip(order, responses):
            smoke.check(resp.report.substrate == "cuda", f"{what}: served on {resp.report.substrate}")
            smoke.check(same_result(resp.result, want[i]),
                        f"{what}: request {resp.ticket} ({sigs[i][0]}) differs from engine.run")

    # batch mode: one compile per plan key, results equal to engine.run
    svc = EngineService(cache=PlanCache(), substrate=sub, device=dev)
    for i in order:
        svc.submit(Request(*sigs[i]))
    responses, counts = launches_of(svc.drain)
    stats = svc.stats()
    check_results(responses, "batch")
    smoke.check(stats.compiles == len(sigs) and stats.cache_hits == SERVE_REQUESTS - len(sigs),
                f"batch: {stats.compiles} compiles, {stats.cache_hits} hits")
    smoke.check(counts == expected, f"batch launches {counts}, expected {expected}")
    mean_s = stats.run_seconds / max(1, stats.cache_hits)
    rate = 2.0 / mean_s  # twice what one worker sustains, so queues form
    print(f"  batch: {stats.requests} requests, {stats.compiles} compiles, "
          f"{stats.wall_seconds * 1e3:.3f} ms, mean warm request {mean_s * 1e3:.4f} ms; "
          f"launches {counts}; open-loop rate {rate:.1f} req/s", flush=True)

    # the worker loop at each pool width, open-loop jittered arrivals
    rows = []
    for workers in SERVE_WORKERS:
        rng = np.random.default_rng(0)
        svc = EngineService(cache=PlanCache(), substrate=sub, device=dev, workers=workers,
                            qos={"bfs": 2.0}, batch_window=0.02)

        def serve():
            svc.start()
            try:
                futures = []
                for i in order:
                    futures.append(svc.submit(Request(*sigs[i])))
                    time.sleep((0.5 + rng.random()) / rate)
                return [f.result(timeout=600) for f in futures]
            finally:
                svc.stop(timeout=600)

        responses, counts = launches_of(serve)
        check_results(responses, f"W={workers}")
        stats = svc.stats()
        smoke.check(stats.errors == 0 and stats.requests == SERVE_REQUESTS,
                    f"W={workers}: {stats.errors} errors, {stats.requests} requests")
        smoke.check(counts == expected, f"W={workers}: launches {counts}, expected {expected}")
        by_op: dict[str, list[float]] = {}
        for resp in responses:
            by_op.setdefault(resp.report.op, []).append(resp.report.seconds * 1e3)
        report = svc.throughput_report()
        rows.append({"workers": workers, "requests_per_second": stats.requests_per_second,
                     "total_p50_ms": stats.total_p50 * 1e3, "total_p99_ms": stats.total_p99 * 1e3})
        print("  service " + json.dumps({
            "workers": workers, "requests": stats.requests, "rate_offered": rate,
            "requests_per_second": stats.requests_per_second,
            "total_p50_ms": stats.total_p50 * 1e3, "total_p99_ms": stats.total_p99 * 1e3,
            "queue_wait_p50_ms": stats.queue_wait_p50 * 1e3,
            "queue_wait_p99_ms": stats.queue_wait_p99 * 1e3,
            "service_p50_ms": stats.service_p50 * 1e3, "service_p99_ms": stats.service_p99 * 1e3,
            "seconds_p50_ms": {op: float(np.median(v)) for op, v in by_op.items()},
            "worker_occupancy": stats.worker_occupancy, "worker_requests": stats.worker_requests,
            "steals": stats.steals, "compiles": stats.compiles,
            "compile_ms": stats.compile_seconds * 1e3, "overlap_ms": stats.overlap_seconds * 1e3,
            "overlap_ratio": stats.overlap_ratio, "busy_ms": stats.busy_seconds * 1e3,
            "wall_ms": stats.wall_seconds * 1e3, "launches": counts,
            "cache_hits": report["cache"]["hits"]}), flush=True)

    # inputs still being written on the default stream when submitted: the
    # slot's stream waits for them (a queued sleep holds the default stream)
    svc = EngineService(cache=PlanCache(), substrate=sub, device=dev, workers=2).start()
    try:
        svc.submit(Request(*sigs[0])).result(timeout=600)  # warm the plan
        torch.cuda._sleep(200_000_000)  # about 0.1 s of the default stream
        x2 = inputs["spmv"].x * 2.0
        fut = svc.submit(Request("spmv", SpMVInputs(inputs["spmv"].a, x2), sigs[0][2]))
        got = fut.result(timeout=600).result
    finally:
        svc.stop(timeout=600)
    torch.cuda.synchronize()
    want_x2, _ = run(Request("spmv", SpMVInputs(inputs["spmv"].a, x2), sigs[0][2], sub),
                     iters=1, warmup=0)
    smoke.check(torch.equal(got, want_x2), "inputs written on the default stream: the served "
                "result differs (the slot's stream did not wait for them)")

    # dedup: 8 identical SpMV submissions, one execution
    hash_ms = {}
    for op in ("spmv", "bfs", "gsana"):
        t0 = time.perf_counter()
        _content_hash(op, inputs[op], None, sub)
        hash_ms[op] = (time.perf_counter() - t0) * 1e3
    svc = EngineService(cache=PlanCache(), substrate=sub, device=dev, workers=2, dedup=True,
                        batch_window=0.05).start()
    try:
        futures = [svc.submit(Request(*sigs[0])) for _ in range(8)]
        results = [f.result(timeout=600).result for f in futures]
    finally:
        svc.stop(timeout=600)
    stats = svc.stats()
    smoke.check(stats.compiles + stats.cache_hits == 1 and stats.dedup_hits == 7,
                f"dedup: {stats.compiles + stats.cache_hits} executions, {stats.dedup_hits} dedup hits")
    smoke.check(all(same_result(r, want[0]) for r in results), "dedup: results differ")
    print(f"  dedup: 8 submissions, {stats.compiles + stats.cache_hits} execution, "
          f"{stats.dedup_hits} deduped ({stats.dedup_coalesced} coalesced in flight); content "
          f"hash ms on the host: {json.dumps(hash_ms)}", flush=True)

    # admission: a burst of 16 into a depth-2 rejecting queue
    svc = EngineService(cache=PlanCache(), substrate=sub, device=dev, workers=2,
                        admission="reject", max_queue_depth=2).start()
    admitted, rejected = [], 0
    try:
        for i in range(16):
            try:
                admitted.append((i % len(sigs), svc.submit(Request(*sigs[i % len(sigs)]))))
            except AdmissionError:
                rejected += 1
        answered = [(i, f.result(timeout=600).result) for i, f in admitted]
    finally:
        svc.stop(timeout=600)
    smoke.check(rejected > 0 and rejected == svc.stats().rejected,
                f"admission: {rejected} rejected, stats {svc.stats().rejected}")
    smoke.check(all(same_result(r, want[i]) for i, r in answered),
                "admission: an admitted request was answered wrongly")
    print(f"  admission: burst of 16, depth 2: {len(answered)} admitted and answered, "
          f"{rejected} rejected", flush=True)

    # a deadline: timeout=0 queued behind a GSANA request is shed
    svc = EngineService(cache=PlanCache(), substrate=sub, device=dev).start()
    try:
        slow = svc.submit(Request(*sigs[4]))
        late = svc.submit(Request(*sigs[0], timeout=0.0))
        slow.result(timeout=600)
        shed = isinstance(late.exception(timeout=600), ServiceTimeout)
    finally:
        svc.stop(timeout=600)
    smoke.check(shed and svc.stats().timed_out == 1, "deadline: the late request was not shed")
    print(f"  deadline: timeout=0 behind GSANA shed with ServiceTimeout "
          f"(timed_out {svc.stats().timed_out})", flush=True)

    # autotune=True: the scheduler's picks against the serial choose_strategy
    svc = EngineService(cache=PlanCache(), substrate=sub, device=dev, workers=2,
                        autotune=True).start()
    try:
        futures = {op: svc.submit(Request(op, inputs[op])) for op in ("spmv", "bfs", "gsana")}
        picks = {op: f.result(timeout=600).report.strategy for op, f in futures.items()}
    finally:
        svc.stop(timeout=600)
    for op, pick in picks.items():
        serial = strategy_dict(choose_strategy(op, inputs[op], sub))
        print(f"  autotune service {op}: {pick} (serial choose_strategy: "
              f"{'same' if pick == serial else serial})", flush=True)
    return {"rate": rate, "service": rows}


def inline_frame_bytes(request) -> int:
    """Bytes one submit of ``request`` takes on an inline wire (an 8-byte
    length prefix, then the whole request as JSON with every array in
    base64), computed from the framed encoding without building the base64
    text."""
    from repro_torch.engine import SegmentTable

    table = SegmentTable()
    payload = request.to_wire(segments=table)

    def inline(node):
        if isinstance(node, dict):
            if node.get("__wire__") == "ndref":
                return {"__wire__": "nd", "dtype": node["dtype"], "shape": node["shape"], "data": ""}
            return {k: inline(v) for k, v in node.items()}
        if isinstance(node, list):
            return [inline(v) for v in node]
        return node

    frame = json.dumps({"kind": "submit", "request": inline(payload), "ticket": 0},
                       separators=(",", ":"))
    return 8 + len(frame.encode("utf-8")) + sum(4 * ((len(seg) + 2) // 3) for seg in table.segments)


def app_memory_mib() -> dict:
    """Card memory of each compute process, by pid, as nvidia-smi lists them
    (empty where it lists none, as it may in a container)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    mem = {}
    for line in out.stdout.strip().splitlines():
        pid, _, used = line.partition(",")
        if pid.strip().isdigit() and used.strip().isdigit():
            mem[int(pid)] = int(used)
    return mem


def cluster_path(smoke: Smoke, inputs: dict, serving: dict) -> None:
    """The serving phase's stream through worker processes on the card
    (``repro_torch.cluster``): for each size of :data:`CLUSTER_WORKERS`, a
    cluster of processes each running ``EngineService(substrate="cuda",
    workers=1)`` with its own CUDA context serves the 24 requests open loop
    at the serving phase's rate and once more as one burst, every result
    ``torch.equal`` to ``engine.run`` on the card; at two workers and more at
    least two served. The coordinator submits host copies of the inputs;
    each worker holds the blobs it serves on the card. At two workers the
    ``cluster`` substrate serves the stream through ``EngineService``
    (kernel forwarding), and a SIGKILL mid-burst fails over. Prints a
    ``cluster {...}`` line per size (requests/s, latency, served per worker,
    launch to ready, card memory per worker, blob hits and misses, the
    largest blob's verify ms, wire bytes against inline encoding, kernel
    launches per worker), held at :data:`CLUSTER_WIRE_REDUCTION`."""
    import os
    import signal

    from repro_torch.cluster import launch_cluster
    from repro_torch.cluster.blobs import blob_min_bytes_default
    from repro_torch.engine import CudaSubstrate, EngineService, PlanCache, Request, run
    from repro_torch.engine.wire import to_device

    dev = inputs["spmv"].x.device
    sigs = serve_signatures(inputs)
    order = [i % len(sigs) for i in range(SERVE_REQUESTS)]
    want = [to_device(run(Request(op, inp, st, CudaSubstrate(dev)), iters=1, warmup=0)[0], "cpu")
            for op, inp, st in sigs]
    host = {op: to_device(inputs[op], "cpu") for op in ("spmv", "bfs", "gsana")}
    host_sigs = [(op, host[op], st) for op, _, st in sigs]
    named = CudaSubstrate("cpu")  # crosses the wire by name; each worker builds it on its card

    def requests():
        return [Request(*host_sigs[i], named) for i in order]

    # every blob-sized tensor of the stream's inputs, counted once
    blob_bytes = {}
    for op in host:
        for t in dataclass_tensors(host[op]):
            if t.numel() * t.element_size() >= blob_min_bytes_default():
                blob_bytes[id(t)] = t.numel() * t.element_size()
    budget = 2 * sum(blob_bytes.values())
    inline = [inline_frame_bytes(r) for r in requests()]
    print(f"  inputs: {len(blob_bytes)} blobs, {sum(blob_bytes.values())} bytes; blob budget "
          f"{budget} bytes (REPRO_BLOB_BUDGET_BYTES); inline wire {sum(inline)} bytes a stream",
          flush=True)
    rate = serving["rate"]

    def check(responses, what):
        smoke.check(len(responses) == len(order), f"{what}: {len(responses)} responses")
        for i, resp in zip(order, responses):
            smoke.check(same_result(resp.result, want[i]),
                        f"{what}: request {resp.ticket} ({sigs[i][0]}) differs from engine.run")

    def drive(cluster, open_loop):
        rng = np.random.default_rng(0)
        futures = []
        for r in requests():
            futures.append(cluster.submit(r))
            if open_loop:
                time.sleep((0.5 + rng.random()) / rate)
        responses = [f.result(timeout=600) for f in futures]
        lat = sorted(f.done_at - f.submitted_at for f in futures)
        wall = max(f.done_at for f in futures) - min(f.submitted_at for f in futures)
        return responses, {"requests_per_second": len(futures) / wall,
                           "total_p50_ms": lat[len(lat) // 2] * 1e3,
                           "total_p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3}

    old_budget = os.environ.get("REPRO_BLOB_BUDGET_BYTES")
    os.environ["REPRO_BLOB_BUDGET_BYTES"] = str(budget)
    try:
        for n in CLUSTER_WORKERS:
            free_before, _ = torch.cuda.mem_get_info(dev)
            t0 = time.perf_counter()
            with launch_cluster(n, service_workers=1, activate=(n == 2), wait_timeout=300) as cluster:
                ready_s = time.perf_counter() - t0
                coord = cluster.coordinator
                responses, open_row = drive(cluster, open_loop=True)
                check(responses, f"cluster N={n} open loop")
                responses, burst_row = drive(cluster, open_loop=False)
                check(responses, f"cluster N={n} burst")
                free_after, _ = torch.cuda.mem_get_info(dev)
                stats = coord.stats()
                served = {w["worker_id"]: w["served"] for w in stats["workers"]}
                if n >= 2:
                    smoke.check(sum(1 for v in served.values() if v > 0) >= 2,
                                f"cluster N={n}: only {served} served (distribution is not real)")
                rows = {w: coord.worker_stats(w) for w in served}
                smi = app_memory_mib()
                ratio = 2 * sum(inline) / max(1, stats["wire_bytes_sent"])
                row = {
                    "workers": n, "launch_to_ready_s": ready_s, "open_loop": open_row,
                    "burst": burst_row, "rate_offered": rate, "served": served,
                    "card_mib_nvidia_smi": {w: smi.get(r["pid"]) for w, r in rows.items()},
                    "card_bytes_reserved": {w: r.get("device_memory", {}).get("reserved")
                                            for w, r in rows.items()},
                    "card_used_delta_bytes": free_before - free_after,
                    "worker_service_p50_ms": {w: r["service_p50"] * 1e3 for w, r in rows.items()},
                    "worker_total_p50_ms": {w: r["total_p50"] * 1e3 for w, r in rows.items()},
                    "blob_hits": stats["blob_hits"], "blob_misses": stats["blob_misses"],
                    "largest_blob_bytes": max(r["blob_store"]["largest_verified_bytes"]
                                              for r in rows.values()),
                    "largest_blob_verify_ms": max(r["blob_store"]["largest_verify_ms"]
                                                  for r in rows.values()),
                    "wire_bytes_sent": stats["wire_bytes_sent"], "inline_bytes": 2 * sum(inline),
                    "wire_reduction": ratio, "submits_coalesced": stats["submits_coalesced"],
                    "launches": {w: r["kernel_launches"] for w, r in rows.items()},
                }
                print("  cluster " + json.dumps(row), flush=True)
                smoke.check(ratio >= CLUSTER_WIRE_REDUCTION,
                            f"cluster N={n}: wire reduction {ratio:.2f}x < {CLUSTER_WIRE_REDUCTION}x")
                if n != 2:
                    continue
                # the forwarding path: the executor pool over the workers
                svc = EngineService(cache=PlanCache(), substrate="cluster", device="cpu",
                                    workers="auto").start()
                fwd_rates = []
                try:
                    for _ in range(2):  # cold (the coordinator's host models), then warm
                        t1 = time.perf_counter()
                        futures = [svc.submit(Request(*host_sigs[i], "cluster")) for i in order]
                        responses = [f.result(timeout=600) for f in futures]
                        fwd_rates.append(len(order) / (time.perf_counter() - t1))
                        check(responses, "EngineService(substrate='cluster')")
                finally:
                    svc.stop(timeout=600)
                smoke.check(coord.stats()["kernel_calls"] >= 2 * len(order),
                            "EngineService(substrate='cluster'): kernels did not cross processes")
                print(f"  cluster substrate: EngineService(substrate='cluster', workers='auto') "
                      f"over {n} workers ({svc.stats().workers} slots): {fwd_rates[0]:.1f} req/s "
                      f"cold, {fwd_rates[1]:.1f} warm, beside Cluster.submit's burst "
                      f"{burst_row['requests_per_second']:.1f}", flush=True)
                # one SIGKILL mid-burst: every future terminates, results equal
                before = coord.stats()
                futures = [cluster.submit(r) for r in requests()]
                victim = coord.healthy_workers()[0].worker_id
                cluster.kill_worker(victim, sig=signal.SIGKILL)
                responses = [f.result(timeout=600) for f in futures]
                check(responses, "cluster failover")
                after = coord.stats()
                smoke.check(after["failovers"] == before["failovers"] + 1 and after["n_healthy"] == 1,
                            f"cluster failover: {after['failovers']} failovers, "
                            f"{after['n_healthy']} healthy")
                print(f"  cluster failover: SIGKILL worker {victim} with {len(futures)} requests in "
                      f"flight; all terminated, bit-identical; retries "
                      f"{after['retries'] - before['retries']}, failovers {after['failovers']}, "
                      f"blob misses {after['blob_misses'] - before['blob_misses']}", flush=True)
    finally:
        if old_budget is None:
            os.environ.pop("REPRO_BLOB_BUDGET_BYTES", None)
        else:
            os.environ["REPRO_BLOB_BUDGET_BYTES"] = old_budget
    print("  serving phase beside it (threads in one process): " + json.dumps(serving["service"]),
          flush=True)


def mesh_path(smoke: Smoke, inputs: dict) -> None:
    """The ``mesh`` substrate on the card (phase "mesh substrate"): a
    nodelet mesh of :data:`MESH_RANKS` rank processes (one card, so gloo,
    every collective staged through pinned host memory; a ``mesh {...}``
    line with the backend, launch to ready and card memory a rank), the six
    main-path signatures through ``engine.run(..., "mesh")`` on the
    main path's full-size inputs, each beside the same signature's ``cuda``
    and ``local`` seconds and split into the ranks' compute, their
    collectives and the caller's overhead, each result equal to ``local``
    on the card (SpMV and BFS bit for bit, GSANA candidates and scores);
    ``moe_dispatch`` at the moonshot layer width (x (8192, 2048) bf16,
    router (2048, 64) float32 from numpy seed 3, 64 experts top-6, random
    bf16 expert weights from seed 0) in ep_push and ep_pull at 8 ranks and tp
    at 1, each equal to ``local``; ``DecodeServer`` for serve-moe through
    ``EngineService(substrate="mesh")`` at :data:`MESH_DECODE_RANKS` ranks,
    tokens equal to the ``local`` run's; ``measure_collectives`` over the
    8-rank mesh; then every mesh closed and no rank process left."""
    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.core import Comm, MigratoryStrategy
    from repro_torch.engine import (
        CudaSubstrate, DecodeServer, EngineService, LocalSubstrate, MeshSubstrate,
        MoEDispatchInputs, PlanCache, Request, run,
    )
    from repro_torch.launch.mesh import close_meshes, make_nodelet_mesh
    from repro_torch.machine.microbench import COLLECTIVE_SIZES, measure_collectives
    from repro_torch.models.transformer import moe_decode_params

    dev = inputs["spmv"].x.device
    cache = PlanCache()
    meshes = []
    try:
        free_before, _ = torch.cuda.mem_get_info(dev)
        mesh = make_nodelet_mesh(MESH_RANKS, dev)
        meshes.append(mesh)
        free_after, _ = torch.cuda.mem_get_info(dev)
        reserved = [r.get("reserved_bytes", 0) for r in mesh.memory()]
        print(f"  mesh: {mesh.describe()}", flush=True)
        print("  mesh " + json.dumps({
            "ranks": mesh.p, "backend": mesh.backend, "staged_through_host": list(mesh.staged),
            "launch_to_ready_s": mesh.ready_seconds,
            "card_used_per_rank_gib": (free_before - free_after) / mesh.p / 2**30,
            "reserved_per_rank_gib": [b / 2**30 for b in reserved],
            "nvidia_smi_mib_by_pid": {str(pid): mib for pid, mib in app_memory_mib().items()
                                      if pid in mesh.pids},
        }), flush=True)
        mesh_sub = MeshSubstrate(dev)
        smoke.check(mesh_sub.mesh_for(MESH_RANKS) is mesh, "MeshSubstrate did not resolve the mesh")
        for op, inp, st in serve_signatures(inputs):
            got, rep = run(Request(op, inp, st, "mesh"), cache=cache)  # by name, as users ask
            split = dict(mesh.last_call)
            want, rep_local = run(Request(op, inp, st, LocalSubstrate(dev)), cache=cache)
            _, rep_cuda = run(Request(op, inp, st, CudaSubstrate(dev)), cache=cache)
            print("report " + rep.to_json(), flush=True)
            compute = [b - c for b, c in zip(split["body_s"], split["coll_s"])]
            row = {"op": op, "strategy": st.cache_key(), "mesh_ms": rep.seconds * 1e3,
                   "cuda_ms": rep_cuda.seconds * 1e3, "local_ms": rep_local.seconds * 1e3,
                   "mesh_over_cuda": rep.seconds / rep_cuda.seconds,
                   "first_call_ms": rep.compile_seconds * 1e3,
                   "call_ms": split["call_s"] * 1e3, "ship_ms": split["ship_s"] * 1e3,
                   "rank_recv_ms": max(split["recv_s"]) * 1e3, "reply_ms": split["reply_s"] * 1e3,
                   "rank_compute_ms": max(compute) * 1e3, "rank_collectives_ms": max(split["coll_s"]) * 1e3,
                   "collective_calls": split["coll_calls"], "caller_overhead_ms": split["overhead_s"] * 1e3,
                   "collective_share": max(split["coll_s"]) / split["call_s"]}
            print("  mesh_row " + json.dumps(row), flush=True)
            smoke.check(same_result(got, want), f"mesh {op} {st.cache_key()}: differs from local")
            smoke.check(rep.traffic == rep_local.traffic, f"mesh {op}: traffic differs from local")

        cfg = get_config(MOE_ARCH)
        k, cf = cfg.experts_per_token, cfg.capacity_factor
        rng = np.random.default_rng(3)
        x = torch.as_tensor(rng.standard_normal((LM_BATCH * LM_PROMPT, cfg.d_model), dtype=np.float32),
                            device=dev).to(torch.bfloat16)
        router = torch.as_tensor(0.02 * rng.standard_normal((cfg.d_model, cfg.num_experts),
                                                            dtype=np.float32), device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        f = cfg.moe_d_ff or cfg.d_ff
        w_gate, w_up = (0.02 * torch.randn((cfg.num_experts, cfg.d_model, f), generator=gen, device=dev,
                                           dtype=torch.bfloat16) for _ in range(2))
        w_down = 0.02 * torch.randn((cfg.num_experts, f, cfg.d_model), generator=gen, device=dev,
                                    dtype=torch.bfloat16)
        for label, st, nodelets in (("ep_push", MigratoryStrategy(comm=Comm.REMOTE_WRITE), MESH_RANKS),
                                    ("ep_pull", MigratoryStrategy(comm=Comm.MIGRATE), MESH_RANKS),
                                    ("tp", MigratoryStrategy(), 1)):
            moe_in = MoEDispatchInputs(x, router, nodelets=nodelets, experts_per_token=k,
                                       capacity_factor=cf, w_gate=w_gate, w_up=w_up, w_down=w_down)
            got, rep = run(Request("moe_dispatch", moe_in, st, mesh_sub), cache=cache)
            m = mesh_sub.mesh_for(nodelets)
            if m not in meshes:
                meshes.append(m)
            split = dict(m.last_call)
            want, rep_local = run(Request("moe_dispatch", moe_in, st, LocalSubstrate(dev)), cache=cache)
            print("report " + rep.to_json(), flush=True)
            print("  mesh_moe " + json.dumps({
                "mode": rep.metrics["dispatch_mode"], "ranks": nodelets, "mesh_ms": rep.seconds * 1e3,
                "local_ms": rep_local.seconds * 1e3, "ship_ms": split["ship_s"] * 1e3,
                "rank_recv_ms": max(split["recv_s"]) * 1e3, "reply_ms": split["reply_s"] * 1e3,
                "rank_compute_ms": max(b - c for b, c in zip(split["body_s"], split["coll_s"])) * 1e3,
                "rank_collectives_ms": max(split["coll_s"]) * 1e3,
                "caller_overhead_ms": split["overhead_s"] * 1e3,
                "dropped_slots": rep.metrics["dropped_slots"]}), flush=True)
            smoke.check(rep.metrics["dispatch_mode"] == label, f"mesh moe_dispatch: mode {rep.metrics}")
            smoke.check(torch.equal(got, want), f"mesh moe_dispatch {label}: differs from local")
        del x, router, w_gate, w_up, w_down, moe_in, got, want

        cfg = get_config("serve-moe")
        params = moe_decode_params(cfg, seed=0, device=dev)
        prng = np.random.default_rng(0)
        prompts = [prng.integers(1, cfg.vocab_size, size=int(prng.integers(2, 6))).tolist()
                   for _ in range(DECODE_SEQS)]

        def drive(server):
            for i, prompt in enumerate(prompts):
                server.add(prompt, max_new_tokens=DECODE_NEW)
                if i % 2:
                    server.step()
            return dict(server.run_until_drained())

        decode_mesh = make_nodelet_mesh(MESH_DECODE_RANKS, dev)  # started before the rates are read
        meshes.append(decode_mesh)
        print(f"  mesh for DecodeServer: {decode_mesh.describe()}", flush=True)
        for label, st in (("ep_push", MigratoryStrategy(comm=Comm.REMOTE_WRITE)),
                          ("ep_pull", MigratoryStrategy(comm=Comm.MIGRATE))):
            mk = dict(capacity=DECODE_CAPACITY, max_len=32, nodelets=MESH_DECODE_RANKS, strategy=st,
                      device=dev)
            local = drive(DecodeServer(cfg, params, substrate=LocalSubstrate(dev), **mk))
            svc = EngineService(cache=PlanCache(), substrate="mesh", device=dev, workers=1,
                                slo_target_seconds=5.0).start()
            try:
                served = drive(DecodeServer(cfg, params, service=svc, substrate="mesh", **mk))
            finally:
                svc.stop()
            report = svc.throughput_report()
            smoke.check(MeshSubstrate(dev).mesh_for(MESH_DECODE_RANKS) is decode_mesh,
                        "DecodeServer's mesh is not the one started for it")
            print("  mesh_decode " + json.dumps({
                "config": cfg.name, "mode": label, "ranks": MESH_DECODE_RANKS,
                "steps_per_s": report["requests_per_second"],
                "total_p50_ms": report["total_p50"] * 1e3, "total_p99_ms": report["total_p99"] * 1e3,
                "parity": served == local}), flush=True)
            smoke.check(served == local, f"mesh DecodeServer {label}: tokens differ from local")

        sizes = COLLECTIVE_SIZES["cuda"]["quick"]
        fits = measure_collectives(sizes, mesh=mesh)
        for kind, ab in fits.items():
            print(f"  mesh collective {kind}: alpha {ab.alpha * 1e6:.1f} us, beta {ab.beta * 1e12:.2f} "
                  f"ps/byte ({1.0 / max(ab.beta, 1e-18) / 1e9:.2f} GB/s), sizes {list(sizes)} bytes",
                  flush=True)
            smoke.check(ab.alpha >= 0 and ab.beta > 0, f"mesh collective {kind}: {ab}")
    finally:  # a failed check or a rank error still stops every rank before the LM phases
        pids = [pid for m in meshes for pid in m.pids]
        close_meshes()
        left = [p.pid for p in mp.active_children() if p.name.startswith("nodelet-rank")]
        exits = [code for m in meshes for code in m.exit_codes]
        print(f"  mesh closed: {len(pids)} rank processes stopped (exit codes {sorted(set(exits))}), "
              f"{len(left)} left", flush=True)
    files, slots, held = ipc_shares_outstanding()
    print(f"  mesh IPC after close: {held} of {slots} ref-counter slots held by a rank "
          f"({files} counter file(s) of this process)", flush=True)
    smoke.check(not left, f"rank processes left after close: {left}")
    smoke.check(all(code == 0 for code in exits), f"a rank did not exit cleanly: {exits}")
    smoke.check(held == 0, f"{held} CUDA blocks shipped to the ranks are still held")
    smoke.check(all(m.closed and not any(m.alive()) for m in meshes), "a mesh is still open")


def ipc_shares_outstanding() -> tuple[int, int, int]:
    """This process's CUDA IPC reference counters, read from the shared
    files torch keeps them in (``/dev/shm/torch_<pid>_*``: a 64-byte header,
    then one uint64 a shipped storage, set to 1 when shipped and dropped to 0
    when the receiving process frees its view): the files, their slots, and
    the slots still nonzero (blocks a rank still holds)."""
    import glob

    files = glob.glob(f"/dev/shm/torch_{os.getpid()}_*")
    slots = held = 0
    for path in files:
        counters = np.fromfile(path, dtype=np.uint64)[8:]
        slots += counters.size
        held += int(np.count_nonzero(counters))
    return len(files), slots, held


def dataclass_tensors(value) -> list:
    """Every tensor among a dataclass's fields (one level of nesting deep
    per field, as the main path's inputs hold them)."""
    import dataclasses

    out = []
    for f in dataclasses.fields(value):
        v = getattr(value, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif dataclasses.is_dataclass(v):
            out.extend(dataclass_tensors(v))
    return out


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


def flash_calls_during(fn, keep: bool = False) -> tuple:
    """Runs ``fn`` with the model's flash attention op wrapped: returns
    (``fn``'s result, calls by instance, and with ``keep`` the first call's
    (q, k, v) of each instance, (B, H, S, D) as the model hands them over).
    An instance is (Sq, Skv, causal). The kernel's own launch count is
    untouched."""
    import repro_torch.models.layers as layers

    tally, captures = {}, {}
    flash_attention = layers.flash_attention

    def hook(q, k, v, **kw):
        sig = (q.shape[2], k.shape[2], kw.get("causal", True))
        tally[sig] = tally.get(sig, 0) + 1
        if keep and sig not in captures:
            captures[sig] = (q, k, v)
        return flash_attention(q, k, v, **kw)

    layers.flash_attention = hook
    try:
        out = fn()
    finally:
        layers.flash_attention = flash_attention
    return out, tally, captures


def warm_up_capturing(cfg, model, prompts, dev, batch: "dict | None" = None) -> dict:
    """A short warm-up serve (cuBLAS, the kernel's library; a prefill and one
    decode step) that captures layer 0's attention inputs of each flash
    instance: {(Sq, Skv, causal): (q, k, v)}, in call order."""
    from repro_torch.launch.serve import lm_serve

    return flash_calls_during(lambda: lm_serve(cfg, model, prompts, 2, dev, batch), keep=True)[2]


def fold_qkv(q, k, v) -> tuple:
    """(B, H, S, D) views folded to the kernel's (B·H, S, D)."""
    return tuple(t.reshape(-1, t.shape[2], t.shape[3]) for t in (q, k, v))


def flash_on_captured(qkv: tuple, what: str, causal: bool = True) -> float:
    """flash_attn on captured layer-0 inputs held against its plain version
    at the kernel's k tile; returns the largest absolute difference."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain, flash_attn, kernel_block_k,
    )

    qf, kf, vf = fold_qkv(*qkv)
    got = flash_attn(qf, kf, vf, causal=causal).float()
    want = flash_attention_plain(qf, kf, vf, causal=causal,
                                 block_k=kernel_block_k(qf.dtype, qf.shape[2])).float()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want,
                               **(FLASH_BF16_TOL if qf.dtype == torch.bfloat16 else FLASH_F32_TOL),
                               msg=lambda m: f"{what}: flash_attn vs its plain version: {m}")
    print(f"  {what}: layer 0 q {tuple(qf.shape)} k/v {tuple(kf.shape)} {qf.dtype}"
          f"{'' if causal else ' non-causal'}: flash_attn within {err} of its plain version")
    return err


def flash_per_serve(cfg, gen: int) -> int:
    """Flash launches a serve of ``gen`` tokens makes: one a self-attention
    layer at prefill (a shared block's application point in a hybrid), and
    for an encoder-decoder the encoder's layers and one cross-attention a
    decoder layer at prefill and again at every decode step (over the
    cached frames, with no valid length); none in an SSM."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // (cfg.shared_attn_period or cfg.num_layers)
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers + (gen - 1) * cfg.num_layers
    return cfg.num_layers


def lm_serve_path(smoke: Smoke, dev, arch: str = LM_ARCH, gen: int = LM_GEN,
                  prompt: int = LM_PROMPT) -> dict:
    """The LM's main path: ``lm_serve`` at the full width of the arch, flash
    attention where the family has it, with the stub frontend's frames or
    patches, after a warm-up serve that captures layer 0's attention inputs
    of each flash instance for the kernel check. The flash launches are
    counted by the kernel's wrapper and tallied by instance."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attn
    from repro_torch.launch.serve import lm_serve, stub_inputs
    from repro_torch.models import api

    cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
    t0 = time.perf_counter()
    model = api.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {sum(p.numel() for p in model.parameters())} weights in {cfg.dtype}, "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s")
    prompts = np.random.default_rng(1).integers(1, cfg.vocab_size, (LM_BATCH, prompt))
    batch = stub_inputs(cfg, LM_BATCH, 2)
    captures = warm_up_capturing(cfg, model, prompts, dev, batch)

    torch.cuda.reset_peak_memory_stats(dev)
    (res, tally, _), launches = counted(
        flash_attn, lambda: flash_calls_during(lambda: lm_serve(cfg, model, prompts, gen, dev, batch)))
    toks = res.tokens
    smoke.check(tuple(toks.shape) == (LM_BATCH, gen), f"lm_serve: token shape {tuple(toks.shape)}")
    smoke.check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "lm_serve: token ids out of range")
    steps = gen - 1
    stats = {
        "arch": cfg.name, "family": cfg.family, "batch": LM_BATCH, "prompt": prompt, "gen": gen,
        **{f"{k}_per_row": v.shape[1] for k, v in batch.items()},
        "prefill_ms": res.prefill_seconds * 1e3,
        "prefill_tok_s": LM_BATCH * prompt / res.prefill_seconds,
        "decode_ms_per_step": res.decode_seconds * 1e3 / steps,
        "decode_tok_s": LM_BATCH * steps / res.decode_seconds,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "flash_attn_launches": launches,
        "flash_by_instance": {f"Sq {sq} Skv {skv}{'' if c else ' non-causal'}": n
                              for (sq, skv, c), n in tally.items()},
    }
    print("  lm " + json.dumps(stats), flush=True)
    print(f"  sample token ids: {toks[0, :16].tolist()}")
    want = flash_per_serve(cfg, gen)
    smoke.check(launches == want == sum(tally.values()),
                f"flash_attn launched {launches} times in the serve ({sum(tally.values())} calls), "
                f"want {want}")
    first = next(iter(captures.values()), None)
    return {"cfg": cfg, "model": model, "prompts": prompts, "batch": batch, "gen": gen,
            "launches": launches, "tally": tally, "captures": captures, "qkv": first}


def logits_close(smoke: Smoke, what: str, got, want, rtol: "float | None" = None) -> None:
    """``got`` within :data:`LM_LOGIT_ATOL` of ``want``, or with ``rtol``,
    within ``rtol`` times ``want``'s largest |logit|; both finite."""
    a, b = got.float(), want.float()
    smoke.check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()), f"{what}: non-finite logits")
    err, top = float((a - b).abs().max()), float(b.abs().max())
    limit = LM_LOGIT_ATOL if rtol is None else rtol * top
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    print(f"  {what}: max abs diff {err}, limit {limit} (largest |logit| {top}; "
          f"argmax agrees on {agree:.2f} of rows)")
    smoke.check(err <= limit, f"{what}: logits differ by {err} > {limit}")


def lm_vs_reference(smoke: Smoke, lm: dict, rtol: "float | None" = None) -> None:
    """Layer 0's captured q, k, v of each flash instance other than the
    llama and moonshot serves' (checked in their own phases) against the
    plain version; then the flash prefill against the reference attention
    branch (q-chunked plain PyTorch) on the same weights, and teacher-forced
    decode steps: the same tokens into both states. Free-running greedy
    tokens are not compared: random weights give near-tied logits. The
    logits agree within :data:`LM_LOGIT_ATOL`, or with ``rtol``, within
    ``rtol`` times the reference's largest |logit|."""
    import dataclasses

    from repro_torch.models import Ctx, api

    cfg, model = lm["cfg"], lm["model"]
    if cfg.name not in (LM_ARCH, MOE_ARCH):
        for (sq, skv, causal), qkv in lm.get("captures", {}).items():
            flash_on_captured(qkv, f"{cfg.name} Sq {sq} Skv {skv}", causal)
    dev = model.embed.device
    tokens = torch.as_tensor(lm["prompts"], device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in lm.get("batch", {}).items()}
    ctx_f, ctx_r = Ctx(cfg), Ctx(dataclasses.replace(cfg, attn_impl="reference"))
    max_len = tokens.shape[1] + LM_TEACHER_STEPS + (cfg.num_patches or 0)
    lf, cf = api.prefill(ctx_f, model, tokens, max_len, batch)
    t0 = time.perf_counter()
    lr, cr = api.prefill(ctx_r, model, tokens, max_len, batch)
    torch.cuda.synchronize()
    print(f"  reference-branch prefill: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    print("  decode state after prefill, max abs diff: " + ", ".join(
        f"{f} {float((getattr(cf, f).float() - getattr(cr, f).float()).abs().max())}"
        for f in cf._fields if f != "length"))
    logits_close(smoke, "prefill last-token logits", lf, lr, rtol)
    for i, tok in enumerate(np.random.default_rng(2).integers(1, cfg.vocab_size, (LM_TEACHER_STEPS, tokens.shape[0], 1))):
        t = torch.as_tensor(tok, device=dev)
        lf, cf = api.decode_step(ctx_f, model, t, cf)
        lr, cr = api.decode_step(ctx_r, model, t, cr)
        logits_close(smoke, f"teacher-forced decode step {i}", lf, lr, rtol)


def chunked_vs_stepwise(smoke: Smoke, lm: dict) -> None:
    """The served model's prefill over the whole prompt against a prefill
    over all but its last :data:`STEPWISE_STEPS` tokens and decode steps fed
    those tokens: the chunked scan (and the flash prefill) against the
    one-token recurrence (and the dense attention over the cache), on the
    last token's logits, within :data:`FAMILY_LOGIT_RTOL`."""
    from repro_torch.models import Ctx, api

    cfg, model = lm["cfg"], lm["model"]
    ctx = Ctx(cfg)
    tokens = torch.as_tensor(lm["prompts"], device=model.embed.device)
    s = tokens.shape[1]
    want, _ = api.prefill(ctx, model, tokens, s)
    got, state = api.prefill(ctx, model, tokens[:, :s - STEPWISE_STEPS], s)
    for i in range(s - STEPWISE_STEPS, s):
        got, state = api.decode_step(ctx, model, tokens[:, i:i + 1], state)
    logits_close(smoke, f"prefill({s}) vs prefill({s - STEPWISE_STEPS}) + {STEPWISE_STEPS} decode steps",
                 got, want, FAMILY_LOGIT_RTOL)


def reduced_card_vs_cpu(smoke: Smoke, dev, arch: str) -> None:
    """The reduced float32 config of ``arch``, the same weights on the card
    and on the CPU: a prefill of :data:`REDUCED_BATCH` x :data:`REDUCED_PROMPT`
    tokens and :data:`LM_TEACHER_STEPS` teacher-forced decode steps, logits
    within :data:`CARD_VS_CPU_TOL`."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import Ctx, api

    cfg = reduced_config(arch)
    ctx = Ctx(cfg)
    rng = np.random.default_rng(5)
    prompts = torch.as_tensor(rng.integers(1, cfg.vocab_size, (REDUCED_BATCH, REDUCED_PROMPT)))
    steps = torch.as_tensor(rng.integers(1, cfg.vocab_size, (LM_TEACHER_STEPS, REDUCED_BATCH, 1)))
    cpu_model = api.init_params(cfg, seed=0, device="cpu")
    card_model = api.init_params(cfg, seed=1, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    outs = {}
    for where, model in (("cpu", cpu_model), ("card", card_model)):
        d = model.embed.device
        logits, state = api.prefill(ctx, model, prompts.to(d), REDUCED_PROMPT + LM_TEACHER_STEPS)
        seq = [logits]
        for t in steps:
            logits, state = api.decode_step(ctx, model, t.to(d), state)
            seq.append(logits)
        outs[where] = [x.float().cpu() for x in seq]
    for i, (g, w) in enumerate(zip(outs["card"], outs["cpu"])):
        err = float((g - w).abs().max())
        what = "prefill" if i == 0 else f"decode step {i - 1}"
        print(f"  reduced {cfg.name} float32, {what}: card vs CPU max abs diff {err} "
              f"(largest |logit| {float(w.abs().max())})")
        torch.testing.assert_close(g, w, **CARD_VS_CPU_TOL, msg=lambda m: f"{what}: {m}")


def csr_mv_ms(csr, x) -> "float | None":
    """Milliseconds of ``torch.mv`` on ``csr`` as a sparse CSR tensor (a
    yardstick the port never calls), or None where this build has none."""
    try:
        with warnings.catch_warnings():  # sparse CSR is "beta": keep its notices out of the log
            warnings.simplefilter("ignore", UserWarning)
            a_lib = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data, size=csr.shape)
        torch.mv(a_lib, x)
        return time_ms(lambda: torch.mv(a_lib, x), 50)
    except (RuntimeError, NotImplementedError) as e:  # no sparse CSR product in this build
        print(f"  torch.sparse CSR yardstick unavailable: {e}")
        return None


def stripe_work(cols: torch.Tensor, plan, n_x: int) -> tuple[int, int]:
    """(bytes, operations) of a striped product on these planes: the column
    index of every slot a stripe reads, the value of each valid slot (a
    padded slot's value is never needed), x and y once; 2 flops a valid slot."""
    n_rows = cols.shape[0]
    rows = np.full(len(plan.widths), plan.block_rows, dtype=np.int64)
    rows[-1] = n_rows - plan.block_rows * (len(plan.widths) - 1)
    slots = int((rows * plan.widths).sum())
    valid = int((cols >= 0).sum())
    return slots * 4 + valid * 4 + n_x * 4 + n_rows * 4, 2 * valid


def stripe_path(smoke: Smoke, inputs: dict) -> None:
    """The CSR-stripe SpMV through its entry point ``spmv(variant="stripe")``
    on the main path's Laplacian planes and on a skewed matrix with hub rows,
    the stripe kernel's launch count set to 0 just before each and read just
    after (one launch a call, no ELL launch); ``variant="auto"`` too, which
    takes the stripes where dense-ELL padding wastes 2x or more. Then each is
    held against spmv_ell_plain and timed beside its bound, the JAX
    package's bucketed loop (the plain version), spmv_ell on the same planes
    and torch.mv on the same CSR."""
    from repro_torch.core import MigratoryStrategy
    from repro_torch.kernels.spmv.kernel import spmv_ell, spmv_ell_plain
    from repro_torch.kernels.spmv.ops import STRIPE_WASTE_THRESHOLD, spmv
    from repro_torch.kernels.spmv.stripe import (
        build_stripe_plan, spmv_ell_stripes, spmv_stripes_plain,
    )
    from repro_torch.sparse import ell_from_csr, skewed_matrix

    a = inputs["spmv"].a
    p, rp, k = a.cols.shape
    x = inputs["spmv"].x
    dev = x.device
    t0 = time.perf_counter()
    sk = skewed_matrix(SKEWED["n"], SKEWED["avg_deg"], SKEWED["max_deg"], seed=SKEWED["seed"],
                       device=dev)
    e = ell_from_csr(sk, device=dev)
    x_sk = torch.as_tensor(np.random.default_rng(5).standard_normal(sk.n_cols).astype(np.float32),
                           device=dev)
    print(f"  skewed_matrix({SKEWED}): {sk.nnz} nnz, ELL {tuple(e.cols.shape)} "
          f"({time.perf_counter() - t0:.1f} s)")
    cases = {
        "laplacian_2d(2048), the main path's planes": (
            a.cols.reshape(p * rp, k), a.vals.reshape(p * rp, k), x,
            max(1, min(MigratoryStrategy().dynamic_grain(rp), p * rp)), inputs["csr"]),
        f"skewed_matrix(2^20, {SKEWED['avg_deg']}, {SKEWED['max_deg']})": (
            e.cols, e.vals, x_sk, SKEWED_GRAIN, sk),
    }
    for case, (cols, vals, xv, grain, csr) in cases.items():
        t0 = time.perf_counter()
        plan = build_stripe_plan(cols, grain)
        print(f"  {case}: stripe plan at grain {grain} in {time.perf_counter() - t0:.1f} s, "
              f"{len(plan.widths)} stripes, widths {sorted(set(plan.widths.tolist()))}, "
              f"{plan.padded_slots} striped slots, waste ratio {plan.waste_ratio:.3f}", flush=True)
        spmv_ell.launches = 0
        y, n_launch = counted(spmv_ell_stripes, lambda: spmv(cols, vals, xv, grain=grain,
                                                             variant="stripe", stripe_plan=plan))
        smoke.check(n_launch == 1 and spmv_ell.launches == 0,
                    f"{case}: spmv(variant='stripe') made {n_launch} stripe and "
                    f"{spmv_ell.launches} ELL launches, want 1 and 0")
        y_auto, n_auto = counted(spmv_ell_stripes, lambda: spmv(cols, vals, xv, grain=grain,
                                                                variant="auto", stripe_plan=plan))
        smoke.check(n_auto == int(plan.waste_ratio >= STRIPE_WASTE_THRESHOLD),
                    f"{case}: variant='auto' made {n_auto} stripe launches at waste "
                    f"{plan.waste_ratio}")
        y_p = spmv_ell_plain(cols, vals, xv)
        for got in (y, y_auto):
            err = (got - y_p).abs()
            smoke.check(bool((err <= SPMV_ATOL + SPMV_RTOL * y_p.abs()).all()),
                        f"{case}: stripes disagree with spmv_ell_plain: max abs err {float(err.max())}")
        err = float((y - y_p).abs().max())
        ell_ms = time_ms(lambda: spmv_ell(cols, vals, xv, block_rows=grain), 50)
        kernel_row(smoke, {"spmv_ell_stripes": n_launch}, "spmv_ell_stripes",
                   "src/repro_torch/csrc/spmv_ell.cu", "src/repro/kernels/spmv/stripe.py:101", err,
                   time_ms(lambda: spmv_ell_stripes(cols, vals, xv, plan=plan), 50),
                   time_ms(lambda: spmv_stripes_plain(cols, vals, xv, plan), 5, warmup=1),
                   *stripe_work(cols, plan, xv.shape[0]), csr_mv_ms(csr, xv),
                   case=case, grain=grain, waste_ratio=plan.waste_ratio, spmv_ell_ms=ell_ms)


def coarse_gsana_path(smoke: Smoke, inputs: dict) -> None:
    """GSANA on the main path's alignment pair at a coarse grid, whose
    buckets (hundreds of vertices, past what shared memory held before)
    take topk_sim's wide instance: ``engine.run`` on ``cuda``, topk_sim's
    launch count set to 0 just before and read just after, held equal to
    the ``local`` substrate; then the kernel on the grid's PAIR planes, held
    against its plain version and timed beside its bound."""
    from repro_torch.core import Layout, MigratoryStrategy, Scheme, bucketize, pick_grid
    from repro_torch.core.gsana import DEFAULT_VOCAB, pair_tasks
    from repro_torch.engine import CudaSubstrate, GSANAInputs, LocalSubstrate, Request, run
    from repro_torch.kernels import build
    from repro_torch.kernels.topk_sim.kernel import topk_sim, topk_sim_plain
    from repro_torch.kernels.topk_sim.ops import pair_planes

    usage = resource_usage(build.library_path("topk_sim"), build.nvcc())
    for line in usage or ["not measured (no cuobjdump)"]:
        print(f"  topk_sim resources (cuobjdump -res-usage): {line}")
    gi = inputs["gsana"]
    dev = gi.b1.vid.device
    n = gi.vs1.n
    grid = pick_grid(n, COARSE_BUCKET)
    cap = max(bucketize(gi.vs1, grid, device=dev).cap, bucketize(gi.vs2, grid, device=dev).cap)
    coarse = GSANAInputs(gi.vs1, gi.vs2, bucketize(gi.vs1, grid, cap=cap, device=dev),
                         bucketize(gi.vs2, grid, cap=cap, device=dev), k=gi.k,
                         ground_truth=gi.ground_truth)
    print(f"  gsana coarse: n={n}, grid {grid}x{grid}, cap {cap}, {grid * grid * 9} PAIR tasks",
          flush=True)
    st = MigratoryStrategy(layout=Layout.HCB, scheme=Scheme.PAIR)
    ((cand, score), report), n_launch = counted(
        topk_sim, lambda: run(Request("gsana", coarse, st, CudaSubstrate(dev))))
    print("report " + report.to_json(), flush=True)
    smoke.check(n_launch > 0, "coarse gsana: topk_sim was never launched")
    smoke.check(tuple(cand.shape) == (n, gi.k) and bool(torch.isfinite(score).all()),
                "coarse gsana: shape or non-finite scores")
    (c_local, s_local), _ = run(Request("gsana", coarse, st, LocalSubstrate(dev)), iters=1, warmup=0)
    smoke.check(torch.equal(cand, c_local), "coarse gsana: cuda and local candidates differ")
    torch.testing.assert_close(score, s_local, rtol=0, atol=1e-6)
    print(f"  coarse gsana recall@{gi.k}: {report.metrics['recall_at_k']}; cuda equals local")

    planes = pair_planes(gi.vs1, gi.vs2, coarse.b1, coarse.b2, *pair_tasks(grid, dev))[:4]
    kw = dict(zip(("t1", "t2", "t3"), DEFAULT_VOCAB), k=gi.k)
    s_k, i_k = topk_sim(*planes, **kw)
    s_p, i_p = topk_sim_plain(*planes, **kw)
    smoke.check(torch.equal(i_k, i_p), f"topk_sim slots disagree with its plain version at cap {cap}")
    finite = torch.isfinite(s_p)
    smoke.check(torch.equal(finite, torch.isfinite(s_k)), f"topk_sim: -inf pattern differs at cap {cap}")
    err = float((s_k[finite] - s_p[finite]).abs().max())
    smoke.check(err <= 1e-6, f"topk_sim scores differ by {err} at cap {cap}")
    kernel_row(smoke, {"topk_sim": n_launch}, "topk_sim", "src/repro_torch/csrc/topk_sim.cu",
               "src/repro/kernels/topk_sim/kernel.py:50", err,
               time_ms(lambda: topk_sim(*planes, **kw), 5),
               time_ms(lambda: topk_sim_plain(*planes, **kw), 1, warmup=0),
               *topk_sim_work(*planes, kw), None,
               case=f"coarse grid {grid}x{grid}, {planes[0].shape[0]} tasks of {cap}x{cap} slots",
               cap=cap, valid_pairs=float((planes[2].sum(1) * planes[3].sum(1)).sum()))


def reduced_lm_path(smoke: Smoke, dev) -> dict:
    """The reduced config of the LM (2 layers, d_model 128, head dim 32) served
    on the card with flash attention in bf16 (the tensor-core kernel, head
    dim padded to 64) and float32 (the CUDA-core kernel, padded to 32), the
    flash launch count set to 0 just before each serve and read just after;
    layer 0's q, k, v from a warm-up serve held against the kernel's plain
    version, then the logits against the reference attention branch
    (:data:`SHALLOW_LOGIT_RTOL`). Returns the launches by type."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.kernels.flash_attention.kernel import flash_attn
    from repro_torch.launch.serve import lm_serve
    from repro_torch.models import api

    launches = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(reduced_config(LM_ARCH, dtype), attn_impl="flash")
        model = api.init_params(cfg, seed=0, device=dev)
        prompts = np.random.default_rng(3).integers(1, cfg.vocab_size, (REDUCED_BATCH, REDUCED_PROMPT))
        qkv = next(iter(warm_up_capturing(cfg, model, prompts, dev).values()))
        res, n_launch = counted(flash_attn, lambda: lm_serve(cfg, model, prompts, REDUCED_GEN, dev))
        toks = res.tokens
        smoke.check(tuple(toks.shape) == (REDUCED_BATCH, REDUCED_GEN)
                    and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                    f"reduced lm_serve ({dtype}): tokens {tuple(toks.shape)} out of shape or range")
        print(f"  reduced {cfg.name} {dtype}: head dim {cfg.head_dim}, {cfg.num_layers} layers, "
              f"{cfg.num_heads}/{cfg.num_kv_heads} heads, prompts {REDUCED_BATCH}x{REDUCED_PROMPT}: "
              f"prefill {res.prefill_seconds * 1e3:.3f} ms, decode "
              f"{res.decode_seconds * 1e3 / (REDUCED_GEN - 1):.3f} ms a step, flash launches {n_launch}",
              flush=True)
        smoke.check(n_launch == cfg.num_layers,
                    f"reduced {dtype}: flash_attn launched {n_launch} times, want {cfg.num_layers}")
        flash_on_captured(qkv, f"reduced {dtype}")
        lm_vs_reference(smoke, {"cfg": cfg, "model": model, "prompts": prompts},
                        rtol=SHALLOW_LOGIT_RTOL[dtype])
        launches[dtype] = n_launch
    return launches


def moe_lm_vs_reference(smoke: Smoke, lm: dict) -> dict:
    """Layer 0's captured q, k, v through flash against the plain version,
    then the MoE LM's flash prefill and :data:`LM_TEACHER_STEPS` teacher-forced
    decode steps against the reference attention branch on the same
    weights, with every MoE layer's routing captured in both branches: the
    tokens whose expert set differs between the branches, a layer each, and
    the prefill's drop share (routed slots past capacity over routed slots,
    counted on the host from the flash branch's routing; the slots the
    program kept in each layer equal each expert's first ``capacity`` slots
    in slot order, recounted on the host). The logits agree
    within :data:`LM_LOGIT_ATOL`. If they do not, and every row over the
    limit is a sequence in which some token took another expert set (bf16
    differences of attention move a near-tied router), the comparison runs
    instead on a :data:`MOE_FALLBACK_LAYERS`-layer stack of the same width
    under :data:`SHALLOW_LOGIT_RTOL`, as the phi-3 text stack's does; a row
    over the limit without a flip fails the phase. Returns the flash
    prefill's MoE input and router at :data:`MOE_DISPATCH_LAYER` under
    ``"served"``."""
    import dataclasses

    import repro_torch.models.moe as moe
    from repro_torch.models import Ctx, api

    cfg, model = lm["cfg"], lm["model"]
    flash_on_captured(lm["qkv"], cfg.name)
    dev = model.embed.device
    tokens = torch.as_tensor(lm["prompts"], device=dev)
    b, s = tokens.shape
    route, local_dispatch, routed, kept, served = moe._route, moe._local_dispatch, [], [], {}

    def capture(c, xt, router):
        if len(routed) == MOE_DISPATCH_LAYER and not served:  # the flash prefill's
            served.update(x=xt.clone(), router=router)
        gates, experts = route(c, xt, router)
        routed.append(experts)
        return gates, experts

    def capture_keep(*args):
        out = local_dispatch(*args)
        kept.append(out[3])
        return out

    def taken() -> list:
        out = list(routed)
        routed.clear()
        return out

    ctx_f, ctx_r = Ctx(cfg), Ctx(dataclasses.replace(cfg, attn_impl="reference"))
    max_len = s + LM_TEACHER_STEPS
    moe._route, moe._local_dispatch = capture, capture_keep
    try:
        lf, cf = api.prefill(ctx_f, model, tokens, max_len)
        moe._local_dispatch = local_dispatch
        ef = taken()
        lr, cr = api.prefill(ctx_r, model, tokens, max_len)
        er = taken()
        pairs = [("prefill last-token logits", lf, lr, ef, er)]
        for i, tok in enumerate(np.random.default_rng(2).integers(1, cfg.vocab_size,
                                                                  (LM_TEACHER_STEPS, b, 1))):
            t = torch.as_tensor(tok, device=dev)
            lf, cf = api.decode_step(ctx_f, model, t, cf)
            df = taken()
            lr, cr = api.decode_step(ctx_r, model, t, cr)
            pairs.append((f"teacher-forced decode step {i}", lf, lr, df, taken()))
    finally:
        moe._route, moe._local_dispatch = route, local_dispatch

    # the prefill's drop share, on the host from the flash branch's routing:
    # each expert keeps its first `cap` slots in slot order
    cap = moe._capacity(cfg, b * s, cfg.num_experts)
    want = [kept_slots(e.cpu().numpy().ravel(), cap) for e in ef]
    dropped = [int((~w).sum()) for w in want]
    routed_slots = b * s * cfg.experts_per_token
    print(f"  prefill drop share: {sum(dropped) / (routed_slots * len(dropped))} of "
          f"{routed_slots} routed slots a layer (capacity {cap}); per layer "
          f"{[round(d / routed_slots, 5) for d in dropped]}")
    smoke.check(len(kept) == cfg.num_layers, f"{len(kept)} MoE dispatches in a {cfg.num_layers}-layer prefill")
    differ = [i for i, (k, w) in enumerate(zip(kept, want)) if not np.array_equal(k.cpu().numpy(), w)]
    smoke.check(not differ, f"prefill layers {differ}: the kept slots differ from the host recount")
    print(f"  kept slots equal the host recount (first {cap} of each expert's, in slot order) "
          f"in all {len(kept)} layers")
    # tokens routed to another expert set by the two branches, a layer each
    ef, er = ([e.sort(dim=1).values for e in es] for es in (ef, er))
    flips = [(f != r).any(dim=1) for f, r in zip(ef, er)]
    print(f"  prefill tokens (of {b * s}) with another expert set in the two branches, per layer: "
          f"{[int(f.sum()) for f in flips]}")
    flipped_seq = torch.stack(flips).any(dim=0).view(b, s).any(dim=1)  # (B,)
    over, unexplained, worst = [], [], 0.0
    for what, a, r, df, dr in pairs:
        a, r = a.float(), r.float()
        smoke.check(bool(torch.isfinite(a).all() and torch.isfinite(r).all()), f"{what}: non-finite logits")
        if what.startswith("teacher"):
            step_flips = torch.stack([(f.sort(dim=1).values != g.sort(dim=1).values).any(dim=1)
                                      for f, g in zip(df, dr)]).any(dim=0)
            flipped_seq |= step_flips
            print(f"  {what}: {int(step_flips.sum())} of {b} rows took another expert set in some layer")
        row_err = (a - r).abs().flatten(1).amax(dim=1)
        err, top = float(row_err.max()), float(r.abs().max())
        agree = float((a.argmax(-1) == r.argmax(-1)).float().mean())
        worst = max(worst, err)
        print(f"  {what}: max abs diff {err}, limit {LM_LOGIT_ATOL} (largest |logit| {top}; "
              f"argmax agrees on {agree:.2f} of rows)")
        for row in torch.nonzero(row_err > LM_LOGIT_ATOL).flatten().tolist():
            over.append((what, row))
            if not bool(flipped_seq[row]):  # no flip in this sequence so far
                unexplained.append((what, row))
    out = {"flips": [int(f.sum()) for f in flips], "drop_share": sum(dropped) / (routed_slots * len(dropped)),
           "max_abs_diff": worst, "held_at": f"{cfg.num_layers} layers", "served": served}
    if not over:
        print(f"  held at full depth ({cfg.num_layers} layers) within {LM_LOGIT_ATOL}")
        return out
    smoke.check(not unexplained, f"flash and reference logits differ past {LM_LOGIT_ATOL} in rows "
                                 f"without a routing flip: {unexplained}")
    print(f"  {len(over)} rows past {LM_LOGIT_ATOL}, each in a sequence whose routing flipped: "
          f"the comparison runs on a {MOE_FALLBACK_LAYERS}-layer stack of the same width")
    shallow = dataclasses.replace(cfg, num_layers=MOE_FALLBACK_LAYERS)
    lm_vs_reference(smoke, {"cfg": shallow, "model": api.init_params(shallow, seed=0, device=dev),
                            "prompts": lm["prompts"]}, rtol=SHALLOW_LOGIT_RTOL[shallow.dtype])
    out["held_at"] = f"{MOE_FALLBACK_LAYERS} layers (full depth: {len(over)} rows past the limit)"
    return out


def profile_lm(lm: dict) -> None:
    """One prefill and one decode step of a served LM under torch.profiler."""
    from repro_torch.models import Ctx, api

    cfg, model = lm["cfg"], lm["model"]
    ctx, dev = Ctx(cfg), model.embed.device
    tokens = torch.as_tensor(lm["prompts"], device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in lm["batch"].items()}
    max_len = tokens.shape[1] + lm["gen"] + (cfg.num_patches or 0)
    _, state = api.prefill(ctx, model, tokens, max_len, batch)
    b, s = tokens.shape
    # each decode call writes the same cache entry (the state passed in stays)
    profile_calls({
        f"{cfg.name} prefill ({b}x{s}, flash)": lambda: api.prefill(ctx, model, tokens, max_len, batch),
        f"{cfg.name} decode step ({b} rows, {s} in the prompt)":
            lambda: api.decode_step(ctx, model, tokens[:, -1:], state),
    })


def kept_slots(experts, cap: int) -> np.ndarray:
    """The slots a capacity binning keeps: each expert's first ``cap`` in
    slot order (numpy, independent of the program's ranks)."""
    keep = np.zeros(experts.size, dtype=bool)
    for e in np.unique(experts):
        keep[np.flatnonzero(experts == e)[:cap]] = True
    return keep


def cap8(capacity_factor: float, expected_slots: float) -> int:
    """A capacity buffer's rows: the expected slots times the factor, at
    least 8 and a multiple of 8."""
    c = int(capacity_factor * expected_slots)
    return max(8, -(-c // 8) * 8)


def recount_dropped(mode: str, ids: list, n_experts: int, k: int, cf: float) -> int:
    """Dropped slots of one dispatch, recounted in plain Python from each
    shard's expert ids in slot order: a slot is dropped when the slots
    before it in its bin fill the bin's capacity. tp: bins are the experts
    of each shard; ep_pull: the experts over the whole stream (shard-major);
    ep_push: first each shard's bins by owner, then, at each owner, the
    experts over what arrived, source by source."""
    p = len(ids)
    t_shard = len(ids[0]) // k
    total = p * t_shard

    def over_capacity(stream, key, cap):
        seen, kept, dropped = {}, [], 0
        for e in stream:
            b = key(e)
            seen[b] = seen.get(b, 0) + 1
            if seen[b] > cap:
                dropped += 1
            else:
                kept.append(e)
        return dropped, kept

    if mode == "tp":
        cap = cap8(cf, t_shard * k / n_experts)
        return sum(over_capacity(shard, lambda e: e, cap)[0] for shard in ids)
    cap_e = cap8(cf, total * k / n_experts)
    if mode == "ep_pull":
        return over_capacity([e for shard in ids for e in shard], lambda e: e, cap_e)[0]
    e_local, cap_pair = n_experts // p, cap8(cf, t_shard * k / p)
    arrived = {o: [] for o in range(p)}
    dropped = 0
    for shard in ids:
        d, kept = over_capacity(shard, lambda e: e // e_local, cap_pair)
        dropped += d
        for e in kept:
            arrived[e // e_local].append(e)
    return dropped + sum(over_capacity(arrived[o], lambda e: e, cap_e)[0] for o in range(p))


def moe_dispatch_path(smoke: Smoke, experts: tuple, served: "dict | None", dev) -> None:
    """``moe_dispatch`` at the moonshot layer width through ``engine.run`` on
    ``LocalSubstrate`` on the card, top-6, capacity factor 1.25, the experts
    of the served model's layer :data:`MOE_DISPATCH_LAYER`, on two inputs:
    x (8192, 2048) bf16 and a router (2048, 64) float32 at the init scale
    from numpy seed 3, and that layer's input and router in the served
    prefill (``served``), where every mode drops slots. Each mode's result
    equal to ``moe_dispatch_reference``, its dropped slots equal to
    :func:`recount_dropped` on the card's routing, its traffic to
    ``moe_dispatch_traffic`` of the routing replay; ``"auto"`` picks the
    least modeled traffic from the plan cache; the ``cuda`` substrate
    refuses the op."""
    from repro_torch.configs import get_config
    from repro_torch.core import Comm, MigratoryStrategy
    from repro_torch.engine import (
        CudaSubstrate, LocalSubstrate, MoEDispatchInputs, OpNotSupportedError, PlanCache, Request,
        choose_strategy, moe_dispatch_reference, moe_dispatch_traffic, run,
    )
    from repro_torch.engine.moe_op import _routing_replay
    from repro_torch.models.moe import route

    cfg = get_config(MOE_ARCH)
    k, cf = cfg.experts_per_token, cfg.capacity_factor
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((LM_BATCH * LM_PROMPT, cfg.d_model), dtype=np.float32),
                        device=dev).to(torch.bfloat16)
    router = torch.as_tensor(0.02 * rng.standard_normal((cfg.d_model, cfg.num_experts),
                                                        dtype=np.float32), device=dev)
    cases = [("i.i.d. x (seed 3)", x, router, False)]
    if served is not None:
        cases.append((f"layer {MOE_DISPATCH_LAYER}'s input in the served prefill", served["x"],
                      served["router"], True))
    w_gate, w_up, w_down = experts
    sub, cache = LocalSubstrate(dev), PlanCache()
    for case, x, router, must_drop in cases:
        print(f"  {case}:")
        traffic = {}
        for label, st, nodelets in (("ep_push", MigratoryStrategy(comm=Comm.REMOTE_WRITE), 8),
                                    ("ep_pull", MigratoryStrategy(comm=Comm.MIGRATE), 8),
                                    ("tp", MigratoryStrategy(), 1)):
            inputs = MoEDispatchInputs(x, router, nodelets=nodelets, experts_per_token=k,
                                       capacity_factor=cf, w_gate=w_gate, w_up=w_up, w_down=w_down)
            y, report = run(Request("moe_dispatch", inputs, st, sub), cache=cache)
            print("report " + report.to_json(), flush=True)
            print(f"  moe_dispatch {label}, nodelets {nodelets}: {report.seconds * 1e3:.3f} ms, "
                  f"{report.effective_gbps:.1f} GB/s of bytes moved, dropped "
                  f"{report.metrics['dropped_slots']} of {report.metrics['routed_slots']} slots "
                  f"(first call {report.compile_seconds * 1e3:.1f} ms)", flush=True)
            smoke.check(report.metrics["dispatch_mode"] == label, f"moe_dispatch: mode {report.metrics}")
            smoke.check(tuple(y.shape) == tuple(x.shape) and bool(torch.isfinite(y).all()),
                        f"moe_dispatch {label}: output {tuple(y.shape)} not finite or out of shape")
            smoke.check(torch.equal(y, moe_dispatch_reference(inputs, st)),
                        f"moe_dispatch {label}: engine.run differs from moe_dispatch_reference")
            t_shard = x.shape[0] // nodelets
            with torch.inference_mode():
                ids = [route(x[i * t_shard:(i + 1) * t_shard], router, k)[1].flatten().tolist()
                       for i in range(nodelets)]
            want = recount_dropped(label, ids, cfg.num_experts, k, cf)
            smoke.check(report.metrics["dropped_slots"] == want,
                        f"moe_dispatch {label}: {report.metrics['dropped_slots']} dropped, recount {want}")
            smoke.check(want > 0 or not must_drop, f"moe_dispatch {label}: {case} dropped no slot")
            smoke.check(report.traffic == moe_dispatch_traffic(inputs, st, _routing_replay(inputs)),
                        f"moe_dispatch {label}: traffic {report.traffic} is not the replay's")
            traffic[label] = (report.traffic.total_bytes, inputs)
        inputs = traffic["ep_push"][1]
        pick = choose_strategy("moe_dispatch", inputs, sub)
        _, report = run(Request("moe_dispatch", inputs, "auto", sub), cache=cache)
        print(f"  auto: {report.metrics['dispatch_mode']}, cache_hit {report.cache_hit}, "
              f"traffic {report.traffic.total_bytes} (ep_push {traffic['ep_push'][0]}, "
              f"ep_pull {traffic['ep_pull'][0]})")
        smoke.check(report.metrics["dispatch_mode"] == ("ep_pull" if pick.comm == Comm.MIGRATE
                                                        else "ep_push"), "auto: not choose_strategy's pick")
        smoke.check(report.traffic.total_bytes == min(traffic["ep_push"][0], traffic["ep_pull"][0]),
                    "auto: not the least modeled traffic")
        smoke.check(report.cache_hit, "auto: not a plan-cache hit")
    try:
        run(Request("moe_dispatch", inputs, None, CudaSubstrate(dev)), cache=cache)
    except OpNotSupportedError as e:
        print(f"  cuda substrate refuses moe_dispatch: {e}")
    else:
        raise AssertionError("CudaSubstrate ran moe_dispatch: it has no kernel for it")


def decode_server_path(smoke: Smoke, dev) -> list:
    """``DecodeServer`` through the ``EngineService`` worker loop on
    ``LocalSubstrate`` on the card, each worker on a stream of its own, for
    :data:`DECODE_CONFIGS`: :data:`DECODE_SEQS` sequences with prompts of
    2-5 tokens and :data:`DECODE_NEW` new tokens each, joining staggered
    into :data:`DECODE_CAPACITY` slots; ep_push and ep_pull at the config's
    nodelets, tp at 1, each at W = 1 and 2. The served tokens equal the
    oracle's (the same steps on the caller's stream) token for token."""
    from repro_torch.configs import get_config
    from repro_torch.core import Comm, MigratoryStrategy
    from repro_torch.engine import DecodeServer, EngineService, LocalSubstrate, PlanCache
    from repro_torch.models.transformer import moe_decode_params

    rows = []
    for arch, ep_nodelets in DECODE_CONFIGS:
        cfg = get_config(arch)
        params = moe_decode_params(cfg, seed=0, device=dev)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(2, 6))).tolist()
                   for _ in range(DECODE_SEQS)]
        sub = LocalSubstrate(dev)

        def drive(server):
            for i, prompt in enumerate(prompts):
                server.add(prompt, max_new_tokens=DECODE_NEW)
                if i % 2:
                    server.step()
            return dict(server.run_until_drained()), server.steps

        for label, st, nodelets in (("ep_push", MigratoryStrategy(comm=Comm.REMOTE_WRITE), ep_nodelets),
                                    ("ep_pull", MigratoryStrategy(comm=Comm.MIGRATE), ep_nodelets),
                                    ("tp", MigratoryStrategy(), 1)):
            mk = dict(capacity=DECODE_CAPACITY, max_len=32, nodelets=nodelets, strategy=st,
                      substrate=sub, device=dev)
            oracle, steps = drive(DecodeServer(cfg, params, oracle=True, **mk))
            for workers in (1, 2):
                svc = EngineService(cache=PlanCache(), substrate=sub, device=dev, workers=workers,
                                    slo_target_seconds=5.0).start()
                try:
                    served, _ = drive(DecodeServer(cfg, params, service=svc, **mk))
                finally:
                    svc.stop()
                report = svc.throughput_report()
                row = {"config": cfg.name, "dtype": cfg.dtype, "mode": label, "nodelets": nodelets,
                       "workers": workers, "steps": steps,
                       "steps_per_s": report["requests_per_second"],
                       "total_p50_ms": report["total_p50"] * 1e3,
                       "total_p99_ms": report["total_p99"] * 1e3,
                       "service_p50_ms": report["service_p50"] * 1e3,
                       "slo_violations": report["slo_violations"], "parity": served == oracle}
                print("  decode " + json.dumps(row), flush=True)
                rows.append(row)
                smoke.check(sorted(served) == list(range(DECODE_SEQS))
                            and all(len(t) == DECODE_NEW for t in served.values()),
                            f"decode {cfg.name} {label} W={workers}: not every sequence finished")
                smoke.check(served == oracle, f"decode {cfg.name} {label} W={workers}: served "
                                              "tokens differ from the oracle's")
        del params
        torch.cuda.empty_cache()
    return rows


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
    moe_small_agreement(dev)


def moe_small_agreement(dev) -> None:
    """``moe_dispatch`` (with SwiGLU experts) and ``moe_decode`` (serve-moe)
    on ``LocalSubstrate`` on the card against the same on the CPU, small
    float32 inputs, every mode, within ``rtol=atol=1e-5``."""
    from repro_torch.configs import get_config
    from repro_torch.core import Comm, MigratoryStrategy
    from repro_torch.engine import LocalSubstrate, MoEDecodeInputs, MoEDispatchInputs, Request, run
    from repro_torch.models.transformer import moe_decode_params

    rng = np.random.default_rng(5)
    t, d, e, f = 128, 32, 16, 24
    arrays = {"x": rng.standard_normal((t, d)), "router": rng.standard_normal((d, e)),
              **{name: 0.2 * rng.standard_normal(shape) for name, shape in
                 (("w_gate", (e, d, f)), ("w_up", (e, d, f)), ("w_down", (e, f, d)))}}
    cfg = get_config("serve-moe")
    params = moe_decode_params(cfg, seed=0, device="cpu")
    b, cache_len = 8, 16
    step = {"tokens": rng.integers(1, cfg.vocab_size, b),
            "k_cache": rng.standard_normal((b, cache_len, cfg.d_model)),
            "v_cache": rng.standard_normal((b, cache_len, cfg.d_model)),
            "positions": rng.integers(0, cache_len - 1, b)}

    def on(device):
        def tensor(a):
            return torch.as_tensor(a.astype(np.float32) if a.dtype == np.float64 else a, device=device)

        dispatch = {p: MoEDispatchInputs(nodelets=p, experts_per_token=2,
                                         **{k: tensor(a) for k, a in arrays.items()}) for p in (8, 1)}
        decode = {p: MoEDecodeInputs(params={k: w.to(device) for k, w in params.items()}, nodelets=p,
                                     experts_per_token=cfg.experts_per_token,
                                     capacity_factor=cfg.capacity_factor,
                                     **{k: tensor(a) for k, a in step.items()}) for p in (4, 1)}
        return LocalSubstrate(device), dispatch, decode

    (sub_c, disp_c, dec_c), (sub_h, disp_h, dec_h) = on(dev), on("cpu")
    for comm in Comm:
        st = MigratoryStrategy(comm=comm)
        for p in (8, 1):
            got, rep = run(Request("moe_dispatch", disp_c[p], st, sub_c), iters=1, warmup=0)
            want, _ = run(Request("moe_dispatch", disp_h[p], st, sub_h), iters=1, warmup=0)
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5,
                                       msg=lambda m: f"moe_dispatch {rep.metrics['dispatch_mode']}: {m}")
        for p in (4, 1):
            got, rep = run(Request("moe_decode", dec_c[p], st, sub_c), iters=1, warmup=0)
            want, _ = run(Request("moe_decode", dec_h[p], st, sub_h), iters=1, warmup=0)
            for name, g, w in zip(("logits", "k_cache", "v_cache"), got, want):
                torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5,
                                           msg=lambda m: f"moe_decode {rep.metrics['dispatch_mode']} {name}: {m}")
    print("  moe_dispatch (ep_push, ep_pull, tp) and moe_decode (ep_push, ep_pull, tp) on the card "
          "agree with the CPU within 1e-5")


def profile_requests(inputs: dict, lm: "dict | None") -> None:
    """One warm request of each op, one LM prefill and one decode step under
    torch.profiler: the device's busy time (sum of kernel time; one stream,
    so nothing overlaps) against the call's wall time, and the kernels that
    take it. The profiler's own overhead is inside the wall time."""
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
    profile_calls(calls)


def profile_calls(calls: dict, top: int = 4) -> None:
    """Each warm call once under torch.profiler: device busy time against
    wall time, kernel count and the ``top`` largest kernels."""
    from torch.profiler import ProfilerActivity, profile

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
        largest = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
        share = ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                          for e in largest)
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
    library_ms = csr_mv_ms(inputs["csr"], x)
    r, n = p * rp, a.shape[1]
    entry("spmv_ell", "src/repro_torch/csrc/spmv_ell.cu", "src/repro/kernels/spmv/kernel.py:31",
          float(err.max()), time_ms(lambda: spmv_ell(cols, vals, x, block_rows=grain), 50),
          time_ms(lambda: spmv_ell_plain(cols, vals, x), 20), r * k * 8 + n * 4 + r * 4, 2 * r * k,
          library_ms)

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


def cuobjdump(lib: Path, nvcc: str, flag: str) -> "list[str] | None":
    """The lines of ``cuobjdump <flag>`` on a built library, from the
    toolkit's cuobjdump (beside ``nvcc``) or the copy in Triton's package;
    None where neither is found."""
    cands = [Path(nvcc).with_name("cuobjdump")]
    spec = importlib.util.find_spec("triton")  # located, not imported
    if spec is not None and spec.submodule_search_locations:
        cands.append(Path(spec.submodule_search_locations[0]) / "backends" / "nvidia" / "bin" / "cuobjdump")
    tool = next((c for c in cands if c.exists()), None)
    if tool is None:
        return None
    return subprocess.run([str(tool), flag, str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout.splitlines()


def resource_usage(lib: Path, nvcc: str) -> "list[str] | None":
    """Registers, stack (spills), shared and local memory of every kernel in
    a built library (``cuobjdump -res-usage``), a line each."""
    lines = cuobjdump(lib, nvcc, "-res-usage")
    if lines is None:
        return None
    out, name = [], None
    for line in lines:
        if line.strip().startswith("Function "):
            name = line.strip()[len("Function "):].rstrip(":")
        elif "REG:" in line and name is not None:
            out.append(f"{name}: {line.strip()}")
    return out


def tensor_core_instructions(lib: Path, nvcc: str) -> "dict[str, int] | None":
    """Counts of HGMMA (wgmma) and HMMA (mma.sync) instructions in a built
    library's SASS; None where no cuobjdump is found."""
    sass = cuobjdump(lib, nvcc, "-sass")
    if sass is None:
        return None
    return {op: sum(f" {op}." in line or f" {op} " in line for line in sass) for op in ("HGMMA", "HMMA")}


# full attention layers at the LM cell's batch and prompt (B = 4, S = 2048,
# causal) on random inputs: (case, Hq, Hkv, D, dtype, the reduced serve
# whose launches of the same kernel instance the row reports): D 32 runs
# the reduced configs' instances (flash_tc_kernel<64, false> in bf16, the
# CUDA-core kernel at width 32 in float32)
FLASH_LAYERS = [
    ("head dim 32 (reduced configs), bf16", 32, 32, 32, torch.bfloat16, "bfloat16"),
    ("head dim 32 (reduced configs), float32", 32, 32, 32, torch.float32, "float32"),
]


def flash_vs_plain(smoke: Smoke, lm: dict, reduced: "dict | None", moe: "dict | None" = None,
                   families: "dict | None" = None) -> None:
    """flash_attn against its plain version (at the kernel's k tile) on
    layer 0's q, k, v from the llama and moonshot prefills and on each flash
    instance the served families captured (whisper-small's encoder, decoder
    self and cross attention at prefill, cross attention at decode;
    zamba2-2.7b's shared block; phi-3-vision-4.2b), on small cases of every
    mask kind at the configs' head dims, and at the full layer shapes of
    :data:`FLASH_LAYERS`; times kernel, plain version and
    scaled_dot_product_attention (a yardstick, never called by the port)."""
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain, flash_attn, kernel_block_k,
    )

    counts = tensor_core_instructions(build.library_path("flash_attn"), build.nvcc())
    if counts is None:
        print("  flash_attn tensor-core instructions: not measured (no cuobjdump)")
    else:
        print(f"  flash_attn tensor-core instructions (cuobjdump -sass): {counts}")
        smoke.check(counts["HGMMA"] + counts["HMMA"] > 0, "flash_attn: no tensor-core instruction")

    q = lm["qkv"][0]
    gen = torch.Generator().manual_seed(0)
    dims = {torch.float32: (32, 64, 80, 96, 128), torch.bfloat16: (32, 80, 96, 72, 20)}
    for dtype, dd in [(t, dd) for t, ds in dims.items() for dd in ds]:
        tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
        for bhq, bhkv, s_q, s_kv, causal, window in FLASH_SMALL_CASES:
            qs, ks, vs = (torch.randn((n, s, dd), generator=gen).to(q.device, dtype)
                          for n, s in ((bhq, s_q), (bhkv, s_kv), (bhkv, s_kv)))
            torch.testing.assert_close(
                flash_attn(qs, ks, vs, causal=causal, window=window).float(),
                flash_attention_plain(qs, ks, vs, causal=causal, window=window,
                                      block_k=kernel_block_k(dtype, dd)).float(),
                **tol, msg=lambda m: f"case {(bhq, bhkv, s_q, s_kv, causal, window, dd, dtype)}: {m}")
    print(f"  {sum(map(len, dims.values())) * len(FLASH_SMALL_CASES)} small cases agree "
          f"(head dims: float32 {dims[torch.float32]}, bf16 {dims[torch.bfloat16]})")

    def flash_row(case, q4, k4, v4, launches, causal=True, **extra):
        """One flash_attn row on (B, H, S, D) inputs (q4, k4, v4), folded to
        the kernel's (B·H, S, D), with SDPA on the unfolded views."""
        qf, kf, vf = fold_qkv(q4, k4, v4)
        dtype, dd = qf.dtype, qf.shape[2]
        block_k = kernel_block_k(dtype, dd)
        got = flash_attn(qf, kf, vf, causal=causal)
        want = flash_attention_plain(qf, kf, vf, causal=causal, block_k=block_k)
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(),
                                   **(FLASH_BF16_TOL if dtype == torch.bfloat16 else FLASH_F32_TOL))

        def library():  # is_causal aligns to the top left: every causal row here has Sq = Skv
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal, enable_gqa=True)

        try:
            lib_err = float((library().reshape(got.shape).float() - got.float()).abs().max())
            library_ms = time_ms(library, 20)
        except RuntimeError as e:  # no GQA attention in this build
            print(f"  scaled_dot_product_attention yardstick unavailable: {e}")
            lib_err, library_ms = None, None
        print(f"  {case}: q {tuple(qf.shape)} k/v {tuple(kf.shape)} {dtype}: max abs err {err} vs "
              f"the plain version, {lib_err} vs scaled_dot_product_attention")
        b_, hq_, sq_, _ = q4.shape
        skv_ = kf.shape[1]
        n_bytes = (2 * qf.numel() + kf.numel() + vf.numel()) * qf.element_size()  # q, k, v in; o out
        pairs = causal_pairs(sq_, skv_) if causal else sq_ * skv_
        n_ops = 4 * dd * b_ * hq_ * pairs  # QK^T and PV, 2 flops a MAC
        kernel_row(smoke, {"flash_attn": launches}, "flash_attn", "src/repro_torch/csrc/flash_attn.cu",
                   "src/repro/kernels/flash_attention/kernel.py:25", err,
                   time_ms(lambda: flash_attn(qf, kf, vf, causal=causal), 20),
                   time_ms(lambda: flash_attention_plain(qf, kf, vf, causal=causal, block_k=block_k), 3,
                           warmup=1),
                   n_bytes, n_ops, library_ms,
                   PEAK_BF16_PER_S if dtype == torch.bfloat16 else PEAK_FP32_PER_S,
                   case=case, head_dim=dd, dtype=str(dtype).replace("torch.", ""), causal=causal,
                   **extra)

    # (B, Hq, S, D), (B, Hkv, S, D), as the model hands them over
    flash_row(f"{LM_ARCH} layer 0 of the prefill", *lm["qkv"], lm["launches"])
    for arch, fam in (families or {}).items():
        for (sq, skv, causal), qkv in fam["captures"].items():
            where = "decode step" if sq == 1 and fam["cfg"].family == "encdec" else "prefill"
            flash_row(f"{arch} layer 0, {where}, Sq {sq} Skv {skv}{'' if causal else ' non-causal'}",
                      *qkv, fam["tally"][(sq, skv, causal)], causal=causal,
                      launches_counted_in=f"LM serve {arch}: this instance's launches")
    for case, hq_, hkv_, dd, dtype, counted_in in FLASH_LAYERS:
        q4 = torch.randn((LM_BATCH, hq_, LM_PROMPT, dd), generator=gen).to(q.device, dtype)
        k4, v4 = (torch.randn((LM_BATCH, hkv_, LM_PROMPT, dd), generator=gen).to(q.device, dtype)
                  for _ in "kv")
        flash_row(case, q4, k4, v4, (reduced or {}).get(counted_in, 0),
                  launches_counted_in=f"LM serve reduced {LM_ARCH}, {counted_in}")
    if moe is not None:  # MHA: 16 kv heads for 16 q heads, 64 (B x H) planes
        flash_row(f"{MOE_ARCH} layer 0 of the prefill", *moe["qkv"], moe["launches"],
                  launches_counted_in=f"LM serve {MOE_ARCH}, one prefill")


# -- training ------------------------------------------------------------------


def train_run(smoke: Smoke, dev, cfg, steps: int, *, seq: int = TRAIN_SEQ,
              timed_apply: bool = False, profile: bool = False,
              drop_share: bool = False) -> dict:
    """``steps`` of ``api.train_step`` on ``cfg`` (weights from seed 0 on the
    card) over the synthetic stream at :data:`TRAIN_BATCH` x ``seq``
    positions (a VLM's stub patches among them; an encoder-decoder's stub
    frames beside them), AdamW as :data:`TRAIN_OPT`: each step's milliseconds
    (host clock to the loss on the host), loss and grad norm, the peak
    memory; ``timed_apply``: then ``apply_updates`` alone on one more step's
    grads, twice, each between synchronizes; ``profile``: one more step
    under torch.profiler; ``drop_share``: the MoE layers' share of routed
    slots past capacity in step 0's forward. Prints a ``train {...}`` line;
    every loss and grad norm must be finite. ``steps_peak_bytes`` is the
    peak over the steps, ``baseline_bytes`` what the process held before
    the weights were drawn, both in the allocator's blocks; the
    ``requested_`` pair the same in the sizes the tensors asked for;
    ``cublas_workspace_bytes`` what cuBLAS's workspaces, dropped before the
    weights, held after the steps."""
    import repro_torch.models.moe as moe
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models import Ctx, api
    from repro_torch.optim import AdamWConfig, apply_updates

    torch._C._cuda_clearCublasWorkspaces()  # the steps draw their own: their size is read after
    baseline = torch.cuda.memory_allocated(dev)
    baseline_requested = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
    t0 = time.perf_counter()
    model = api.init_params(cfg, seed=0, device=dev)
    n_weights = sum(p.numel() for p in model.parameters())
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    state = api.init_opt(cfg, model, opt_cfg)
    torch.cuda.synchronize()
    print(f"  {cfg.name} ({cfg.num_layers} layers, {cfg.dtype}, remat {cfg.remat}, attention "
          f"{cfg.attn_impl}): {n_weights} weights and their float32 moments on the card in "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
          "allocated", flush=True)
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=TRAIN_BATCH,
        seq_len=seq - cfg.num_patches if cfg.family == "vlm" else seq))

    def batch_at(step: int) -> dict:
        batch = data.torch_batch(step, dev)
        batch.update({k: torch.as_tensor(v, device=dev)
                      for k, v in stub_inputs(cfg, TRAIN_BATCH, step).items()})
        return batch

    ctx = Ctx(cfg)
    stats = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype, "weights": n_weights,
             "batch": TRAIN_BATCH, "seq": seq}
    if drop_share:
        dispatch, kept = moe._local_dispatch, []

        def capture(*args):
            out = dispatch(*args)
            kept.append(out[3])
            return out

        moe._local_dispatch = capture
        try:
            with torch.no_grad():
                api.loss_fn(ctx, model, batch_at(0))
        finally:
            moe._local_dispatch = dispatch
        stats["capacity"] = moe._capacity(cfg, TRAIN_BATCH * seq, cfg.num_experts)
        stats["drop_share"] = [float((~k).float().mean()) for k in kept]
        smoke.check(len(kept) == cfg.num_layers, f"{len(kept)} MoE dispatches in {cfg.num_layers} layers")

    torch.cuda.reset_peak_memory_stats(dev)
    step_ms, losses, norms = [], [], []
    for step in range(steps):
        batch = batch_at(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, metrics = api.train_step(ctx, model, state, batch, opt_cfg)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(metrics["grad_norm"]))
    median = float(np.median(step_ms[1:]))
    stats.update(step_ms=step_ms, step_ms_median_after_first=median,
                 tokens_per_s=TRAIN_BATCH * seq / median * 1e3, loss=losses, grad_norm=norms,
                 steps_peak_bytes=torch.cuda.max_memory_allocated(dev), baseline_bytes=baseline,
                 steps_requested_peak_bytes=torch.cuda.memory_stats(dev)["requested_bytes.all.peak"],
                 baseline_requested_bytes=baseline_requested)
    if timed_apply:
        named = dict(model.named_parameters())
        loss = api.loss_fn(ctx, model, batch_at(steps))
        grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
        del loss
        apply_ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state, _ = apply_updates(model, state, grads, opt_cfg)
            torch.cuda.synchronize()
            apply_ms.append((time.perf_counter() - t0) * 1e3)
        stats["apply_updates_ms"] = apply_ms
        del grads, named
    stats["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    held = torch.cuda.memory_allocated(dev)
    torch._C._cuda_clearCublasWorkspaces()
    stats["cublas_workspace_bytes"] = held - torch.cuda.memory_allocated(dev)
    print("  train " + json.dumps(stats), flush=True)
    smoke.check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
                f"{cfg.name}: non-finite loss or grad norm: {losses} {norms}")
    if profile:
        batch = batch_at(steps + 1)
        box = [state]

        def one_step():
            _, box[0], metrics = api.train_step(ctx, model, box[0], batch, opt_cfg)
            return float(metrics["loss"])

        profile_calls({f"{cfg.name} train step ({TRAIN_BATCH}x{seq}, "
                       f"{cfg.num_layers} layers)": one_step}, top=8)
    del model, state
    torch.cuda.empty_cache()
    return stats


def lm_train_path(smoke: Smoke, dev) -> dict:
    """llama3.2-3b at full width: bf16, remat on, the reference attention
    branch (the flash kernel has no backward), :data:`TRAIN_STEPS` steps."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(LM_ARCH), remat=True, attn_impl="reference")
    stats = train_run(smoke, dev, cfg, TRAIN_STEPS, timed_apply=True, profile=True)
    smoke.cells.append(unsharded_cell(cfg, TRAIN_SEQ, stats))
    return stats


def family_train_path(smoke: Smoke, dev, arch: str, seq: int) -> dict:
    """``arch`` (one of :data:`FAMILY_TRAIN`) trained unsharded at full
    width and depth: bf16, remat on, the reference attention branch,
    :data:`FAMILY_TRAIN_STEPS` steps of TRAIN_BATCH x ``seq`` positions (the
    ``train {...}`` line: step ms, tokens/s, peak GiB, finite losses and
    grad norms), printed beside the card's name and power limit."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), remat=True, attn_impl="reference")
    stats = train_run(smoke, dev, cfg, FAMILY_TRAIN_STEPS, seq=seq)
    print(f"  {arch} unsharded train on {card_line()}: timed step "
          f"{stats['step_ms_median_after_first']:.1f} ms, {stats['tokens_per_s']:.0f} positions/s, "
          f"peak {stats['peak_gib']:.2f} GiB", flush=True)
    smoke.cells.append(unsharded_cell(cfg, seq, stats))
    return stats


def unsharded_cell(cfg, seq: int, stats: dict) -> dict:
    """An unsharded train run as a dry-run cell on a 1 x 1 mesh: the
    peak over its steps less what the process held before its weights."""
    from repro_torch.configs import ShapeSpec

    return {"what": f"{cfg.name} train step, unsharded", "cfg": cfg, "sizes": (1, 1),
            "shape": ShapeSpec("train_unsharded", "train", seq, TRAIN_BATCH), "microbatches": 1,
            "calls": {}, "peak_bytes": [stats["steps_peak_bytes"] - stats["baseline_bytes"]],
            "requested_peak_bytes": [stats["steps_requested_peak_bytes"]
                                     - stats["baseline_requested_bytes"]],
            "ms": stats["step_ms_median_after_first"]}


def mesh_cell(what: str, progs, shape, ms: float) -> dict:
    """A call on the 2 x 2 mesh as a dry-run cell: its config and shape, the
    collective calls per axis and each rank's peak bytes during it."""
    return {"what": what, "cfg": progs.ctx.cfg, "sizes": MESH_LM_SHAPE, "shape": shape,
            "microbatches": progs.microbatches,
            "calls": {a: c["calls"] for a, c in progs.collectives().items()},
            "peak_bytes": [st.get("peak_bytes", 0) for st in progs.last_stats],
            "requested_peak_bytes": [st.get("requested_peak_bytes", 0) for st in progs.last_stats],
            "ms": ms}


def dryrun_vs_card(smoke: Smoke) -> None:
    """Phase "dry-run vs the card": every cell recorded by the mesh and
    unsharded train phases traced by the dry-run (``launch/dryrun.py``: rank
    0 on the meta device, no process, no card) at the same config, depth,
    batch, sequence and mesh shape, :data:`DRYRUN_WORKERS` traces at once.
    Its collective calls per axis must equal the mesh's, and its peak a
    rank over the measured one lie in :data:`DRYRUN_PEAK_BAND`; a ``dryrun
    {...}`` line a cell prints both with the roofline's compute, memory and
    collective terms beside the measured ms."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.launch.dryrun import trace_cell

    card = card_line()
    cells = smoke.cells
    smoke.check(bool(cells), "no mesh or train call was recorded")
    t0 = time.perf_counter()
    with ProcessPoolExecutor(DRYRUN_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        traced = list(pool.map(trace_cell, [c["cfg"] for c in cells], [c["sizes"] for c in cells],
                               [("data", "model")] * len(cells), [c["shape"] for c in cells],
                               [c["microbatches"] for c in cells]))
    wall = time.perf_counter() - t0
    lo, hi = DRYRUN_PEAK_BAND
    bad, ratios, excess, requested_gap = [], [], [], []
    for c, t in zip(cells, traced):
        pred = t["memory"]["peak_bytes_per_dev"]
        ratio = pred / c["peak_bytes"][0]
        ratios.append(ratio)
        # the measured peak over the predicted one, split in two: the
        # allocator's blocks over the sizes asked for (rounding, cached
        # blocks handed out whole), and the sizes asked for over the trace's
        excess.append((c["peak_bytes"][0] - c["requested_peak_bytes"][0]) / 2**30)
        requested_gap.append((c["requested_peak_bytes"][0] - pred) / 2**30)
        rf = t["roofline"]
        row = {"what": c["what"], "mesh": list(c["sizes"]), "shape": dataclasses.asdict(c["shape"]),
               "layers": c["cfg"].num_layers, "card": card, "calls": c["calls"],
               "traced_calls": t["collective_calls"],
               "peak_gib_a_rank": [b / 2**30 for b in c["peak_bytes"]],
               "predicted_peak_gib": pred / 2**30, "predicted_over_measured": ratio,
               "requested_peak_gib_a_rank": [b / 2**30 for b in c["requested_peak_bytes"]],
               "blocks_over_requested_gib": excess[-1], "requested_over_predicted_gib": requested_gap[-1],
               "memory": t["memory"], "measured_ms": c["ms"],
               "t_compute_ms": rf["t_compute"] * 1e3, "t_memory_ms": rf["t_memory"] * 1e3,
               "t_collective_ms": rf["t_collective"] * 1e3, "dominant": rf["dominant"],
               "flops": rf["flops"], "flops_by_dtype": t["flops_by_dtype"],
               "bytes_hbm": rf["bytes_hbm"], "bytes_collective": rf["bytes_collective"],
               "trace_s": t["seconds_trace"]}
        print("  dryrun " + json.dumps(row), flush=True)
        if t["collective_calls"] != c["calls"]:
            bad.append(f"{c['what']}: the mesh's calls {c['calls']}, traced {t['collective_calls']}")
        if not lo <= ratio <= hi:
            bad.append(f"{c['what']}: predicted peak over measured {ratio:.3f} outside {DRYRUN_PEAK_BAND}")
    print(f"  dry-run of {len(cells)} cells in {wall:.1f} s ({DRYRUN_WORKERS} processes); predicted "
          f"over measured peak from {min(ratios):.3f} to {max(ratios):.3f}; measured over predicted: "
          f"blocks over requested sizes {min(excess):.4f} to {max(excess):.4f} GiB, requested sizes "
          f"over predicted {min(requested_gap):.4f} to {max(requested_gap):.4f} GiB", flush=True)
    smoke.check(not bad, "; ".join(bad))


def dryrun_split_cells(smoke: Smoke) -> None:
    """Phase "dry-run compute term, rwkv6-3b and zamba2-2.7b production
    cells (single pod)": the :data:`DRYRUN_SPLIT_SHAPES` of
    :data:`DRYRUN_SPLIT_ARCHS` on the single-pod production mesh, traced as
    ``python -m repro_torch.launch.dryrun`` traces a cell (``run_cell``: rank
    0 on the meta device, no card), :data:`DRYRUN_WORKERS` cells at once. A
    ``dryrun_split {...}`` line a cell: the compute, memory and collective
    terms, the traced FLOPs a device by type and the useful-FLOPs ratio;
    every applicable cell must trace."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.launch.dryrun import run_cell

    card = card_line()
    todo = [(arch, shape) for arch in DRYRUN_SPLIT_ARCHS for shape in DRYRUN_SPLIT_SHAPES]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(DRYRUN_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        done = list(pool.map(run_cell, [a for a, _ in todo], [s for _, s in todo],
                             ["single"] * len(todo)))
    for r in done:
        row = {k: r[k] for k in ("arch", "shape", "mesh", "status")}
        if r["status"] == "ok":
            rf = r["roofline"]
            row.update(n_chips=r["n_chips"], t_compute_ms=rf["t_compute"] * 1e3,
                       t_memory_ms=rf["t_memory"] * 1e3, t_collective_ms=rf["t_collective"] * 1e3,
                       dominant=rf["dominant"], flops_per_dev=rf["flops"],
                       flops_by_dtype=r["flops_by_dtype"],
                       useful_flops_ratio=r["useful_flops_ratio"],
                       trace_s=r["seconds_trace"], card=card)
        print("  dryrun_split " + json.dumps(row), flush=True)
    print(f"  {len(done)} cells traced in {time.perf_counter() - t0:.1f} s ({DRYRUN_WORKERS} "
          "processes)", flush=True)
    smoke.check(all(r["status"] in ("ok", "skipped") for r in done), "a cell did not trace")
    smoke.check(any(r["status"] == "ok" for r in done), "no cell traced")


def remat_vs_plain(smoke: Smoke, dev) -> None:
    """The grads of ``loss_fn`` (remat, the chunked CE, the q-chunked
    attention with each tile checkpointed) against the plain path's (no
    remat, dense attention, full-logits ``cross_entropy``) on one batch of
    :data:`TRAIN_BATCH` x :data:`TRAIN_SEQ`, at llama3.2-3b's widths cut to
    :data:`REMAT_LAYERS` layers, in float32 with TF32 off: each parameter's
    relative Frobenius error within :data:`REMAT_GRAD_RTOL`."""
    import dataclasses

    import torch.nn.functional as F

    import repro_torch.models.layers as layers
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import Ctx, api
    from repro_torch.models.transformer import backbone

    smoke.check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=REMAT_LAYERS, dtype="float32",
                              remat=True, attn_impl="reference")
    model = api.init_params(cfg, seed=0, device=dev)
    weights = list(model.parameters())
    tokens = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH)).torch_batch(0, dev)["tokens"].long()
    tiles = []
    checkpoint = layers.checkpoint

    def counting(fn, *args, **kw):
        tiles.append(fn.__name__)
        return checkpoint(fn, *args, **kw)

    layers.checkpoint = counting
    try:
        t0 = time.perf_counter()
        loss = api.loss_fn(Ctx(cfg), model, {"tokens": tokens})
        g_remat = torch.autograd.grad(loss, weights)
        loss = float(loss.detach())
        torch.cuda.synchronize()
        remat_ms = (time.perf_counter() - t0) * 1e3
    finally:
        layers.checkpoint = checkpoint
    n_tiles = tiles.count("tile")
    budget = layers._SCORE_BYTE_BUDGET
    layers._SCORE_BYTE_BUDGET = 1 << 62  # dense attention: no q tiles
    try:
        t0 = time.perf_counter()
        x = backbone(Ctx(dataclasses.replace(cfg, remat=False)), model, tokens[:, :-1])
        plain = F.cross_entropy((x @ model.lm_head).float().flatten(0, 1), tokens[:, 1:].flatten())
        g_plain = torch.autograd.grad(plain, weights)
        plain = float(plain.detach())
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    finally:
        layers._SCORE_BYTE_BUDGET = budget
    errs = {name: float((a - b).norm() / b.norm().clamp_min(1e-30))
            for (name, _), a, b in zip(model.named_parameters(), g_remat, g_plain)}
    worst = max(errs, key=errs.get)
    print(f"  {cfg.name} at {cfg.num_layers} layers, float32, {TRAIN_BATCH}x{TRAIN_SEQ}: remat loss "
          f"{loss} ({n_tiles} attention tiles checkpointed; forward + grads {remat_ms:.1f} ms), "
          f"plain loss {plain} ({plain_ms:.1f} ms); grads' relative Frobenius error: largest "
          f"{errs[worst]} ({worst}), median {float(np.median(list(errs.values())))}", flush=True)
    smoke.check(n_tiles > 0, "the q-chunked attention checkpointed no tile")
    smoke.check(abs(loss - plain) <= REMAT_GRAD_RTOL * abs(plain), f"remat loss {loss} vs plain {plain}")
    smoke.check(errs[worst] <= REMAT_GRAD_RTOL, f"{worst}: remat grads differ from the plain path's by "
                                                f"{errs[worst]} > {REMAT_GRAD_RTOL}")
    del model, weights, g_remat, g_plain, x
    torch.cuda.empty_cache()


def reduced_train_path(smoke: Smoke, dev) -> None:
    """The reduced float32 llama3.2-3b: :data:`REDUCED_TRAIN_STEPS`
    ``train_step``s on the card and on the CPU from the same weights and
    batches (losses within :data:`TRAIN_LOSS_RTOL`); then ``run_supervised``
    on the card into a temporary directory, 14 steps unfailed and with a
    failure injected at step 8: one restart, and the last 3 losses equal to
    the unfailed run's within :data:`TRAIN_LOSS_RTOL`."""
    import tempfile

    from repro_torch.configs import reduced_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import Ctx, api
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import SupervisorConfig, run_supervised

    cfg = reduced_config(LM_ARCH)
    ctx = Ctx(cfg)
    cpu_model = api.init_params(cfg, seed=0, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=14)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4))
    losses = {}
    for where in ("cpu", dev):
        model = api.init_params(cfg, seed=0, device=where)
        model.load_state_dict(cpu_model.state_dict())
        state, losses[str(where)] = api.init_opt(cfg, model, opt_cfg), []
        for step in range(REDUCED_TRAIN_STEPS):
            _, state, metrics = api.train_step(ctx, model, state, data.torch_batch(step, where), opt_cfg)
            losses[str(where)].append(float(metrics["loss"]))
    card, cpu = losses[str(dev)], losses["cpu"]
    err = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    print(f"  reduced {cfg.name} float32, {REDUCED_TRAIN_STEPS} steps: card {card}, CPU {cpu}; "
          f"largest relative difference {err}", flush=True)
    smoke.check(err <= TRAIN_LOSS_RTOL, f"card and CPU losses differ by {err} > {TRAIN_LOSS_RTOL}")

    def build():
        params = api.init_params(cfg, seed=0, device=dev)
        params.load_state_dict(cpu_model.state_dict())
        return params, api.init_opt(cfg, params, opt_cfg), (
            lambda p, o, b: api.train_step(ctx, p, o, b, opt_cfg))

    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        for name, fail_at in (("unfailed", None), ("failed", 8)):
            sup = SupervisorConfig(ckpt_dir=f"{tmp}/{name}", ckpt_every=5, total_steps=14)
            runs[name] = run_supervised(sup, build=build, data_for_step=lambda s: data.torch_batch(s, dev),
                                        fail_at=fail_at)
    a, b = runs["unfailed"], runs["failed"]
    print(f"  run_supervised on the card, 14 steps: unfailed restarts {a.restarts}, last losses "
          f"{a.losses[-3:]}; failure at step 8: restarts {b.restarts}, {len(b.losses)} steps run, "
          f"last losses {b.losses[-3:]}", flush=True)
    smoke.check(a.restarts == 0 and b.restarts == 1, f"restarts {a.restarts}, {b.restarts}")
    smoke.check(all(abs(x - y) <= TRAIN_LOSS_RTOL * abs(y) for x, y in zip(b.losses[-3:], a.losses[-3:])),
                "the recovered run's last losses differ from the unfailed run's")


def moe_train_path(smoke: Smoke, dev) -> dict:
    """moonshot-v1-16b-a3b at full width cut to :data:`MOE_TRAIN_LAYERS`
    layers, bf16, :data:`MOE_TRAIN_STEPS` steps: grads through the routing
    and the capacity buffers (64 experts, top-6), the forward's drop share
    printed."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_TRAIN_LAYERS, remat=True,
                              attn_impl="reference")
    return train_run(smoke, dev, cfg, MOE_TRAIN_STEPS, drop_share=True)


def lm_mesh_path(smoke: Smoke, dev) -> dict:
    """The LM's ``(data, model)`` mesh on the card (phase "LM (data, model)
    mesh, 2 x 2 rank processes on the card"): :data:`MESH_LM_SHAPE` rank
    processes sharing the card (gloo, every collective staged through
    pinned host memory), each drawing every weight from seed 0 and keeping
    its block (``CellPrograms.init``). llama3.2-3b at full width and depth:
    a prefill at LM_BATCH x LM_PROMPT with flash attention and
    :data:`MESH_LM_GEN` decode steps fed the unsharded model's greedy
    tokens, each held to the unsharded model's logits (LM_LOGIT_ATOL); then
    one train step (reference attention, remat) whose loss is held to the
    unsharded loss (:data:`MESH_LOSS_ATOL`). moonshot-v1-16b-a3b at full
    width cut to :data:`MESH_MOE_LAYERS` layers: a prefill in ep_push,
    ep_pull and tp at factor :data:`MESH_NODROP_CF` (no slot may drop;
    logits held to the unsharded prefill's), then at the config's 1.25 with
    each mode's drop share. Every call prints its host ms, the ranks'
    collective calls and seconds per axis, flash launches a rank and card
    memory a rank (an ``lm_mesh {...}`` line); the ranks close in a
    ``finally`` and every exit code must be 0. The unsharded references run
    first, their weights freed before the ranks start."""
    import dataclasses

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (
        build_decode_programs, build_prefill_programs, build_train_programs,
    )
    from repro_torch.models import Ctx, api
    from repro_torch.optim import AdamWConfig

    card = card_line()
    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="flash")
    train_cfg = dataclasses.replace(cfg, attn_impl="reference")
    rng = np.random.default_rng(1)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(dev)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).to(dev)}
    max_len = LM_PROMPT + MESH_LM_GEN

    t0 = time.perf_counter()  # the unsharded references
    model = api.init_params(cfg, seed=0, device=dev)
    ctx = Ctx(cfg)
    want_prefill, caches = api.prefill(ctx, model, prompts, max_len)
    tokens, want_decode = [want_prefill.argmax(-1)], []
    for _ in range(MESH_LM_GEN):
        logits, caches = api.decode_step(ctx, model, tokens[-1], caches)
        want_decode.append(logits.float())
        tokens.append(logits.argmax(-1))
    with torch.no_grad():
        want_loss = float(api.loss_fn(Ctx(train_cfg), model, batch))
    del model, caches
    mcfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MESH_MOE_LAYERS, attn_impl="flash")
    moe_prompts = prompts.remainder(mcfg.vocab_size)
    model = api.init_params(mcfg, seed=0, device=dev)
    nodrop = dataclasses.replace(mcfg, capacity_factor=MESH_NODROP_CF)
    want_moe = api.prefill(Ctx(nodrop), model, moe_prompts, LM_PROMPT)[0].float()
    del model
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"  unsharded references ({LM_ARCH} prefill, {MESH_LM_GEN} decode steps, loss; "
          f"{MOE_ARCH} {MESH_MOE_LAYERS} layers at factor {MESH_NODROP_CF}): "
          f"{time.perf_counter() - t0:.1f} s; loss {want_loss:.6f}", flush=True)

    rows: list = []

    def record(what: str, progs, ms: float, **extra) -> dict:
        row = mesh_call_row(what, progs, ms, **extra)
        rows.append(row)
        print("  lm_mesh " + json.dumps({**row, "card": card}), flush=True)
        return row

    timed, diff = timed_ms, max_abs_diff
    mesh = make_mesh(MESH_LM_SHAPE, ("data", "model"), device=dev, timeout=MESH_LM_TIMEOUT_S)
    summary: dict = {"card": card}
    try:
        print(f"  {mesh.describe()}", flush=True)
        summary.update(launch_to_ready_s=mesh.ready_seconds,
                       reserved_gib_a_rank_at_ready=[
                           round(m.get("reserved_bytes", 0) / 2**30, 3) for m in mesh.memory()])
        shape = ShapeSpec("mesh_serve", "prefill", max_len, LM_BATCH)
        pre = build_prefill_programs(cfg, mesh, shape, key="llama")
        dec = build_decode_programs(cfg, mesh, dataclasses.replace(shape, kind="decode"),
                                    key="llama")
        _, init_ms = timed(pre.init, 0)
        record("init llama3.2-3b (each rank draws every weight, keeps its block)", pre, init_ms)
        for attempt in ("cold", "warm"):
            logits, ms = timed(pre.step, {"tokens": prompts})
            err = diff(logits, want_prefill.float())
            row = record(f"prefill {attempt}", pre, ms, max_abs_logit_diff=err)
            if attempt == "cold":  # the warm call holds the cold call's state as well
                smoke.cells.append(mesh_cell(f"{LM_ARCH} prefill", pre, shape, ms))
            smoke.check(err <= LM_LOGIT_ATOL, f"mesh prefill logits differ by {err}")
            smoke.check(row["flash_launches_a_rank"] == [cfg.num_layers] * mesh.size,
                        f"flash launches a rank {row['flash_launches_a_rank']}")
        decode_ms, errs = [], []
        for i in range(MESH_LM_GEN):
            logits, ms = timed(dec.step, tokens[i])
            decode_ms.append(ms)
            errs.append(diff(logits, want_decode[i]))
        record("decode steps", dec, decode_ms[-1], decode_ms=decode_ms,
               max_abs_logit_diff=max(errs))
        smoke.cells.append(mesh_cell(f"{LM_ARCH} decode step", dec,
                                     dataclasses.replace(shape, kind="decode"), decode_ms[-1]))
        smoke.check(max(errs) <= LM_LOGIT_ATOL, f"mesh decode logits differ by {max(errs)}")
        pre.release()
        train_shape = ShapeSpec("mesh_train", "train", TRAIN_SEQ, TRAIN_BATCH)
        train = build_train_programs(train_cfg, mesh, train_shape, AdamWConfig(**TRAIN_OPT),
                                     key="llama-train")
        _, init_ms = timed(train.init, 0)
        metrics, ms = timed(train.step, batch)
        smoke.cells.append(mesh_cell(f"{LM_ARCH} train step", train, train_shape, ms))
        row = record("train step", train, ms, loss=metrics["loss"], unsharded_loss=want_loss,
                     grad_norm=metrics["grad_norm"])
        smoke.check(abs(metrics["loss"] - want_loss) <= MESH_LOSS_ATOL,
                    f"mesh step-1 loss {metrics['loss']} vs unsharded {want_loss}")
        train.release()
        summary.update(prefill_ms=rows[2]["ms"], decode_ms_a_step=float(np.median(decode_ms)),
                       train_step_ms=ms, loss=metrics["loss"], unsharded_loss=want_loss)

        modes = ("ep_push", "ep_pull", "tp")
        moe_shape = ShapeSpec("mesh_moe", "prefill", LM_PROMPT, LM_BATCH)
        base = build_prefill_programs(nodrop, mesh, moe_shape, key="moonshot")
        _, init_ms = timed(base.init, 0)
        record(f"init {MOE_ARCH} ({MESH_MOE_LAYERS} layers)", base, init_ms)
        for cf in (MESH_NODROP_CF, mcfg.capacity_factor):
            for mode in modes:
                progs = build_prefill_programs(
                    dataclasses.replace(mcfg, capacity_factor=cf, moe_dispatch=mode), mesh,
                    moe_shape, key="moonshot")
                logits, ms = timed(progs.step, {"tokens": moe_prompts})
                drops = progs.drops()
                share = 1 - drops["kept"] / max(drops["routed"], 1)
                extra = {"mode": mode, "capacity_factor": cf, "drop_share": share}
                if cf == MESH_NODROP_CF:
                    err = diff(logits, want_moe)
                    extra["max_abs_logit_diff"] = err
                    smoke.check(drops["kept"] == drops["routed"] > 0,
                                f"{mode} at factor {cf}: {drops}")
                    smoke.check(err <= LM_LOGIT_ATOL, f"{mode}: logits differ by {err}")
                record(f"{MOE_ARCH} prefill", progs, ms, **extra)
                smoke.cells.append(mesh_cell(f"{MOE_ARCH} prefill, {mode}, factor {cf}", progs,
                                             moe_shape, ms))
        base.release()
    finally:
        mesh.close()
        print(f"  lm mesh closed: rank exit codes {mesh.exit_codes}", flush=True)
    smoke.check(mesh.exit_codes == [0] * mesh.size, f"a rank did not exit cleanly: {mesh.exit_codes}")
    print("  lm_mesh_summary " + json.dumps(summary), flush=True)
    return summary


def mesh_call_row(what: str, progs, ms: float, **extra) -> dict:
    """One mesh call's row: host ms, the collectives per axis (calls,
    seconds, seconds a call), flash launches and card memory a rank."""
    stats = progs.last_stats
    row = {"what": what, "ms": ms, "collectives": progs.collectives(),
           "flash_launches_a_rank": [st["flash_launches"] for st in stats],
           "peak_gib_a_rank": [round(st.get("peak_bytes", 0) / 2**30, 3) for st in stats],
           "reserved_gib_a_rank": [round(st.get("reserved_bytes", 0) / 2**30, 3)
                                   for st in stats], **extra}
    for c in row["collectives"].values():
        c["seconds_a_call"] = c["seconds"] / max(c["calls"], 1)
    return row


def timed_ms(fn, *args):
    """(fn(*args), its host milliseconds)."""
    t = time.perf_counter()
    out = fn(*args)
    return out, (time.perf_counter() - t) * 1e3


def max_abs_diff(got, want) -> float:
    return float((got.float().to(want.device) - want).abs().max())


def lm_mesh_families_path(smoke: Smoke, dev) -> dict:
    """The ssm, hybrid and encdec families on the LM's ``(data, model)``
    mesh (phase "LM (data, model) mesh: ssm, hybrid, encdec"), as
    :func:`mesh_families` serves and trains them: the three
    :data:`MESH_FAMILIES` on one mesh."""
    return mesh_families(smoke, dev, MESH_FAMILIES, "families")


def lm_mesh_vlm_path(smoke: Smoke, dev) -> dict:
    """phi-3-vision-4.2b (:data:`MESH_VLM`, the vlm family: the
    transformer's mesh branches with its stub patches before the prompt) on
    a mesh of its own (phase "LM mesh (phi-3-vision-4.2b, 2 x 2, one
    card)"), as :func:`mesh_families` serves and trains the families."""
    return mesh_families(smoke, dev, (MESH_VLM,), "vlm")


def mesh_families(smoke: Smoke, dev, archs: tuple, label: str) -> dict:
    """``archs`` on the LM's ``(data, model)`` mesh: one mesh of
    :data:`MESH_LM_SHAPE` rank processes sharing the card, a programs key
    an arch, released before the next. Each at full width and depth (bf16,
    flash attention where it has attention): the ranks draw every weight
    from seed 0 and keep their blocks, a prefill at its ``FAMILIES`` prompt
    and LM_BATCH rows (whisper with the stub frontend's frames, the VLM
    after its stub patches), :data:`MESH_FAMILY_GEN` decode steps
    fed the unsharded model's greedy tokens, each held to the unsharded
    model's logits (LM_LOGIT_ATOL); flash launches a rank a prefill as
    :func:`flash_per_serve` counts a prefill's. Then one train step at full
    width, depth and sequence cut as :data:`MESH_FAMILY_TRAIN` gives them
    (reference attention, remat, AdamW as the train cell), its loss held to
    the unsharded loss (:data:`MESH_LOSS_ATOL`). An ``lm_mesh {...}`` line a
    family: init seconds, prefill ms, decode ms a step, train step ms, the
    collectives of each call per axis, flash launches and peak memory a
    rank, the logit and loss differences; then an ``lm_mesh_<label>_summary``
    line (times, loss differences and ``model`` collective calls a call).
    The unsharded references run first, their weights freed before the
    ranks start; the ranks close in a ``finally`` and every exit code must
    be 0."""
    import dataclasses

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.launch.steps import (
        build_decode_programs, build_prefill_programs, build_train_programs,
    )
    from repro_torch.models import Ctx, api
    from repro_torch.optim import AdamWConfig

    card = card_line()
    prompt_of = {arch: prompt for arch, prompt, _ in FAMILIES}
    rng = np.random.default_rng(1)
    cells = {}
    t0 = time.perf_counter()  # the unsharded references
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
        layers, seq = MESH_FAMILY_TRAIN[arch]
        tcfg = dataclasses.replace(cfg, num_layers=layers, attn_impl="reference")
        prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LM_BATCH, prompt_of[arch])))
        extra = {k: torch.as_tensor(v).to(dev) for k, v in stub_inputs(cfg, LM_BATCH, 2).items()}
        patches = cfg.num_patches if cfg.family == "vlm" else 0  # positions before the tokens
        tbatch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, seq - patches + 1))).to(dev),
            **{k: torch.as_tensor(v).to(dev) for k, v in stub_inputs(cfg, TRAIN_BATCH, 3).items()}}
        max_len = patches + prompts.shape[1] + MESH_FAMILY_GEN
        model = api.init_params(cfg, seed=0, device=dev)
        ctx = Ctx(cfg)
        want_prefill, state = api.prefill(ctx, model, prompts.to(dev), max_len, batch=extra)
        tokens, want_decode = [want_prefill.argmax(-1)], []
        for _ in range(MESH_FAMILY_GEN):
            logits, state = api.decode_step(ctx, model, tokens[-1], state)
            want_decode.append(logits.float())
            tokens.append(logits.argmax(-1))
        del model, state
        model = api.init_params(tcfg, seed=0, device=dev)
        with torch.no_grad():
            want_loss = float(api.loss_fn(Ctx(tcfg), model, tbatch))
        del model
        torch.cuda.empty_cache()
        cells[arch] = dict(cfg=cfg, tcfg=tcfg, seq=seq, prompts=prompts.to(dev), extra=extra,
                           tbatch=tbatch, max_len=max_len, want_prefill=want_prefill.float(),
                           tokens=tokens, want_decode=want_decode, want_loss=want_loss)
    torch.cuda.synchronize()
    print(f"  unsharded references ({', '.join(archs)}: prefill, {MESH_FAMILY_GEN} decode "
          f"steps, train-cut loss): {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    mesh = make_mesh(MESH_LM_SHAPE, ("data", "model"), device=dev, timeout=MESH_LM_TIMEOUT_S)
    summary: dict = {"card": card, "launch_to_ready_s": mesh.ready_seconds}
    try:
        print(f"  {mesh.describe()}", flush=True)
        for arch, c in cells.items():
            cfg, tcfg = c["cfg"], c["tcfg"]
            shape = ShapeSpec("mesh_serve", "prefill", c["max_len"], LM_BATCH)
            pre = build_prefill_programs(cfg, mesh, shape, key=arch)
            dec = build_decode_programs(cfg, mesh, dataclasses.replace(shape, kind="decode"),
                                        key=arch)
            _, init_ms = timed_ms(pre.init, 0)
            logits, ms = timed_ms(pre.step, {"tokens": c["prompts"], **c["extra"]})
            prefill = mesh_call_row("prefill", pre, ms, max_abs_logit_diff=max_abs_diff(
                logits, c["want_prefill"]))
            smoke.cells.append(mesh_cell(f"{arch} prefill", pre, shape, ms))
            flash = flash_per_serve(cfg, 1)
            smoke.check(prefill["max_abs_logit_diff"] <= LM_LOGIT_ATOL,
                        f"{arch}: mesh prefill logits differ by {prefill['max_abs_logit_diff']}")
            smoke.check(prefill["flash_launches_a_rank"] == [flash] * mesh.size,
                        f"{arch}: flash launches a rank {prefill['flash_launches_a_rank']}, "
                        f"expected {flash}")
            decode_ms, errs = [], []
            for i in range(MESH_FAMILY_GEN):
                logits, ms = timed_ms(dec.step, c["tokens"][i])
                decode_ms.append(ms)
                errs.append(max_abs_diff(logits, c["want_decode"][i]))
            decode = mesh_call_row("decode step", dec, decode_ms[-1])
            smoke.cells.append(mesh_cell(f"{arch} decode step", dec,
                                         dataclasses.replace(shape, kind="decode"), decode_ms[-1]))
            smoke.check(max(errs) <= LM_LOGIT_ATOL, f"{arch}: mesh decode logits differ by {errs}")
            pre.release()
            train_shape = ShapeSpec("mesh_train", "train", c["seq"], TRAIN_BATCH)
            train = build_train_programs(tcfg, mesh, train_shape, AdamWConfig(**TRAIN_OPT),
                                         key=f"{arch}-train")
            _, train_init_ms = timed_ms(train.init, 0)
            metrics, ms = timed_ms(train.step, c["tbatch"])
            step = mesh_call_row("train step", train, ms)
            smoke.cells.append(mesh_cell(f"{arch} train step ({tcfg.num_layers} layers)", train,
                                         train_shape, ms))
            loss_diff = abs(metrics["loss"] - c["want_loss"])
            smoke.check(loss_diff <= MESH_LOSS_ATOL,
                        f"{arch}: mesh step-1 loss {metrics['loss']} vs unsharded {c['want_loss']}")
            train.release()
            row = {"arch": arch, "family": cfg.family, "card": card,
                   "launch_to_ready_s": mesh.ready_seconds, "init_s": init_ms / 1e3,
                   "prompt": c["prompts"].shape[1], "batch": LM_BATCH,
                   "prefill_ms": prefill["ms"], "decode_ms": decode_ms,
                   "decode_ms_a_step": float(np.median(decode_ms)),
                   "train": {"layers": tcfg.num_layers, "batch": TRAIN_BATCH, "seq": c["seq"],
                             "microbatches": train.microbatches, "init_s": train_init_ms / 1e3},
                   "train_step_ms": step["ms"],
                   "collectives": {"prefill": prefill["collectives"],
                                   "decode_step": decode["collectives"],
                                   "train_step": step["collectives"]},
                   "flash_launches_a_rank_a_prefill": prefill["flash_launches_a_rank"],
                   "flash_launches_a_rank_a_decode_step": decode["flash_launches_a_rank"],
                   "peak_gib_a_rank": {"prefill": prefill["peak_gib_a_rank"],
                                       "decode": decode["peak_gib_a_rank"],
                                       "train": step["peak_gib_a_rank"]},
                   "max_abs_logit_diff": {"prefill": prefill["max_abs_logit_diff"],
                                          "decode": max(errs)},
                   "unsharded_max_abs_logit": float(c["want_prefill"].abs().max()),
                   "loss": metrics["loss"], "unsharded_loss": c["want_loss"],
                   "loss_diff": loss_diff, "grad_norm": metrics["grad_norm"]}
            print("  lm_mesh " + json.dumps(row), flush=True)
            summary[arch] = {**{k: row[k] for k in ("prefill_ms", "decode_ms_a_step",
                                                    "train_step_ms", "loss_diff")},
                             "model_calls": {call: c["model"]["calls"]
                                             for call, c in row["collectives"].items()}}
    finally:
        mesh.close()
        print(f"  lm mesh ({label}) closed: rank exit codes {mesh.exit_codes}", flush=True)
    smoke.check(mesh.exit_codes == [0] * mesh.size, f"a rank did not exit cleanly: {mesh.exit_codes}")
    summary["mesh_seconds"] = time.perf_counter() - t0
    print(f"  lm_mesh_{label}_summary " + json.dumps(summary), flush=True)
    return summary


def flash_at_rank_shapes(smoke: Smoke, dev) -> None:
    """flash_attn at the head counts a rank of the 2 x 2 mesh gives it, its
    batch rows (2), bf16, against its plain version at the kernel's k
    blocks: llama3.2-3b (12 q and 4 kv heads) and moonshot-v1-16b-a3b (8
    and 8) at LM_PROMPT, D 128; the padded-head path's MHA-repeated heads (6
    of them padded to 8); zamba2-2.7b's shared attention (16 and 16, D 80,
    causal, its 2048-token prompt); whisper-small's encoder (6 and 6, D 64,
    non-causal over 1500 frames) and cross attention (its 224-token prompt
    over the 1500 frames); phi-3-vision-4.2b (16 and 16, D 96, causal over
    its 576 patches and 1472 tokens)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain, flash_attn, kernel_block_k,
    )

    gen = torch.Generator().manual_seed(0)
    b = LM_BATCH // MESH_LM_SHAPE[0]
    for name, hq, hkv, pad, sq, skv, d, causal in (
            ("llama rank", 12, 4, 0, LM_PROMPT, LM_PROMPT, 128, True),
            ("moonshot rank", 8, 8, 0, LM_PROMPT, LM_PROMPT, 128, True),
            ("padded heads", 4, 4, 1, LM_PROMPT, LM_PROMPT, 128, True),
            ("zamba2 rank", 16, 16, 0, 2048, 2048, 80, True),
            ("whisper encoder rank", 6, 6, 0, 1500, 1500, 64, False),
            ("whisper cross rank", 6, 6, 0, 224, 1500, 64, False),
            ("phi-3-vision rank", 16, 16, 0, 2048, 2048, 96, True)):
        q, k, v = (torch.randn((b * h, n, d), generator=gen).to(dev, torch.bfloat16)
                   for h, n in ((hq, sq), (hkv, skv), (hkv, skv)))
        if pad:  # the padded heads attend over zero K/V
            q[-b:], k[-b:], v[-b:] = 0, 0, 0
        before = flash_attn.launches
        got = flash_attn(q, k, v, causal=causal)
        smoke.check(flash_attn.launches == before + 1, "flash_attn did not launch")
        want = flash_attention_plain(q, k, v, causal=causal,
                                     block_k=kernel_block_k(torch.bfloat16, d))
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), **FLASH_BF16_TOL)
        print(f"  flash at a rank's heads ({name}: {hq} q, {hkv} kv, B {b}, Sq {sq}, Skv {skv}, "
              f"D {d}, {'causal' if causal else 'non-causal'}): max |diff| {err:.3g} against "
              "the plain version", flush=True)


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
