#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one NVIDIA
GPU, and hold every CUDA kernel of its main path against its plain
PyTorch version.

    python3 chip_smoke.py                     # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases (any failure exits non-zero before the last line):
  device   card name and power limit (nvidia-smi), torch/CUDA versions
  build    nvcc builds every kernel source in src/repro_torch/kernels/csrc
           (ptxas registers and spills per kernel function); counts the
           tensor-core instructions (HGMMA, HMMA) per kernel function in
           the attention and SSD libraries' SASS (cuobjdump) and fails
           unless every bf16 instance of the forward, dq and dk/dv kernels
           issues HGMMA and every bf16-q split-KV decode instance (dense
           and paged, over bf16 and over int8 K/V) HMMA, at hd 64, 80 and
           128 (float32 stays on the scalar blocks, and no scalar decode
           instance takes bf16 q), the int8 split instances with a 0-byte
           stack frame and 0 spills, and every SSD scan kernel function
           (C·Bᵀ and scan, f32 and bf16) issues HMMA (3xTF32 mma.sync)
           with 0 bytes spilled
  kernels  each kernel vs its plain version on the card, bf16 and f32,
           at Qwen2.5-7B shapes and at head_dim 80 (h2o-danube's 32 q /
           8 kv heads); the bf16-q paged and dense decode (split-KV, over
           bf16 and int8 K/V) also on 2048-slot rings split many ways
           (lengths 1 to 2048, a wrapped ring under a window of 1024,
           group 12, hd 80, int8 also hd 64, zamba2-1.2b's shared block
           at group 1 (32 q / 32 kv heads of hd 64), K1 also at
           dbrx-132b's group 6 (48 q / 8 kv heads of hd 128) and, with
           K2, at one tensor-parallel rank's heads (Qwen2.5-7B at tp 2
           and 4: 14 / 2 and 7 / 1, DBRX at tp 2: 24 / 4, Zamba2's shared
           block at tp 2: 16 / 16 of hd 64; both kernels
           also timed there, the serve shapes), the timed
           B16 x 2048; K1 and K6 also timed at zamba2's serve shape), each
           bitwise equal across two launches and its split plan printed;
           int8 with NaN scales and random values in every pool row past
           each length, bitwise equal to those rows zeroed; decode times
           also as device time from CUDA-graph replays, beside SDPA's,
           int8 beside bf16; the flash forward (K2) and
           the training forward
           (K5a) over S 16/100/128/256/2048, GQA groups 1/2/4/6/7/12, hd
           64/80/128, windows 0/32/64 and B up to 4 (the train shape),
           each bitwise equal across two launches; CUDA-event times
           (plain, kernel, kernel, plain) with achieved TFLOP/s at the
           serve path's shape and at one long shape; the training
           kernels (forward + lse, dq, dk/dv) over causal and windowed
           cases, GQA groups 1/2/4/7/12, S 16/100/128/300/520/1000/2048
           (ragged tiles, both dq block sizes), hd 64/80/128, timed
           at the train shape (B4 S2048 H16 KV8 hd128 bf16), at S=128
           and at a tp 2 rank's heads (B2 S2048 H8 KV4, phase
           train_mesh), and dq/dk/dv checked bitwise repeatable; K2 and
           K5a-c with a query offset (OFFSET_CASES: a sequence-parallel
           rank's s/tp rows at offset rank * s/tp against all s keys:
           Qwen3-1.7B's train shape over tp 2, B2 Sk 2048 Sq 1024 at
           offsets 0 and 1024, H16 KV8 hd128; a window of 64 crossing
           the rank boundary at hd 80, B2 S520 tp 2; B1 S200 tp 4 at hd
           64 window 48), bf16 and f32, each against its plain version
           at the same offset (TOL, GRAD_TOL), bitwise equal across two
           launches, the ranks' rows against the whole-sequence K2 / K5a
           (TOL), their dk / dv summed against the whole K5c (GRAD_TOL),
           every dk / dv row of a key no row of the rank sees exactly 0;
           timed at the train shape's two ranks (bound over the rank's
           band, SDPA with an explicit [Sq, Sk] mask); the SSD scan
           at the Mamba2-780M widths (nh 48, hd 64, ds 128), B 1/4 x S
           16/100/256/2048, and at the edges of its decomposition (S 1,
           63, 64, 65; B 3; nh 7; hd 64 with ds 64, hd 32, hd 48 with ds
           80; rows of no whole 16-byte pieces, hd 20 with ds 36 and hd
           33 with ds 37), each with and without an initial state and bitwise
           equal across two launches, timed at the serve shapes (B1 S96;
           B1 S32 from a state), at B4 S2048 and at a data rank's B2
           S2048 (Mamba2's and Zamba2's heads), eager and as device
           time from CUDA-graph replays; the SSD scan's backward (K4b,
           csrc/ssd_scan_bwd.cu: C·Bᵀ, the states, then the chunks in
           reverse in clusters) against the plain VJP over 32-row
           chunks at Mamba2's and Zamba2's heads, S 96/100/2048 and the
           edges (S 1, nh 7, odd hd and ds), with and without an initial
           state and a final-state cotangent, each gradient within 5e-5
           of its max |plain|, bitwise equal across two launches, HMMA in
           every kernel function, 0 spill; timed at B4 S2048 and at a
           data rank's B2 S2048 (eager and
           as device time from CUDA-graph replays) with its operations
           bound at the f32 CUDA-core peak and at the 3xTF32 rate, the
           bytes it moves (workspaces and partials included) and its
           clusters in flight
  anneal   the batched annealer's kernel (csrc/anneal.cu: one launch
           anneals every instance x chain) against its plain version on
           the same draws, on both scoring paths (incremental and full
           evaluate), over padded N 8/64/256/1024 x max_batch 1/32 x
           (instances, chains) (1, 8)/(4, 2)/(8, 8) (ragged instances, an
           empty one) x contended/loose SLOs under the default budget,
           and at the shapes of benchmarks/bench_overhead.py (N 64/128/256
           x 8 chains, 4 instances x 64 x 2 chains, max_batch 8) under
           iters=100 per level; then a case at each threshold of the
           kernel's launch plan and one past it (a warp per chain to N
           32, also at N 20, three rows at once there at max_batch 10, a
           row a pass at 11; a block at N 33, at N 100 with max_batch 64,
           a thread a position to N 256, two a thread at N 257; the
           request rows in shared memory at N 2048, in device memory at
           N 4096; the state in a global workspace at N 8192; an early
           exit inside a draw tile at iters 37), each printing its plan,
           and every plan taken at least once: best G bitwise or within
           1e-6, the same best schedule in >= 95% of chains, G within
           1e-5 of numpy evaluate of the kernel's schedule, every
           schedule a padded permutation in batches of at most
           max_batch, two launches bitwise equal, every kernel instance
           with 0 bytes spilled and a 0-byte stack frame; ms a call, us a
           proposal, the plain version's eager ms, the bound, and the
           per-proposal time at N 8
  serve    Qwen2.5-7B at its published config (28 layers, bf16, random
           seeded weights): latency-model fit, then run_policy under
           fcfs, slo-reanneal, slo-preempt + chunked:32, and a multi-turn
           fcfs run with prefix hits, on the paged engine; then the same
           three policy runs on the dense engine (paged=False); then
           h2o-danube-1.8b (24 layers, 32 q / 8 kv heads of head_dim 80,
           bf16, random seeded weights) under fcfs on the paged engine
  stream   the streaming serving loop (ServeLoop: decode rounds
           dispatched one ahead of the host on the loop's own CUDA
           stream, pow-2 dispatch widths) replaying STREAM_N requests
           of the in-repo ShareGPT and python-code length histograms
           (data/traces.py, lengths uncut) as Poisson arrivals at
           STREAM_RATE req/s, on a pool of STREAM_SLOTS sequences of
           STREAM_SEQ tokens, its models at STREAM_DEPTH of their
           published depth (published widths; the latency model fit at
           that depth): Qwen2.5-7B (4 of 28 layers) on the paged
           engine under fcfs (overlapped, then synchronous) and
           slo-preempt + chunked:32, a 2-engine EngineFleet sharing
           the params under least-loaded (one stream per loop, checked);
           then fcfs on the dense engine; then the batched annealer on
           the serving path, on the same trace and pools: a ServeLoop
           under slo-reanneal:jax as the trace arrives and with all of
           it waiting at t=0, and a 2-engine EngineFleet under
           route:annealed, each printing its anneal launches; then
           Mamba2-780M (6 of 48 layers) under fcfs.
           Every request completes with its whole output budget; per
           run: wall-clock TTFT and TBT p50/p90/p99, tok/s on the wall
           clock, attainment, G, dispatch widths, the share of
           overlapped ticks, and per loop the shares of the wall the
           host spent scheduling, prefilling, dispatching and waiting
           on readback
  ssm      Mamba2-780M at its published config (48 layers, d 1536, bf16,
           random seeded weights) on the dense engine: latency-model fit,
           then fcfs, slo-reanneal, slo-preempt + chunked:32; the SSD scan
           launches once per layer per prefill pass; then one prefill of
           a 2048-token prompt at full depth (B1), timed, with the SSD
           scan's launches and share of it (launches x device time)
  hybrid   Zamba2-1.2B at its published config (38 layers: 32 Mamba2
           blocks, one shared attention+MLP block used at six layers, d
           2048, 32 q / 32 kv heads of hd 64, d_state 64, bf16, random
           seeded weights): the parameter tree (one shared block, {} at
           the attention layers); at HYBRID_SERVE_LAYERS (the first 12,
           the shared block twice) latency-model fit on the paged engine,
           then fcfs, slo-reanneal:jax and slo-preempt + chunked:32 on the
           paged and on the dense engine (the SSD scan once per SSM layer
           per prefill pass); a timed full-depth B1 2048-token prefill;
           one ServeLoop run of the stream phase's trace on its pool
           (paged fcfs, at STREAM_DEPTH but down to the shared block's
           first use: the first 6 of the 38 layers, the last of them
           attention); then 4 layers (SSM, ATTN, SSM, ATTN)
           in float32,
           cuda vs cpu: both engines' tokens under fcfs and slo-preempt +
           chunked:32, prefill + 4 decode logits within 1e-4 of max
  moe      MoE and MLA: DeepSeek-V2-Lite at its published config (27
           layers, d 2048, MLA kv_lora 512, 64 experts top-6 + 2 shared,
           layer 0 dense at 10944, bf16, random seeded weights; every
           earlier phase's model freed first): at MOE_SERVE_LAYERS (7 of
           the 27) latency-model fit, then
           fcfs, slo-reanneal:jax and slo-preempt + chunked:32 (warned
           and served stalling: MLA has no chunked path) on the paged
           and on the dense engine; a timed full-depth B1 2048-token
           prefill (three grouped products per MoE layer, no other
           launch); one ServeLoop run of the stream phase's trace on its
           pool (paged fcfs, at STREAM_DEPTH: 3 of the 27 layers); a
           ServeLoop asked for chunked:16 must
           raise; one dispatch_decode round under sync debug mode
           "error"; then DBRX at its published width and 4 of its 40
           layers (48 q / 8 kv heads, 16 experts top-4, ff 10752): paged
           fcfs, slo-preempt + chunked:32 with the prefix cache and the
           multi-turn run, K1 and K2 launched; the grouped product
           (torch._grouped_mm) against a product per expert at both
           models' expert widths, bf16 and f32, routed rows and every
           row to one expert, timed at DeepSeek's decode shape; f32
           (DeepSeek 2 layers, DBRX 1) cuda vs cpu: tokens identical,
           logits within 1e-4 of max
  int8     Qwen2.5-7B: one 128-token prompt and 32 greedy decode
           steps through an int8 paged cache and an int8 dense cache,
           each against the same run on a bf16 cache, with the
           synchronized host time of a decode step on each cache
  train    Qwen3-1.7B at its published config (28 layers, bf16, random
           seeded weights): AdamW lr 3e-4, B=4, S=2048, per-layer remat;
           one warm-up step (attention-weight gradients checked finite
           and nonzero), then timed steps: loss, ms, tokens/s, peak
           memory; then TRAIN_ARCHS at published width with the JAX
           launcher's batches: Mamba2-780M and Zamba2-1.2B whole (K4 and
           K4b), MusicGen-medium whole on [B, S, 4] tokens, Qwen2-VL-7B at
           4 of 28 layers on float32 embeds, DeepSeek-V2-Lite at 4 of 27
           (its loss_and_grads under sync debug mode "error"): a warm-up
           step whose gradients are finite and nonzero wherever the loss
           reaches (every expert slice), 3 timed steps whose launches per
           step must equal what the layer count predicts
  parity   Qwen2.5-7B at full width, 2 layers, float32, TF32 off: the
           paged and the dense engine on cuda (kernels) and on cpu
           (plain versions) must emit identical tokens; int8 paged and
           dense decode logits, cuda vs cpu, are reported and bounded;
           the ServeLoop's tokens on both layouts, cuda vs cpu and
           overlapped vs synchronous, must be identical;
           one train step at 2 layers in float32, cuda vs cpu, of
           Qwen3-1.7B, Mamba2-780M, Zamba2-1.2B (SSM, ATTN) and
           MusicGen-medium: loss,
           every gradient and the updated params, bounded;
           Mamba2-780M at 2 layers in float32: the dense engine's tokens
           under fcfs and slo-preempt + chunked:32, and the logits of one
           prefill and 4 decode steps, bounded
  mesh     tensor-parallel paged serving (Engine(mesh=...)): two ranks,
           spawned processes on the one card over gloo (every model this
           process holds freed, then a tp 1 run of each reference model
           in this process), the serve phase's engine (4 slots x 256
           tokens) on sample_serve_workload(8), published widths:
           Qwen2.5-7B at MESH_QWEN_LAYERS (4) of its 28 layers (bf16)
           under fcfs and slo-reanneal:jax (the annealer on rank 0 while
           rank 1 follows) through run_policy, fcfs through a ServeLoop,
           and a 2-engine EngineFleet of mesh engines on the same two
           ranks (the second engine on the first's params) under
           route:annealed; DBRX at 4 of 40 layers on the MoE FFN's
           expert-parallel (8 experts a rank) and baseline (every expert
           on every rank) branches; Zamba2-1.2B at MESH_ZAMBA2_LAYERS
           (12) of its 38 layers (10 Mamba2 blocks whole on each rank,
           the shared block twice on 16 of its 32 heads a rank) under
           fcfs and slo-reanneal:jax stall and
           slo-preempt + chunked:32 (these two on an engine clock of
           MESH_STEP_S a step, in their tp 1 runs too, so that both
           decide alike, and slo-preempt must preempt); DeepSeek-V2-Lite at MESH_DEEPSEEK_LAYERS (4) of
           27 layers (MLA on 8 of its 16 heads a rank, the latent pages
           whole on each rank) on the expert-parallel branch (32 experts
           a rank); in float32 (TF32 off) Qwen at 2 layers, its fleet
           under least-loaded against one tp 1 ServeLoop, DBRX and
           DeepSeek at 2 layers on both branches, Zamba2 at 4 (SSM, ATTN,
           SSM, ATTN): tokens identical to tp 1 and first-step logits
           within 1e-4 of max |logit|; the grouped product on one rank's
           8 of DBRX's 16 experts, the other rank's pairs sorted past the
           last group (the group sizes sum to fewer than the rows) and
           selected away, against its plain version in bf16 and float32.
           Every request completes with its budget of in-vocabulary
           tokens; the two ranks' first-step logits are bit for bit
           alike in every run; on each rank the kernels' launches (K1,
           K2, K4, and the grouped product) equal the tp 1 run's where
           there is one, and the annealer runs on rank 0 alone; the
           latent and SSM-state bytes a rank equal tp 1's; bf16 runs
           print the share of tokens matching tp 1 and the first-step
           logit gap; per run tok/s, decode host ms a round, each rank's
           collectives (calls, seconds, share of the run) and peak
           memory, all labelled as two processes time-sharing one card;
           then an NCCL all_reduce over two ranks on the one card, which
           NCCL must refuse as a duplicate GPU (its error printed)
  train_mesh training under a (data, tp) mesh with FSDP
           (``train_step(..., ctx=)``): two ranks, spawned processes on
           the one card over gloo (every model this process holds freed
           first), published widths cut in depth (TRAIN_MESH_RUNS):
           bf16, one warm-up and TRAIN_MESH_STEPS timed steps each, at
           (data 2, tp 1) Zamba2-1.2B (B4 S2048, K4 / K4b
           on 2 rows a rank) and DeepSeek-V2-Lite at B2 S2048 (the 2-D
           expert-parallel branch), at (data 1, tp 2) Qwen3-1.7B,
           DeepSeek on the expert-parallel and the baseline branch, and
           MusicGen-medium, and Qwen3-1.7B at (1, 2) under
           attn_sharding="auto" (sequence-parallel attention: each
           rank's 1024 rows through K5a-c at its offset, every call's
           (q rows, keys, offset) checked; beside the "none" run's step
           ms, collectives and peak memory): per run and rank the losses (finite, alike
           on both ranks), step ms, collectives (calls, seconds, share),
           peak memory, the rank's param + moment bytes against the
           whole tree's, its bytes of the FSDP-sharded leaves (exactly
           1/data of what the tp split alone leaves it), K5a-c / K4 /
           K4b / grouped-product launches equal to what the layer count
           predicts times the steps, and every leaf and moment bit for
           bit alike on the ranks holding the same slice; then f32 at 2
           layers (Zamba2 4), B2 S64, TF32 off: one mesh step against
           the single-rank step on the card from the same params and
           global batch (Qwen3 (2, 1), (1, 2) and (1, 2) under "auto",
           Mamba2 (2, 1), Zamba2
           (1, 2), DeepSeek (1, 2) on both branches and (2, 1) on the
           2-D one, MusicGen (1, 2)): loss within 1e-5
           relative, each gathered gradient within 1e-4 of its leaf's
           max, the updated params within 2 lr and within 1e-6 on all
           but max(8, 1e-3 numel) of a leaf (the baseline branch's
           single-rank loss takes its load-balance loss as the mean over
           the tp slices of the sequence, as the reference does)
Each path (paged serve, dense serve, h2o-danube serve, the five
streaming paths, Mamba2 serve, the hybrid's paged, dense and stream
paths, DeepSeek's paged, dense and stream paths, DBRX's paged path,
int8, train and the five train paths of TRAIN_ARCHS) is driven with
the launch counts set to 0 just before it
and read just after (the mesh and train_mesh phases' runs on every
rank, counted in each rank's process); every kernel must launch on the path that runs it
(and the MoE paths' grouped product, a library call, is counted the
same way).  The line before the last is the kernels JSON; the last
line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "anneal", "serve", "stream", "ssm",
          "hybrid", "moe", "int8", "train", "parity", "mesh", "train_mesh")
PEAK_BYTES = 3.35e12                       # H100 SXM HBM3, bytes/s
PEAK_FLOPS = {"bfloat16": 989e12,          # dense tensor-core bf16
              "float32": 67e12}            # float32 outside tensor cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# gradient kernels, as a share of max |plain| over the tensor: both sides
# round the same f32 sums to the output dtype once, so bf16 may differ by
# a rounding flip (2^-8 of an element) where another summation order
# crosses a tie: 1e-2 allows ~2.5 such ulps at the largest element.  f32
# differs only by summation order (hd=128 dot products, up to 2048 keys
# per sum): 5e-5, 6x tighter than the JAX suite's 3e-4 against its
# oracle (tests/test_kernels.py:213)
GRAD_TOL = {"bfloat16": 1e-2, "float32": 5e-5}
# the SSD scan, element by element: a share of max |plain| over the
# tensor (magnitudes grow with s) capped at the JAX suite's own bound
# against its oracle (tests/test_kernels.py: atol = rtol = 2e-3 in f32,
# 5e-2 in bf16), plus a share of the element, so never looser than that
# bound.  f32: sums of up to 256 terms in another order (the kernel's
# 64-row chunks, the plain version's 256, and another FMA order), 5e-5 of
# max |plain|, as the gradient kernels' f32 bound.  bf16 y: both sides
# round the same f32 sum once, so a sum next to a rounding boundary may
# land one bf16 ulp apart, at most 2^-7 of the element.  The final state
# is float32 in both dtypes.  (share of max, cap, share of the element)
SSD_TOL = {"float32": (5e-5, 2e-3, 0.0), "bfloat16": (5e-5, 5e-2, 2 ** -7)}
# Qwen2.5-7B attention shapes and the serve engine's page geometry
H, KV, HD, PAGE = 28, 4, 128, 16
# zamba2-1.2b's shared attention block (configs/zamba2_1_2b.py): MHA,
# GQA group 1
ZAMBA2_HEADS = dict(h=32, kv=32, hd=64)
# dbrx-132b's attention (configs/dbrx_132b.py): GQA group 6, hd 128
DBRX_HEADS = dict(h=48, kv=8, hd=128)
# one tensor-parallel rank's attention heads (q, kv, hd): Qwen2.5-7B at
# tp 2 and 4, DBRX at tp 2, Zamba2's shared block at tp 2
MESH_HEADS = (("qwen2.5-7b tp2", 14, 2, 128), ("qwen2.5-7b tp4", 7, 1, 128),
              ("dbrx tp2", 24, 4, 128), ("zamba2 tp2", 16, 16, 64))
# Mamba2-780M's SSD widths (configs/mamba2_780m.py); the chunk whose
# flops the f32 CUDA-core bound counts (64 rows: PR 15's yardstick, kept
# so that it compares across kernel versions), and the kernel's own chunk
# (csrc/ssd_scan.cu kQ), whose flops the 3xTF32 bound and the achieved
# rate count
SSM_NH, SSM_HD, SSM_DS, SSD_Q, SSD_KQ = 48, 64, 128, 64, 32
# f32-accurate tensor-core products (3xTF32: three TF32 products each)
PEAK_3XTF32 = 495e12 / 3
KERNELS = {
    "decode_attention_paged": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention_paged.cu",
        "replaces": "src/repro/kernels/decode_attention_paged.py:124"},
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84"},
    "decode_attention_paged_q8": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention_paged.cu",
        "replaces": "src/repro/kernels/decode_attention_paged.py:171"},
    "decode_attention": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:64"},
    "decode_attention_q8": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention_q8.py:63"},
    "flash_attention_fwd_lse": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention_bwd.py:90"},
    "flash_attention_dq": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention_bwd.py:228"},
    "flash_attention_dkv": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention_bwd.py:250"},
    "ssd_scan": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:74"},
    # no Pallas kernel: the gradient of the SSD scan, which the JAX model
    # takes by autodiff of its jnp ssd_chunked
    "ssd_scan_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:74"},
    # not a Pallas kernel: the jitted anneal program (_run_chains /
    # _run_chains_multi), one launch per anneal here
    "anneal": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/anneal.cu",
        "replaces": "src/repro/core/annealing_jax.py:519"},
}
TRAIN_KERNELS = ("flash_attention_fwd_lse", "flash_attention_dq",
                 "flash_attention_dkv")
# the path each kernel must launch on (counts reset before, read after)
PATHS = {"serve_paged": ("decode_attention_paged", "flash_attention"),
         "serve_dense": ("flash_attention", "decode_attention"),
         "serve_hd80": ("decode_attention_paged", "flash_attention"),
         "serve_stream": ("decode_attention_paged", "flash_attention"),
         "serve_stream_dense": ("flash_attention", "decode_attention"),
         "serve_stream_ssm": ("ssd_scan",),
         "serve_stream_reanneal_jax": ("anneal", "decode_attention_paged",
                                       "flash_attention"),
         "serve_stream_route_annealed": ("anneal", "decode_attention_paged",
                                         "flash_attention"),
         "serve_ssm": ("ssd_scan",),
         "serve_hybrid_paged": ("decode_attention_paged", "flash_attention",
                                "ssd_scan"),
         "serve_hybrid_dense": ("decode_attention", "flash_attention",
                                "ssd_scan"),
         "serve_stream_hybrid": ("decode_attention_paged", "flash_attention",
                                 "ssd_scan"),
         # MLA runs no hand-written kernel (nor a Pallas one in the JAX
         # package); the MoE FFN's grouped product is PyTorch's own
         # (``ragged_dot``, counted beside the kernels, not one of them)
         "serve_mla_paged": ("ragged_dot", "anneal"),
         "serve_mla_dense": ("ragged_dot", "anneal"),
         "serve_stream_mla": ("ragged_dot",),
         "serve_moe_gqa": ("decode_attention_paged", "flash_attention",
                           "ragged_dot"),
         "int8": ("decode_attention_paged_q8", "decode_attention_q8"),
         "train": TRAIN_KERNELS,
         # the archs the JAX launcher trains beyond the dense decoders
         "train_ssm": ("ssd_scan", "ssd_scan_bwd"),
         "train_hybrid": ("ssd_scan", "ssd_scan_bwd") + TRAIN_KERNELS,
         "train_audio": TRAIN_KERNELS,
         "train_vlm": TRAIN_KERNELS,
         "train_moe": ("ragged_dot",),
         # each tensor-parallel rank, every run of the mesh phase: GQA,
         # the hybrid (a chunked run prefills through the chunk path, no
         # K2), MLA (no hand-written kernel, as in the JAX package)
         "serve_mesh": ("decode_attention_paged", "flash_attention"),
         "serve_mesh_hybrid": ("decode_attention_paged", "flash_attention",
                               "ssd_scan"),
         "serve_mesh_hybrid_chunked": ("decode_attention_paged",
                                       "ssd_scan"),
         "serve_mesh_mla": ("ragged_dot",),
         # each rank of the train_mesh phase's bf16 runs
         "train_mesh": TRAIN_KERNELS,
         "train_mesh_hybrid": ("ssd_scan", "ssd_scan_bwd") + TRAIN_KERNELS,
         "train_mesh_moe": ("ragged_dot",),
         "train_mesh_audio": TRAIN_KERNELS}
# the int8 KV library yardstick: no single PyTorch call dequantizes int8
# K/V with per-row scales inside attention
NO_LIBRARY = {
    "decode_attention_paged": "no single PyTorch call pages through a "
                              "block table",
    "decode_attention_paged_q8": "no single PyTorch call pages through a "
                                 "block table over int8 K/V",
    "decode_attention_q8": "no single PyTorch call attends over int8 K/V "
                           "with per-row scales",
    "ssd_scan": "no single PyTorch call computes the SSD chunk scan",
    "ssd_scan_bwd": "no PyTorch call computes the SSD chunk scan's "
                    "gradient",
    "anneal": "no PyTorch call anneals"}


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def tensor_core_counts():
    """Tensor-core instructions in the SASS of the attention and SSD
    libraries, by ``cuobjdump -sass``: HGMMA (wgmma) and HMMA (mma.sync)
    per kernel function (the SASS split at its ``Function :`` headers),
    by source, then by ``_build.kernel_label``."""
    import re
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    counts = {}
    for source in ("flash_attention", "flash_attention_bwd",
                   "decode_attention", "decode_attention_paged",
                   "ssd_scan", "ssd_scan_bwd"):
        sass = subprocess.run(
            [tool, "-sass", str(_build.library_path(source))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        counts[source] = {
            _build.kernel_label(fn.split(None, 1)[0]):
            {op: len(re.findall(rf"\b{op}\b", fn)) for op in ("HGMMA", "HMMA")}
            for fn in re.split(r"\bFunction : ", sass)[1:]}
    return counts


# the tensor-core function family behind each attention kernel's bf16
# instances, by (library, function name prefix up to the head_dim,
# instruction); every head_dim must have instances and each must issue
# the instruction (wgmma for the flash kernels, mma.sync for the split-KV
# decode over bf16 and over int8 K/V)
SPLIT_BF16, SPLIT_Q8 = ("decode_split_kernel<__nv_bfloat16, ",
                        "decode_split_kernel<int8_t, ")
TC_FAMILIES = {
    "flash_attention": ("flash_attention", "flash_fwd_tc_kernel<", "HGMMA"),
    "flash_attention_fwd_lse": ("flash_attention_bwd", "flash_fwd_tc_kernel<",
                                "HGMMA"),
    "flash_attention_dq": ("flash_attention_bwd", "flash_dq_tc_kernel<",
                           "HGMMA"),
    "flash_attention_dkv": ("flash_attention_bwd", "flash_dkv_tc_kernel<",
                            "HGMMA"),
    "decode_attention": ("decode_attention", SPLIT_BF16, "HMMA"),
    "decode_attention_q8": ("decode_attention", SPLIT_Q8, "HMMA"),
    "decode_attention_paged": ("decode_attention_paged", SPLIT_BF16, "HMMA"),
    "decode_attention_paged_q8": ("decode_attention_paged", SPLIT_Q8,
                                  "HMMA"),
    # the SSD backward's three kernel functions (C·Bᵀ, the states, the
    # chunks in reverse), each at ds 64 and 128: not per head_dim
    "ssd_scan_bwd": ("ssd_scan_bwd", ("ssd_cb_kernel<",
                                      "ssd_bwd_state_kernel<",
                                      "ssd_bwd_chunk_kernel<"), "HMMA")}
# the function instances each TC_FAMILIES entry that is not an attention
# kernel must have, every one, and nothing else, in its library
TC_INSTANCES = {"ssd_scan_bwd": {
    "ssd_cb_kernel<float>", "ssd_bwd_state_kernel<64>",
    "ssd_bwd_state_kernel<128>", "ssd_bwd_chunk_kernel<64>",
    "ssd_bwd_chunk_kernel<128>"}}
# the scalar flash blocks, which only the float32 parity path may reach
SCALAR_FAMILIES = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")
# the scalar decode block keeps float32-q instances only (over float32 or
# int8 K/V): bf16 q, over bf16 or int8 K/V, is the split block's
SCALAR_DECODE_BF16 = "decode_kernel<__nv_bfloat16,"


def check_tensor_cores(tc):
    """Fail unless every bf16 instance of each TC_FAMILIES entry (hd 64,
    80 and 128; the SSD backward's: TC_INSTANCES, every function of its
    library) has its tensor-core instruction in its SASS, every scalar
    flash instance is float32, no scalar decode instance takes bf16 q
    (over bf16 or int8 K/V) and ptxas reports a 0-byte stack frame and 0
    spills for every int8 split-KV decode instance.  -> {kernel:
    {function: counts}} for the kernels JSON."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    per_kernel = {}
    for name, (source, family, op) in TC_FAMILIES.items():
        fns = {fn: n for fn, n in tc[source].items()
               if fn.startswith(family)}
        if name in TC_INSTANCES:
            if set(tc[source]) != TC_INSTANCES[name] or not all(
                    n[op] for n in fns.values()):
                raise AssertionError(f"{name}: functions {tc[source]} "
                                     f"must be {TC_INSTANCES[name]}, each "
                                     f"with {op}")
            per_kernel[name] = fns
            continue
        hds = {int(fn[len(family):].split(",")[0].rstrip(">"))
               for fn in fns}
        if hds != set(HEAD_DIMS) or not all(n[op] for n in fns.values()):
            raise AssertionError(f"{name}: {family} instances {fns} need "
                                 f"{op} at every head_dim {HEAD_DIMS}")
        per_kernel[name] = fns
    for source, fns in tc.items():
        for fn in fns:
            if fn.startswith(SCALAR_FAMILIES) and "<float," not in fn:
                raise AssertionError(f"{source}: scalar instance {fn} is "
                                     "not float32")
            if fn.startswith(SCALAR_DECODE_BF16):
                raise AssertionError(f"{source}: scalar instance {fn} takes "
                                     "bf16 q")
    for source in ("decode_attention", "decode_attention_paged"):
        lines = [ln for ln in _build.compiler_log(source)
                 if ln.startswith(SPLIT_Q8)]
        bad = [ln for ln in lines if not re.search(
            r"\b0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
            r"loads", ln)]
        if len(lines) != len(HEAD_DIMS) or bad:
            raise AssertionError(f"{source}: int8 split-KV ptxas lines "
                                 f"{lines} (stack or spills: {bad})")
    return per_kernel


# the SSD scan's kernel functions: C·Bᵀ per chunk, and the scan
SSD_FAMILIES = ("ssd_cb_kernel", "ssd_scan_tc_kernel")


def check_ssd_build(tc):
    """Fail unless every kernel function of the SSD scan library is one
    of SSD_FAMILIES, each family has float32 and bf16 instances, every
    function issues HMMA (its 3xTF32 mma.sync) and ptxas spilled nothing
    in any (no stack frame either: no register array in local memory).
    -> ({function: counts}, ptxas lines) for the kernels JSON."""
    import re
    from repro_torch.kernels import _build
    fns = tc["ssd_scan"]
    ptxas = _build.compiler_log("ssd_scan")
    for family in SSD_FAMILIES:
        mine = [fn for fn in fns if fn.startswith(family + "<")]
        if not any("<float" in fn for fn in mine) \
                or not any("<__nv_bfloat16" in fn for fn in mine):
            raise AssertionError(f"ssd_scan: {family} needs float32 and "
                                 f"bf16 instances, has {mine}")
    bad = [fn for fn, n in fns.items()
           if not n["HMMA"] or not fn.startswith(SSD_FAMILIES)]
    if bad:
        raise AssertionError(f"ssd_scan: functions without HMMA: {bad}")
    spills = [ln for ln in ptxas if not re.search(
        r"\b0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        r"loads", ln)]
    if len(ptxas) != len(fns) or spills:
        raise AssertionError(f"ssd_scan: ptxas lines {ptxas} (spills: "
                             f"{spills})")
    return fns, ptxas


# ------------------------------------------------------------------ timing
def time_ms(fn, iters: int) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Device time per call: ``iters`` calls captured into one CUDA graph,
    replayed ``replays`` times between CUDA events, so no host dispatch
    lands on the clock (back-to-back eager calls of a small kernel time
    the host).  Capture fails on a call that syncs the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def alternate(plain, kernel, iters):
    """plain, kernel, kernel, plain on one card; means of each pair."""
    p1 = time_ms(plain, iters)
    k1 = time_ms(kernel, iters)
    k2 = time_ms(kernel, iters)
    p2 = time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------- kernel inputs
def decode_inputs(b, lengths, pages_per_seq, dtype, window, gen, n_blocks=None,
                  h=H, kv=KV, hd=HD):
    import torch
    n_blocks = n_blocks or 1 + b * pages_per_seq
    kw = dict(device="cuda", dtype=dtype)
    q = torch.randn((b, h, hd), generator=gen, **kw)
    k = torch.randn((n_blocks, PAGE, kv, hd), generator=gen, **kw)
    v = torch.randn((n_blocks, PAGE, kv, hd), generator=gen, **kw)
    # a shuffled, non-identity page assignment (page 0 stays the null page)
    perm = torch.randperm(n_blocks - 1, generator=gen, device="cuda")[
        :b * pages_per_seq] + 1
    bt = perm.reshape(b, pages_per_seq).to(torch.int32).contiguous()
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return (q, k, v, bt, ln), {"window": window}


def decode_bound(q, lengths, L, row_bytes, index_bytes, window, dtype_name):
    """Bound of one decode call: q read and out written once, each live
    K/V row (``row_bytes`` per token for K and V each) read once, the
    index tensors read once; 4 flops per q head x hd x attended key."""
    live = [min(int(n), L) for n in lengths.tolist()]
    attended = [min(x, window) if window else x for x in live]
    nbytes = (2 * q.numel() * q.element_size() + 2 * sum(live) * row_bytes
              + index_bytes)
    return bound(nbytes, 4 * q.shape[1] * q.shape[2] * sum(attended),
                 dtype_name)


def decode_cost(args, window, dtype_name):
    q, k, _, bt, ln = args
    return decode_bound(q, ln, bt.shape[1] * PAGE,
                        k.shape[2] * k.shape[3] * k.element_size(),
                        (bt.numel() + ln.numel()) * 4, window, dtype_name)


def decode_q8_inputs(b, lengths, pages_per_seq, dtype, window, gen,
                     n_blocks=None, **heads):
    """int8 pages quantized (by the port's quantize_kv) from float32
    pages; q in ``dtype``."""
    import torch
    from repro_torch.models.cache import quantize_kv
    (q, k, v, bt, ln), kw = decode_inputs(b, lengths, pages_per_seq,
                                          torch.float32, window, gen,
                                          n_blocks, **heads)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return (q.to(dtype), kq, ks, vq, vs, bt, ln), kw


def decode_q8_cost(args, window, dtype_name):
    """int8 values + one bf16 scale per (token, kv head), for K and V."""
    q, kq, _, _, _, bt, ln = args
    return decode_bound(q, ln, bt.shape[1] * PAGE,
                        kq.shape[2] * (kq.shape[3] + 2),
                        (bt.numel() + ln.numel()) * 4, window, dtype_name)


def dense_inputs(b, n_valid, L, dtype, gen, h=H, kv=KV, hd=HD):
    import torch
    kw = dict(device="cuda", dtype=dtype)
    q = torch.randn((b, h, hd), generator=gen, **kw)
    k = torch.randn((b, L, kv, hd), generator=gen, **kw)
    v = torch.randn((b, L, kv, hd), generator=gen, **kw)
    nv = torch.tensor(n_valid, dtype=torch.int32, device="cuda")
    return (q, k, v, nv), {}


def dense_q8_inputs(b, n_valid, L, dtype, gen, **heads):
    import torch
    from repro_torch.models.cache import quantize_kv
    (q, k, v, nv), _ = dense_inputs(b, n_valid, L, torch.float32, gen,
                                    **heads)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return (q.to(dtype), kq, ks, vq, vs, nv), {}


def dense_cost(args, window, dtype_name):
    q, k, _, nv = args
    return decode_bound(q, nv, k.shape[1],
                        k.shape[2] * k.shape[3] * k.element_size(),
                        nv.numel() * 4, window, dtype_name)


def dense_q8_cost(args, window, dtype_name):
    q, k, _, _, _, nv = args
    return decode_bound(q, nv, k.shape[1], k.shape[2] * (k.shape[3] + 2),
                        nv.numel() * 4, window, dtype_name)


def sdpa_decode_fn(args):
    """One PyTorch call computing dense GQA decode: SDPA with a boolean
    key mask (positions < n_valid) and enable_gqa, on the cache's
    [B, KV, L, hd] view.  The yardstick for decode_attention."""
    import torch
    import torch.nn.functional as F
    q, k, v, nv = args
    L = k.shape[1]
    qs = q[:, :, None, :]
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(L, device=q.device)[None, :]
            < nv.long()[:, None])[:, None, None, :]
    try:
        F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)
    except TypeError:                      # older torch: expand kv heads
        rep = q.shape[1] // k.shape[2]
        ke = ks.repeat_interleave(rep, dim=1)
        ve = vs.repeat_interleave(rep, dim=1)
        return lambda: F.scaled_dot_product_attention(qs, ke, ve,
                                                      attn_mask=mask)


# the decode kernels whose bf16-q instances run the split-KV tensor-core
# block (bf16 K/V: K1, K6; int8 K/V: K3, K7)
SPLIT_KERNELS = ("decode_attention_paged", "decode_attention",
                 "decode_attention_paged_q8", "decode_attention_q8")


def decode_split_plan(args, sms):
    """The (splits, split_len) the bf16-q wrapper of a paged (q, k, v,
    block_tables, lengths; int8: q, k, k_scale, v, v_scale,
    block_tables, lengths) or dense (q, k, v, n_valid; int8: q, k,
    k_scale, v, v_scale, n_valid) decode call picks on a card of ``sms``
    SMs."""
    from repro_torch.kernels import decode_attention_paged as dap
    q, k = args[0], args[1]
    per_sm = dap.BLOCKS_PER_SM_Q8 if len(args) in (6, 7) \
        else dap.BLOCKS_PER_SM
    if len(args) in (5, 7):
        return dap.split_plan(q.shape[0], k.shape[2], args[-2].shape[1]
                              * k.shape[1], page=k.shape[1], sms=sms,
                              blocks_per_sm=per_sm)
    return dap.split_plan(q.shape[0], k.shape[2], k.shape[1], sms=sms,
                          blocks_per_sm=per_sm)


def nan_past_length(args, paged):
    """int8 decode inputs (q, k, k_scale, v, v_scale, tables..., lengths)
    twice: every pool row past each sequence's length (and, paged, every
    page no table holds) with NaN scale bits and random int8 values, and
    the same rows zeroed.  A kernel that reads no such row gives the same
    bits on both."""
    import torch
    q, k, ks, v, vs = args[:5]
    ln = args[-1].long()
    if paged:
        bt = args[5].long()
        P, L = k.shape[1], bt.shape[1] * k.shape[1]
        dead = torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
        s = torch.arange(L, device=k.device)
        live = s[None, :] < ln[:, None]
        pages = bt[:, s // P]
        dead[pages[live], (s % P).expand_as(live)[live]] = False
    else:
        L = k.shape[1]
        dead = (torch.arange(L, device=k.device)[None, :]
                >= ln[:, None])
    out = []
    for fill in ("nan", "zero"):
        kk, vv, kss, vss = k.clone(), v.clone(), ks.clone(), vs.clone()
        for t in (kk, vv):
            t[dead] = torch.randint(-127, 128, t[dead].shape, dtype=t.dtype,
                                    device=t.device) if fill == "nan" else 0
        for t in (kss, vss):
            t[dead] = float("nan") if fill == "nan" else 0.
        out.append((q, kk, kss, vv, vss) + tuple(args[5:]))
    return out


def flash_inputs(b, s, dtype, window, gen):
    import torch
    kw = dict(device="cuda", dtype=dtype)
    q = torch.randn((b, s, H, HD), generator=gen, **kw)
    k = torch.randn((b, s, KV, HD), generator=gen, **kw)
    v = torch.randn((b, s, KV, HD), generator=gen, **kw)
    return (q, k, v), {"causal": True, "window": window}


def attn_flops(q, window, per_pair=4, q_offset=0):
    """``per_pair`` flops per q head x hd x attended (q, key) pair of
    causal attention over q [B,S,H,hd] (4 for a forward: QKᵀ and PV),
    its rows at key positions ``q_offset`` onwards (a sequence-parallel
    rank's rows: only the band of those rows is counted)."""
    b, s, h, hd = q.shape
    pairs = sum(min(i + 1, window) if window else i + 1
                for i in range(q_offset, q_offset + s))
    return float(per_pair) * b * h * hd * pairs


def flash_cost(args, window, dtype_name):
    q, k, v = args
    nbytes = 2 * q.numel() * q.element_size() + \
        2 * k.numel() * k.element_size()
    return bound(nbytes, attn_flops(q, window), dtype_name)


def sdpa_fn(args):
    """One PyTorch call computing causal GQA attention: the yardstick."""
    import torch.nn.functional as F
    q, k, v = (t.transpose(1, 2) for t in args)
    try:
        F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    except TypeError:                      # older torch: expand kv heads
        rep = q.shape[1] // k.shape[1]
        ke = k.repeat_interleave(rep, dim=1)
        ve = v.repeat_interleave(rep, dim=1)
        return lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                      is_causal=True)


def sdpa_bwd_fn(args, dout):
    """SDPA's backward through autograd (dq, dk, dv in one call): the
    yardstick for the dq and dk/dv kernels together."""
    import torch
    leaves = [t.detach().requires_grad_() for t in args]
    out = sdpa_fn(leaves)()
    dout = dout.transpose(1, 2)            # SDPA's [B, H, S, hd] layout
    return lambda: torch.autograd.grad(out, leaves, dout,
                                       retain_graph=True)


def flash_train_inputs(b, s, h, kv, hd, dtype, gen):
    """q, k, v and a seeded cotangent dout for the training kernels."""
    import torch
    kw = dict(device="cuda", dtype=dtype)
    return (torch.randn((b, s, h, hd), generator=gen, **kw),
            torch.randn((b, s, kv, hd), generator=gen, **kw),
            torch.randn((b, s, kv, hd), generator=gen, **kw),
            torch.randn((b, s, h, hd), generator=gen, **kw))


# flops per q head x hd x attended pair: the forward (QKᵀ, PV), dq (QKᵀ,
# dO·Vᵀ, dS·K) and dk/dv (QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q)
TRAIN_PER_PAIR = {"flash_attention_fwd_lse": 4, "flash_attention_dq": 6,
                  "flash_attention_dkv": 8}


def flash_train_cost(name, q, k, window, dtype_name, q_offset=0):
    """Bound of one training-kernel call: each input read once and each
    output written once (q-sized out/dout/dq, k-sized dk/dv, f32
    [B,H,Sq] lse and delta); TRAIN_PER_PAIR flops per q head x hd x
    attended pair of q's rows at ``q_offset``."""
    b, s, h, hd = q.shape
    qb, kb, rows = q.numel() * q.element_size(), \
        k.numel() * k.element_size(), b * h * s * 4
    nbytes = {"flash_attention_fwd_lse": 2 * qb + 2 * kb + rows,
              "flash_attention_dq": 3 * qb + 2 * kb + 2 * rows,
              "flash_attention_dkv": 2 * qb + 4 * kb + 2 * rows}[name]
    return bound(nbytes, attn_flops(q, window, TRAIN_PER_PAIR[name],
                                    q_offset), dtype_name)


# K2 and K5a cases (label, b, s, h, kv, hd, window): both q-tile sizes of
# the bf16 block (64 rows where 128-row tiles would not fill the SMs, else
# 128) with ragged last tiles; GQA groups 1/2/4/6/7/12 (starcoder2's 24
# over 2); hd 64/80/128; windows 0/32/64; up to the train shape
FLASH_CASES = [
    ("S16 g7 hd128", 1, 16, 28, 4, 128, 0),
    ("S16 g1 hd64", 1, 16, 4, 4, 64, 0),
    ("B4 S16 g12 hd64 (128-row tiles)", 4, 16, 48, 4, 64, 0),
    ("S100 g7 hd80", 1, 100, 14, 2, 80, 0),
    ("B2 S100 g2 hd128 w32", 2, 100, 8, 4, 128, 32),
    ("B4 S100 g12 hd128 w32 (128-row tiles)", 4, 100, 48, 4, 128, 32),
    ("S128 g7 hd128 (serve)", 1, 128, 28, 4, 128, 0),
    ("S128 g7 hd128 w32", 1, 128, 28, 4, 128, 32),
    ("S128 g12 hd128 w64", 1, 128, 24, 2, 128, 64),
    ("B2 S128 g4 hd80 w64", 2, 128, 32, 8, 80, 64),
    ("S2048 g7 hd128", 1, 2048, 28, 4, 128, 0),
    ("S2048 g2 hd64 w64", 1, 2048, 4, 2, 64, 64),
    ("S2048 g4 hd80 w32", 1, 2048, 32, 8, 80, 32),
    # dbrx-132b: GQA group 6 (48 q / 8 kv heads of hd 128)
    ("B2 S100 g6 hd128", 2, 100, 48, 8, 128, 0),
    ("S256 g6 hd128 (dbrx serve)", 1, 256, 48, 8, 128, 0),
    # one tensor-parallel rank's heads (phase mesh)
    ("S128 g7 hd128 H14 KV2 (qwen2.5-7b tp2 rank)", 1, 128, 14, 2, 128, 0),
    ("S100 g7 hd128 H7 KV1 (qwen2.5-7b tp4 rank)", 1, 100, 7, 1, 128, 0),
    ("S256 g6 hd128 H24 KV4 (dbrx tp2 rank)", 1, 256, 24, 4, 128, 0),
    ("B4 S2048 g2 hd128 (train)", 4, 2048, 16, 8, 128, 0),
]


def check_flash_forward(results):
    """K2 (forward only) and K5a (forward + lse) against their shared
    plain version on FLASH_CASES in bf16 and f32 (TOL on out and lse),
    and each bitwise equal across two launches.  Sets K2's result row;
    returns K5a's worst errors by dtype."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    worst = {n: dict.fromkeys(dtypes, 0.0)
             for n in ("flash_attention", "flash_attention_fwd_lse")}
    for label, b, s, h, kv, hd, window in FLASH_CASES:
        for dn, dt in dtypes.items():
            q, k, v, _ = flash_train_inputs(b, s, h, kv, hd, dt, gen)
            kw = {"causal": True, "window": window}
            runs = {"flash_attention":
                    [(fa.flash_attention_cuda(q, k, v, **kw),)
                     for _ in range(2)],
                    "flash_attention_fwd_lse":
                    [fb.flash_attention_fwd_lse_cuda(q, k, v, **kw)
                     for _ in range(2)]}
            want = fa.flash_attention_fwd_lse_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            for name, (first, second) in runs.items():
                same = all(torch.equal(x, y) for x, y in zip(first, second))
                err = 0.0
                ok = same
                for got, ref in zip(first, want):
                    e = (got.float() - ref.float()).abs()
                    err = max(err, float(e.max()))
                    ok = ok and bool((e <= TOL[dn] + TOL[dn]
                                      * ref.float().abs()).all())
                worst[name][dn] = max(worst[name][dn], err)
                log(f"  {name:<24} {label:<38} {dn:<8} max_abs_err="
                    f"{err:.3e} tol={TOL[dn]:g} bitwise_repeat={same} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} {label} {dn} disagrees "
                                         "or is not repeatable")
    results["flash_attention"] = {
        "name": "flash_attention", **KERNELS["flash_attention"],
        "max_abs_err": max(worst["flash_attention"].values()),
        "max_err": worst["flash_attention"], "tol": TOL,
        "bitwise_repeatable": True, "cases": len(FLASH_CASES)}
    return worst["flash_attention_fwd_lse"]


def check_train_kernels(results, fwd_worst):
    """The training kernels against their plain versions: out and lse of
    the forward (TOL), dq/dk/dv of the backward from the same residuals
    (GRAD_TOL relative to max |plain|), on the cases below and at the
    shapes the train phase gives them (Qwen3's B4 S2048 H16 KV8 hd128,
    Qwen2-VL's, MusicGen's and Zamba2's), in bf16 and f32; then
    dq/dk/dv bitwise repeatable, and times at the train shape and at
    S=128.  ``fwd_worst``: K5a's worst errors on FLASH_CASES."""
    import torch
    from repro_torch.kernels import flash_attention_bwd as fb
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    cases = [  # label, b, s, h, kv, hd, window
        ("S16 rep1 hd64 causal", 1, 16, 4, 4, 64, 0),
        ("S128 rep2 hd128 causal", 2, 128, 16, 8, 128, 0),
        ("S128 rep7 hd128 window32", 1, 128, 14, 2, 128, 32),
        ("S128 rep7 hd64 window48", 1, 128, 7, 1, 64, 48),
        ("S2048 rep2 hd128 causal", 1, 2048, 16, 8, 128, 0),
        ("S2048 rep2 hd64 window256", 1, 2048, 4, 2, 64, 256),
        ("B4 S2048 rep2 hd128 causal (train)", 4, 2048, 16, 8, 128, 0),
        ("B2 S128 rep4 hd80 window64", 2, 128, 32, 8, 80, 64),
        ("S2048 rep4 hd80 causal", 1, 2048, 32, 8, 80, 0),
        # ragged S, and both block sizes of the bf16 dq kernel (128 q
        # rows where that grid fills the SMs, else 64)
        ("S100 rep2 hd128 causal (dq 64-row)", 1, 100, 8, 4, 128, 0),
        ("B8 S100 rep12 hd64 causal (dq 128-row)", 8, 100, 24, 2, 64, 0),
        ("B2 S300 rep4 hd80 window40 (dq 128-row)", 2, 300, 32, 8, 80, 40),
        ("B5 S1000 rep2 hd64 window100", 5, 1000, 8, 4, 64, 100),
        ("B4 S520 rep2 hd80 causal", 4, 520, 16, 8, 80, 0),
        # the train phase's other shapes: Qwen2-VL (float32 under its
        # float32 embeds), MusicGen and Zamba2's shared block (MHA, bf16)
        ("B1 S2048 rep7 hd128 causal (qwen2-vl train)",
         1, 2048, 28, 4, 128, 0),
        ("B4 S2048 rep1 hd64 causal (musicgen train)",
         4, 2048, 24, 24, 64, 0),
        ("B4 S2048 rep1 hd64 causal (zamba2 train)",
         4, 2048, 32, 32, 64, 0),
        # the train_mesh phase: Qwen3-1.7B's heads on one rank at tp 2
        # (8 q / 4 kv), a data rank's rows (B2 of B4) at data 2
        ("B2 S2048 rep2 hd128 causal (qwen3 tp2 rank)",
         2, 2048, 8, 4, 128, 0),
        ("B2 S2048 rep2 hd128 causal (qwen3 data rank)",
         2, 2048, 16, 8, 128, 0),
    ]
    worst = {n: dict.fromkeys(dtypes, 0.0) for n in TRAIN_KERNELS}
    worst[TRAIN_KERNELS[0]] = dict(fwd_worst)
    for label, b, s, h, kv, hd, window in cases:
        for dn, dt in dtypes.items():
            q, k, v, do = flash_train_inputs(b, s, h, kv, hd, dt, gen)
            kw = {"causal": True, "window": window}
            out, lse = fb.flash_attention_fwd_lse_cuda(q, k, v, **kw)
            out_p, lse_p = fb.flash_attention_fwd_lse_plain(q, k, v, **kw)
            delta = fb.attention_delta(out_p, do)
            dq = fb.flash_attention_dq_cuda(q, k, v, do, lse_p, delta, **kw)
            dk, dv = fb.flash_attention_dkv_cuda(q, k, v, do, lse_p, delta,
                                                 **kw)
            want = fb.flash_attention_bwd_plain(q, k, v, out_p, lse_p, do,
                                                **kw)
            torch.cuda.synchronize()
            checks = []
            for got, ref in ((out, out_p), (lse, lse_p)):
                err = (got.float() - ref.float()).abs()
                checks.append(("flash_attention_fwd_lse", float(err.max()),
                               bool((err <= TOL[dn] + TOL[dn]
                                     * ref.float().abs()).all()),
                               TOL[dn]))
            for name, got, ref in (("flash_attention_dq", dq, want[0]),
                                   ("flash_attention_dkv", dk, want[1]),
                                   ("flash_attention_dkv", dv, want[2])):
                err = float((got.float() - ref.float()).abs().max())
                scale = float(ref.float().abs().max())
                checks.append((name, err, err <= GRAD_TOL[dn] * scale,
                               GRAD_TOL[dn] * scale))
            for name, err, ok, lim in checks:
                worst[name][dn] = max(worst[name][dn], err)
                log(f"  {name:<24} {label:<40} {dn:<8} max_abs_err="
                    f"{err:.3e} limit={lim:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} {label} {dn} disagrees")
    for name in TRAIN_KERNELS:
        results[name] = {"name": name, **KERNELS[name],
                         "max_abs_err": max(worst[name].values()),
                         "max_err": worst[name],
                         "tol": TOL if name == TRAIN_KERNELS[0] else
                         {"relative_to_max_plain": GRAD_TOL}}

    bf = torch.bfloat16
    shapes = (("train", "B4 S2048 H16 KV8 hd128 causal bf16", 4, 2048, 16,
               8, 3),
              ("S128", "B4 S128 H16 KV8 hd128 causal bf16", 4, 128, 16, 8,
               50),
              ("train_mesh_tp2", "B2 S2048 H8 KV4 hd128 causal bf16 "
               "(qwen3 tp2 rank)", 2, 2048, 8, 4, 3))
    for key, shape, b, s, h, kv, iters in shapes:
        q, k, v, do = flash_train_inputs(b, s, h, kv, 128, bf, gen)
        kw = {"causal": True, "window": 0}
        out, lse = fb.flash_attention_fwd_lse_cuda(q, k, v, **kw)
        delta = fb.attention_delta(out, do)
        if key == "train":
            # no atomics: the same inputs give the same bits
            a = (fb.flash_attention_dq_cuda(q, k, v, do, lse, delta, **kw),
                 *fb.flash_attention_dkv_cuda(q, k, v, do, lse, delta, **kw))
            b2 = (fb.flash_attention_dq_cuda(q, k, v, do, lse, delta, **kw),
                  *fb.flash_attention_dkv_cuda(q, k, v, do, lse, delta,
                                               **kw))
            same = all(torch.equal(x, y) for x, y in zip(a, b2))
            log(f"  dq/dk/dv bitwise equal across two runs at {shape}: "
                f"{same}")
            if not same:
                raise AssertionError("dq/dk/dv differ between two runs")
            for name in TRAIN_KERNELS[1:]:
                results[name]["bitwise_repeatable"] = same
        fwd_p = lambda: fb.flash_attention_fwd_lse_plain(q, k, v, **kw)
        bwd_p = lambda: fb.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                     **kw)
        runs = {
            "flash_attention_fwd_lse": (
                fwd_p, lambda: fb.flash_attention_fwd_lse_cuda(q, k, v, **kw),
                sdpa_fn((q, k, v))),
            "flash_attention_dq": (
                bwd_p, lambda: fb.flash_attention_dq_cuda(
                    q, k, v, do, lse, delta, **kw), None),
            "flash_attention_dkv": (
                bwd_p, lambda: fb.flash_attention_dkv_cuda(
                    q, k, v, do, lse, delta, **kw), None)}
        lib_bwd = time_ms(sdpa_bwd_fn((q, k, v), do), iters)
        pair = time_ms(lambda: fb.flash_attention_bwd_cuda(
            q, k, v, out, lse, do, **kw), iters)
        for name, (plain, kernel, lib) in runs.items():
            k_ms, p_ms = alternate(plain, kernel, iters)
            b_ms, b_by = flash_train_cost(name, q, k, 0, "bfloat16")
            r = {"shape": shape, "ms": k_ms, "plain_ms": p_ms,
                 "bound_ms": b_ms, "bound_by": b_by,
                 "achieved_tflops": attn_flops(q, 0, TRAIN_PER_PAIR[name])
                 / k_ms / 1e9,
                 "library_ms": time_ms(lib, iters) if lib else lib_bwd}
            if name != TRAIN_KERNELS[0]:
                r.update(plain_covers="dq, dk and dv together",
                         library_covers="dq, dk and dv together (SDPA "
                                        "backward through autograd)",
                         pair_ms=pair)
            if key == "train":
                results[name].update(r)
            else:
                results[name][key] = r
            log(f"  {name}: kernel {k_ms:.4f} ms "
                f"({r['achieved_tflops']:.1f} TFLOP/s), plain {p_ms:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}), library "
                f"{r['library_ms']:.4f} ms at {shape}"
                + (f"; delta+dq+dkv {pair:.4f} ms" if "pair_ms" in r
                   else ""))


# K2 / K5a-c with a query offset (attn_sharding="auto": each tp rank's
# s/tp query rows at offset rank * s/tp over all s keys): (label, b, s,
# h, kv, hd, window, tp).  Qwen3-1.7B's train shape split over tp 2 (the
# train_mesh phase's "auto" run; timed), a window crossing the rank
# boundary at hd 80 (keys before rank 1's window get no q tile), and a
# ragged tp 4 split (50-row ranks, less than one q tile)
# calls each timing of the offset instances averages over
OFFSET_ITERS = 20
OFFSET_CASES = [
    ("B2 S2048 H16 KV8 hd128 causal tp2 (qwen3 auto rank)",
     2, 2048, 16, 8, 128, 0, 2),
    ("B2 S520 H32 KV8 hd80 window64 tp2", 2, 520, 32, 8, 80, 64, 2),
    ("B1 S200 H8 KV4 hd64 window48 tp4", 1, 200, 8, 4, 64, 48, 4),
]


def seen_keys(s, off, n, window):
    """[s] bool: the keys that some query row at positions off .. off+n-1
    attends (causal, optional window)."""
    import torch
    kp = torch.arange(s, device="cuda")
    seen = kp <= off + n - 1
    if window:
        seen &= kp > off - window
    return seen


def sdpa_masked_fn(q, k, v, off, window):
    """One PyTorch call computing a rank's rows of attention: SDPA with
    an explicit [Sq, Sk] boolean mask (``is_causal`` aligns the diagonal
    top-left, so it cannot place rows at an offset)."""
    import torch
    import torch.nn.functional as F
    sq, sk = q.shape[1], k.shape[1]
    qp = off + torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = kp <= qp
    if window:
        mask &= kp > qp - window
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    except TypeError:                      # older torch: expand kv heads
        rep = qt.shape[1] // kt.shape[1]
        ke, ve = (t.repeat_interleave(rep, dim=1) for t in (kt, vt))
        return lambda: F.scaled_dot_product_attention(qt, ke, ve,
                                                      attn_mask=mask)


def sdpa_masked_bwd_fn(q, k, v, off, window, dout):
    """SDPA's backward with the explicit mask through autograd (dq, dk,
    dv in one call)."""
    import torch
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = sdpa_masked_fn(*leaves, off, window)()
    dout = dout.transpose(1, 2)
    return lambda: torch.autograd.grad(out, leaves, dout,
                                       retain_graph=True)


def check_flash_offset(results):
    """K2, K5a, K5b and K5c with a query offset (OFFSET_CASES), bf16 and
    f32: each tp rank's rows against the plain version at the same
    offset (TOL on out and lse, GRAD_TOL of max |plain| on dq, dk, dv),
    bitwise equal across two launches; the ranks' rows of K2 and K5a
    concatenated against the whole-sequence kernel (TOL), their dk / dv
    summed in float32 against the whole-sequence K5c (GRAD_TOL of max
    |whole|), and every dk / dv row of a key no row of the rank sees
    exactly 0.  The offset is a run-time argument of the same kernel
    instances, whose HGMMA and spills the build phase checks.  Then
    times of each offset instance at the first case's two ranks
    (plain, kernel, kernel, plain), the bound over the band of the
    rank's rows, and SDPA with an explicit [Sq, Sk] mask."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    names = ("flash_attention",) + TRAIN_KERNELS
    worst = {n: dict.fromkeys(dtypes, 0.0) for n in names}

    def hold(name, label, what, err, lim, ok):
        worst[name][dn] = max(worst[name][dn], err)
        log(f"  {name:<24} offset {label:<44} {dn:<8} {what:<24} "
            f"max_abs_err={err:.3e} limit={lim:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} offset {label} {dn} {what}")

    def near(got, ref):
        e = (got.float() - ref.float()).abs()
        return float(e.max()), bool((e <= TOL[dn] + TOL[dn]
                                     * ref.float().abs()).all())

    for label, b, s, h, kv, hd, window, tp in OFFSET_CASES:
        n = s // tp
        for dn, dt in dtypes.items():
            q, k, v, do = flash_train_inputs(b, s, h, kv, hd, dt, gen)
            kw = {"causal": True, "window": window}
            whole2 = fa.flash_attention_cuda(q, k, v, **kw)
            whole_o, whole_l = fb.flash_attention_fwd_lse_cuda(q, k, v, **kw)
            wo_p, wl_p = fb.flash_attention_fwd_lse_plain(q, k, v, **kw)
            whole_dk, whole_dv = fb.flash_attention_dkv_cuda(
                q, k, v, do, wl_p, fb.attention_delta(wo_p, do), **kw)
            rows2, rows_o, rows_l = [], [], []
            sum_dk = torch.zeros_like(k, dtype=torch.float32)
            sum_dv = torch.zeros_like(v, dtype=torch.float32)
            for r in range(tp):
                off = r * n
                tag = f"{label} rank {r} (offset {off})"
                okw = dict(kw, q_offset=off)
                qr = q[:, off:off + n].contiguous()
                dor = do[:, off:off + n].contiguous()
                o2 = [fa.flash_attention_cuda(qr, k, v, **okw)
                      for _ in range(2)]
                fw = [fb.flash_attention_fwd_lse_cuda(qr, k, v, **okw)
                      for _ in range(2)]
                o_p, l_p = fa.flash_attention_fwd_lse_plain(qr, k, v, **okw)
                delta = fb.attention_delta(o_p, dor)
                dq = [fb.flash_attention_dq_cuda(qr, k, v, dor, l_p, delta,
                                                 **okw) for _ in range(2)]
                dkv = [fb.flash_attention_dkv_cuda(qr, k, v, dor, l_p, delta,
                                                   **okw) for _ in range(2)]
                want = fb.flash_attention_bwd_plain(qr, k, v, o_p, l_p, dor,
                                                    **okw)
                torch.cuda.synchronize()
                same = {"flash_attention": torch.equal(*o2),
                        "flash_attention_fwd_lse": all(
                            torch.equal(x, y) for x, y in zip(*fw)),
                        "flash_attention_dq": torch.equal(*dq),
                        "flash_attention_dkv": all(
                            torch.equal(x, y) for x, y in zip(*dkv))}
                if not all(same.values()):
                    raise AssertionError(f"offset {tag} {dn}: not bitwise "
                                         f"repeatable: {same}")
                err, ok = near(o2[0], o_p)
                hold("flash_attention", tag, "out vs plain", err, TOL[dn], ok)
                for what, got, ref in (("out vs plain", fw[0][0], o_p),
                                       ("lse vs plain", fw[0][1], l_p)):
                    err, ok = near(got, ref)
                    hold("flash_attention_fwd_lse", tag, what, err, TOL[dn],
                         ok)
                for name, what, got, ref in (
                        ("flash_attention_dq", "dq vs plain", dq[0], want[0]),
                        ("flash_attention_dkv", "dk vs plain", dkv[0][0],
                         want[1]),
                        ("flash_attention_dkv", "dv vs plain", dkv[0][1],
                         want[2])):
                    err = float((got.float() - ref.float()).abs().max())
                    lim = GRAD_TOL[dn] * float(ref.float().abs().max())
                    hold(name, tag, what, err, lim, err <= lim)
                unseen = ~seen_keys(s, off, n, window)
                nz = int(torch.count_nonzero(dkv[0][0][:, unseen])) + \
                    int(torch.count_nonzero(dkv[0][1][:, unseen]))
                log(f"  flash_attention_dkv      offset {tag} {dn}: "
                    f"{int(unseen.sum())} key rows no query row sees, "
                    f"{nz} nonzero elements of dk / dv there "
                    f"{'ok' if nz == 0 else 'FAIL'}")
                if nz:
                    raise AssertionError(f"offset {tag} {dn}: dk / dv rows "
                                         "of unseen keys are not 0")
                rows2.append(o2[0])
                rows_o.append(fw[0][0])
                rows_l.append(fw[0][1])
                sum_dk += dkv[0][0].float()
                sum_dv += dkv[0][1].float()
            tag = f"{label} ranks joined"
            err, ok = near(torch.cat(rows2, 1), whole2)
            hold("flash_attention", tag, "rows vs whole", err, TOL[dn], ok)
            err, ok = near(torch.cat(rows_o, 1), whole_o)
            hold("flash_attention_fwd_lse", tag, "rows vs whole", err,
                 TOL[dn], ok)
            err, ok = near(torch.cat(rows_l, 2), whole_l)
            hold("flash_attention_fwd_lse", tag, "lse rows vs whole", err,
                 TOL[dn], ok)
            for what, got, ref in (("dk sum vs whole", sum_dk, whole_dk),
                                   ("dv sum vs whole", sum_dv, whole_dv)):
                err = float((got - ref.float()).abs().max())
                lim = GRAD_TOL[dn] * float(ref.float().abs().max())
                hold("flash_attention_dkv", tag, what, err, lim, err <= lim)
    for name in names:
        results[name]["offset"] = {
            "cases": [c[0] for c in OFFSET_CASES], "max_err": worst[name],
            "bitwise_repeatable": True, "unseen_key_rows_zero": True}

    # times: each rank of the first case in bf16, the rank's band only
    label, b, s, h, kv, hd, window, tp = OFFSET_CASES[0]
    n = s // tp
    bf = torch.bfloat16
    q, k, v, do = flash_train_inputs(b, s, h, kv, hd, bf, gen)
    for r in range(tp):
        off = r * n
        okw = {"causal": True, "window": window, "q_offset": off}
        qr = q[:, off:off + n].contiguous()
        dor = do[:, off:off + n].contiguous()
        out, lse = fb.flash_attention_fwd_lse_cuda(qr, k, v, **okw)
        delta = fb.attention_delta(out, dor)
        lib_fwd = sdpa_masked_fn(qr, k, v, off, window)
        lib_bwd = time_ms(sdpa_masked_bwd_fn(qr, k, v, off, window, dor),
                          OFFSET_ITERS)
        shape = (f"B{b} Sq{n} Sk{s} offset {off} H{h} KV{kv} hd{hd} causal "
                 "bf16 (qwen3 tp2 rank under attn_sharding=auto)")
        fwd_p = lambda: fa.flash_attention_fwd_lse_plain(qr, k, v, **okw)
        bwd_p = lambda: fb.flash_attention_bwd_plain(qr, k, v, out, lse,
                                                     dor, **okw)
        runs = {
            "flash_attention": (
                fwd_p, lambda: fa.flash_attention_cuda(qr, k, v, **okw),
                lib_fwd),
            "flash_attention_fwd_lse": (
                fwd_p, lambda: fb.flash_attention_fwd_lse_cuda(qr, k, v,
                                                               **okw),
                lib_fwd),
            "flash_attention_dq": (
                bwd_p, lambda: fb.flash_attention_dq_cuda(
                    qr, k, v, dor, lse, delta, **okw), None),
            "flash_attention_dkv": (
                bwd_p, lambda: fb.flash_attention_dkv_cuda(
                    qr, k, v, dor, lse, delta, **okw), None)}
        for name, (plain, kernel, lib) in runs.items():
            k_ms, p_ms = alternate(plain, kernel, OFFSET_ITERS)
            per = 4 if name == "flash_attention" else TRAIN_PER_PAIR[name]
            cost = "flash_attention_fwd_lse" if name == "flash_attention" \
                else name
            b_ms, b_by = flash_train_cost(cost, qr, k, window, "bfloat16",
                                          off)
            if name == "flash_attention":   # no lse written
                b_ms, b_by = bound(2 * qr.numel() * 2 + 2 * k.numel() * 2,
                                   attn_flops(qr, window, 4, off),
                                   "bfloat16")
            row = {"shape": shape, "ms": k_ms, "plain_ms": p_ms,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "achieved_tflops": attn_flops(qr, window, per, off)
                   / k_ms / 1e9,
                   "library_ms": time_ms(lib, OFFSET_ITERS) if lib
                   else lib_bwd}
            if name in TRAIN_KERNELS[1:]:
                row.update(plain_covers="dq, dk and dv together",
                           library_covers="dq, dk and dv together (SDPA "
                                          "with the mask, backward through "
                                          "autograd)")
            results[name]["offset"][f"rank {r}"] = row
            log(f"  {name} offset rank {r}: kernel {k_ms:.4f} ms "
                f"({row['achieved_tflops']:.1f} TFLOP/s over the rank's "
                f"band), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"library {row['library_ms']:.4f} ms at {shape}")


def ssd_inputs(b, s, dtype, with_state, gen, nh=SSM_NH, hd=SSM_HD,
               ds=SSM_DS):
    """The scan's inputs (by default at the Mamba2-780M widths): x, B, C
    normal of std 0.5 in ``dtype``, dt = softplus(N(0,1) - 1) and A =
    -(1..16) (the model's A_log init) in float32, a N(0,1) initial state
    or None."""
    import torch
    import torch.nn.functional as F
    kw = dict(device="cuda", generator=gen)
    x = (0.5 * torch.randn((b, s, nh, hd), **kw)).to(dtype)
    dt = F.softplus(torch.randn((b, s, nh), **kw) - 1.0)
    A = -torch.linspace(1.0, 16.0, nh, device="cuda")
    B = (0.5 * torch.randn((b, s, ds), **kw)).to(dtype)
    C = (0.5 * torch.randn((b, s, ds), **kw)).to(dtype)
    st = torch.randn((b, nh, hd, ds), **kw) if with_state else None
    return x, dt, A, B, C, st


def ssd_flops(b, s, nh, hd, ds, q):
    """The flops of the chunked SSD over chunks of ``q`` rows: per batch
    row and chunk of n rows, 2n²·ds for C·Bᵀ, once (B and C are shared
    by every head), and per head 2n²·hd (with x·dt) + 2n·hd·ds (the
    inter-chunk term) + 2n·hd·ds (the state update)."""
    rows = [min(q, s - r) for r in range(0, s, q)]
    return b * sum(2 * n * n * ds + nh * (2 * n * n * hd + 4 * n * hd * ds)
                   for n in rows)


def ssd_cost(x, B, st, dtype_name):
    """Bounds of one scan: x, dt, A, B, C (and the initial state) read
    once, y and the final state written once.  -> ((bound ms, bound_by)
    at the f32 CUDA-core peak over 64-row chunks, PR 15's yardstick),
    ((bound ms, bound_by) at the rate of the f32-accurate 3xTF32
    tensor-core products the kernel issues, 495/3 TFLOP/s, over the
    kernel's own 32-row chunks), and those chunks' flops."""
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    el = x.element_size()
    nbytes = (2 * x.numel() * el + b * s * nh * 4 + nh * 4
              + 2 * b * s * ds * el
              + b * nh * hd * ds * 4 * (1 if st is None else 2))
    flops = ssd_flops(b, s, nh, hd, ds, SSD_KQ)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_tc = flops / PEAK_3XTF32 * 1e3
    tc = (t_bytes, "bytes") if t_bytes >= t_tc else (t_tc, "operations")
    return (bound(nbytes, ssd_flops(b, s, nh, hd, ds, SSD_Q), dtype_name),
            tc, flops)


# (label, b, s, nh, hd, ds): the model's widths over batch and length,
# then the edges of the kernel's decomposition: one row, a 32-row chunk
# boundary on either side of 64, a batch of 3, 7 heads (fewer blocks than
# SMs), Zamba2-1.2B's hd 64 / ds 64 (configs/zamba2_1_2b.py), hd 32,
# widths below the tiles (hd 48: a masked column tile; ds 80), and rows
# that are no whole number of 16-byte pieces, which the kernel stages by
# plain loads (hd 20 / ds 36 in bf16; hd 33 / ds 37 in both dtypes)
SSD_CASES = [(f"B{b} S{s}", b, s, SSM_NH, SSM_HD, SSM_DS)
             for b in (1, 4) for s in (16, 100, 256, 2048)] + [
    ("B1 S1", 1, 1, SSM_NH, SSM_HD, SSM_DS),
    ("B1 S63", 1, 63, SSM_NH, SSM_HD, SSM_DS),
    ("B1 S64", 1, 64, SSM_NH, SSM_HD, SSM_DS),
    ("B1 S65", 1, 65, SSM_NH, SSM_HD, SSM_DS),
    ("B3 S100", 3, 100, SSM_NH, SSM_HD, SSM_DS),
    ("B1 S100 nh7", 1, 100, 7, SSM_HD, SSM_DS),
    ("B2 S100 hd64 ds64", 2, 100, 64, 64, 64),
    ("B1 S100 hd32", 1, 100, SSM_NH, 32, SSM_DS),
    ("B1 S100 hd48 ds80", 1, 100, SSM_NH, 48, 80),
    ("B1 S100 hd20 ds36", 1, 100, SSM_NH, 20, 36),
    ("B1 S100 hd33 ds37", 1, 100, SSM_NH, 33, 37),
    # a data rank's rows at data 2 (phase train_mesh): Mamba2's and
    # Zamba2's heads (nh 64, hd 64, ds 64)
    ("mamba2 B2 S2048 (data rank)", 2, 2048, SSM_NH, SSM_HD, SSM_DS),
    ("zamba2 B2 S2048 (data rank)", 2, 2048, 64, 64, 64),
]


def check_ssd_kernel(results):
    """The SSD scan against its plain version (SSD_TOL) on y and the
    final state, bf16 and f32, over SSD_CASES with and without an initial
    state, each bitwise equal across two launches; timed in float32, the
    dtype the model hands it, at the serve path's shapes and at B4 S2048:
    eager (plain, kernel, kernel, plain) and as device time from
    CUDA-graph replays."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    worst = dict.fromkeys(dtypes, 0.0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, b, s, nh, hd, ds in SSD_CASES:
        slices = ss.scan_plan(hd)
        log(f"  ssd_scan {label:<18} plan: {slices} slices of "
            f"{ss.SLICE} columns, {b * nh * slices} scan blocks on {sms} "
            "SMs")
        for with_state in (False, True):
            for dn, dt in dtypes.items():
                x, d, A, B, C, st = ssd_inputs(b, s, dt, with_state, gen,
                                               nh=nh, hd=hd, ds=ds)
                runs = [ss.ssd_scan_cuda(x, d, A, B, C, init_state=st)
                        for _ in range(2)]
                yp, fp = ss.ssd_scan_plain(x, d, A, B, C, chunk=256,
                                           init_state=st)
                torch.cuda.synchronize()
                same = all(torch.equal(p, q) for p, q in zip(*runs))
                y, fin = runs[0]
                tag = f"{label}{' +state' if with_state else ''}"
                for what, got, want, tn in (("y", y, yp, dn),
                                            ("state", fin, fp, "float32")):
                    share, cap, rel = SSD_TOL[tn]
                    want = want.float()
                    err = (got.float() - want).abs()
                    lim = min(share * float(want.abs().max()), cap)
                    ok = same and bool((err <= lim + rel * want.abs()).all())
                    worst[dn] = max(worst[dn], float(err.max()))
                    log(f"  ssd_scan {tag:<25} {dn:<8} {what:<5} "
                        f"max_abs_err={float(err.max()):.3e} "
                        f"limit={lim:.3e}+{rel:.2e}|plain| "
                        f"bitwise_repeat={same} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"ssd_scan {tag} {dn} {what} "
                                             "disagrees or is not "
                                             "repeatable")
    r = results["ssd_scan"] = {
        "name": "ssd_scan", **KERNELS["ssd_scan"],
        "max_abs_err": max(worst.values()), "max_err": worst,
        "tol": {"share_of_max_cap_share_of_element": SSD_TOL},
        "bitwise_repeatable": True, "cases": 2 * len(SSD_CASES)}
    f32 = torch.float32
    mamba2, zamba2 = (SSM_NH, SSM_HD, SSM_DS), (64, 64, 64)
    for key, b, s, with_state, iters, (nh, hd, ds) in (
            ("serve", 1, 96, False, 50, mamba2),
            ("chunk", 1, 32, True, 50, mamba2),
            ("long", 4, 2048, False, 5, mamba2),
            ("train_mesh", 2, 2048, False, 5, mamba2),
            ("train_mesh_zamba2", 2, 2048, False, 5, zamba2)):
        x, d, A, B, C, st = ssd_inputs(b, s, f32, with_state, gen, nh=nh,
                                       hd=hd, ds=ds)

        def kernel():
            return ss.ssd_scan_cuda(x, d, A, B, C, init_state=st)
        k_ms, p_ms = alternate(
            lambda: ss.ssd_scan_plain(x, d, A, B, C, chunk=256,
                                      init_state=st), kernel, iters)
        dev_ms = graph_ms(kernel, iters)
        (b_ms, b_by), (tc_ms, tc_by), flops = ssd_cost(x, B, st, "float32")
        row = {"shape": f"B{b} S{s} nh{nh} hd{hd} ds{ds} f32"
                        + (" from a state" if with_state else ""),
               "ms": k_ms, "device_ms": dev_ms, "plain_ms": p_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "bound_3xtf32_ms": tc_ms, "bound_3xtf32_by": tc_by,
               "gflop": flops / 1e9, "device_tflops": flops / dev_ms / 1e9,
               "library_ms": None}
        if key == "serve":
            r.update(row)
        else:
            r[key] = row
        log(f"  ssd_scan: kernel {k_ms:.4f} ms eager, {dev_ms:.4f} ms "
            f"device ({row['device_tflops']:.1f} TFLOP/s), plain "
            f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, f32 CUDA cores, "
            f"64-row chunks) / {tc_ms:.4f} ms ({tc_by}, 3xTF32, "
            f"{flops / 1e9:.3f} GFLOP over 32-row chunks) at {row['shape']}")


def ssd_bwd_flops(b, s, nh, hd, ds, q=SSD_KQ):
    """The flops of the SSD backward over chunks of ``q`` rows, reckoned
    as :func:`ssd_flops` does: per batch row and chunk of n rows, the
    n x n tile C·Bᵀ once (2n²·ds: B and C are shared by every head, and
    the kernel computes it once into a workspace every head reads, as K4
    does), and per head the tile dy·uᵀ (2n²·hd), the tiles' products with
    dy, B and C (2n²·hd + 4n²·ds), and five n x hd x ds products (the
    recomputed state, dS'·B, Sᵀ·dy, dS'ᵀ·u and the carried dS:
    10n·hd·ds)."""
    rows = [min(q, s - r) for r in range(0, s, q)]
    return b * sum(2 * n * n * ds
                   + nh * (4 * n * n * hd + 4 * n * n * ds
                           + 10 * n * hd * ds)
                   for n in rows)


def ssd_bwd_cost(x, B, st, dfinal):
    """Bounds of one backward: x, dt, A, B, C, dy (and the initial state
    and dfinal) read once, dx, ddt, dA, dB, dC (and dinit) written once,
    all float32.  -> ((bound ms, bound_by) at the f32 CUDA-core peak,
    (bound ms, bound_by) at the rate of the f32-accurate 3xTF32
    tensor-core products the kernel issues (495/3 TFLOP/s), flops)."""
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    state = b * nh * hd * ds
    n_in = 2 * x.numel() + b * s * nh + nh + 2 * b * s * ds \
        + state * ((st is not None) + (dfinal is not None))
    n_out = x.numel() + b * s * nh + nh + 2 * b * s * ds \
        + state * (st is not None)
    flops = ssd_bwd_flops(b, s, nh, hd, ds)
    t_bytes = 4 * (n_in + n_out) / PEAK_BYTES * 1e3
    t_tc = flops / PEAK_3XTF32 * 1e3
    tc = (t_bytes, "bytes") if t_bytes >= t_tc else (t_tc, "operations")
    return bound(4 * (n_in + n_out), flops, "float32"), tc, flops


def ssd_bwd_bytes(b, s, nh, hd, ds, slices, group, with_state=False,
                  with_dfinal=False):
    """The bytes the backward moves through device memory on the plan
    (slices, group), every array of each launch read once and
    written once: C·Bᵀ (B, C in; the cb workspace out), the states (x,
    dt, B, the initial state in; the states workspace [b, nc, nh, hd,
    ds] out), the chunks (x, dt, B, C, cb, the states, dy, dfinal in; dx,
    dinit and the partials out: ddt and dA per column slice, dB and dC
    per cluster of heads), and the wrapper's sums of the partials.
    -> {part: bytes}."""
    from repro_torch.kernels import ssd_scan as ss
    nc = -(-s // ss.CHUNK)
    x, row, bc = b * s * nh * hd, b * s * nh, b * s * ds
    state, cb = b * nh * hd * ds, b * nc * ss.CHUNK ** 2
    states = b * nc * nh * hd * ds
    part = b * s * (nh // group) * ds
    parts = slices * (row + b * nh) + 2 * part
    out = {"cb": 2 * bc + cb,
           "states": x + row + bc + state * with_state + states,
           "chunks": (2 * x + row + 2 * bc + cb + states
                      + state * with_dfinal + x + state * with_state
                      + parts),
           "sums": parts + row + nh + 2 * bc}
    return {k: 4 * v for k, v in out.items()}


# (label, b, s, nh, hd, ds): Mamba2-780M's heads (nh 48, hd 64, ds 128)
# and Zamba2-1.2B's (nh 64, hd 64, ds 64), at whole 32-row chunks (96), a
# ragged last chunk (100), the train length (2048) and the train phase's
# shape (B4 S2048); then the edges: one
# row, a head and state narrower than a warp's columns, odd widths (hd 20
# and 33: no whole number of 32-column slices; 7 and 5 heads: clusters of
# one head); a batch of one at the train length
SSD_BWD_CASES = [
    ("mamba2 B1 S96", 1, 96, SSM_NH, SSM_HD, SSM_DS),
    ("mamba2 B2 S100", 2, 100, SSM_NH, SSM_HD, SSM_DS),
    ("mamba2 B2 S2048", 2, 2048, SSM_NH, SSM_HD, SSM_DS),
    ("mamba2 B4 S2048 (train)", 4, 2048, SSM_NH, SSM_HD, SSM_DS),
    ("zamba2 B1 S96", 1, 96, 64, 64, 64),
    ("zamba2 B2 S100", 2, 100, 64, 64, 64),
    ("zamba2 B2 S2048", 2, 2048, 64, 64, 64),
    ("zamba2 B4 S2048 (train)", 4, 2048, 64, 64, 64),
    ("B1 S1", 1, 1, SSM_NH, SSM_HD, SSM_DS),
    ("B3 S65 nh7 hd20 ds36", 3, 65, 7, 20, 36),
    ("B1 S100 hd33 ds37", 1, 100, 5, 33, 37),
    ("mamba2 B1 S2048", 1, 2048, SSM_NH, SSM_HD, SSM_DS),
]
# K4b, each gradient: 5e-5 of its max |plain| (the forward's f32 bound),
# the plain VJP taken over the kernel's own 32-row chunks.  Over 256-row
# chunks the plain VJP is itself up to 4e-5 of max off the float64 truth
# (ddt: long running sums of dc that cancel), over 32-row chunks 5e-6
# (tests/test_torch_ssd_bwd.py holds both to the float64 truth)
SSD_BWD_TOL = 5e-5


SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def _hold_ssd_bwd(tag, runs, want):
    """Two launches of K4b (``runs``) against the plain VJP (``want``):
    each gradient within SSD_BWD_TOL of its max |plain|, the launches
    bitwise equal; logs the errors, raises where one fails.  -> the worst
    error as a share of its gradient's max."""
    import torch
    torch.cuda.synchronize()
    same = all(torch.equal(p, q) for p, q in zip(*runs) if p is not None)
    errs, worst = {}, 0.0
    for nm, got, ref in zip(SSD_BWD_NAMES, runs[0], want):
        if ref is None:
            continue
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        errs[nm] = (err, SSD_BWD_TOL * scale)
        worst = max(worst, err / max(scale, 1e-30))
    ok = same and all(e <= lim for e, lim in errs.values())
    log(f"  ssd_scan_bwd {tag:<44} " + " ".join(
        f"{nm}={e:.2e}/{lim:.2e}" for nm, (e, lim) in errs.items())
        + f" bitwise_repeat={same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"ssd_scan_bwd {tag} disagrees or is not "
                             "repeatable")
    return worst


def check_ssd_bwd_kernel(results):
    """The SSD backward (K4b, csrc/ssd_scan_bwd.cu) against
    ``ssd_scan_bwd_plain`` (autograd of the plain scan, 32-row chunks)
    on the card over SSD_BWD_CASES, with and without an initial state
    and a final-state cotangent: each gradient within SSD_BWD_TOL of its
    max |plain|, two launches bitwise equal, 0 spills; timed at the
    Mamba2-780M and Zamba2-1.2B train shapes (B4 S2048), eager and as
    device time from CUDA-graph replays, beside both bounds, the bytes
    it moves and its plan (the timed inputs' outputs are held to the
    plain VJP too)."""
    import re
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ss
    ptxas = _build.compiler_log("ssd_scan_bwd")
    spills = [ln for ln in ptxas if not re.search(
        r"\b0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        r"loads", ln)]
    log(f"  ssd_scan_bwd ptxas: {ptxas}")
    if not ptxas or spills:
        raise AssertionError(f"ssd_scan_bwd: ptxas lines {ptxas} (spills: "
                             f"{spills})")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    f32 = torch.float32
    worst = 0.0
    for label, b, s, nh, hd, ds in SSD_BWD_CASES:
        for with_state in (False, True):
            x, d, A, B, C, st = ssd_inputs(b, s, f32, with_state, gen,
                                           nh=nh, hd=hd, ds=ds)
            dy = torch.randn(x.shape, device="cuda", generator=gen)
            dfin = torch.randn((b, nh, hd, ds), device="cuda",
                               generator=gen) if with_state else None
            runs = [ss.ssd_scan_bwd_cuda(x, d, A, B, C, dy, init_state=st,
                                         dfinal=dfin) for _ in range(2)]
            want = ss.ssd_scan_bwd_plain(x, d, A, B, C, dy, chunk=ss.CHUNK,
                                         init_state=st, dfinal=dfin)
            tag = f"{label}{' +state +dfinal' if with_state else ''}"
            worst = max(worst, _hold_ssd_bwd(tag, runs, want))
            del runs, want
    r = results["ssd_scan_bwd"] = {
        "name": "ssd_scan_bwd", **KERNELS["ssd_scan_bwd"],
        "max_abs_err": worst, "max_err_share_of_max": worst,
        "tol": {"share_of_max": SSD_BWD_TOL}, "bitwise_repeatable": True,
        "cases": 2 * len(SSD_BWD_CASES) + 2, "ptxas": ptxas}
    for key, b, nh, hd, ds in (("mamba2", 4, SSM_NH, SSM_HD, SSM_DS),
                               ("zamba2", 4, 64, 64, 64),
                               # a data rank's rows at data 2
                               ("train_mesh", 2, SSM_NH, SSM_HD, SSM_DS),
                               ("train_mesh_zamba2", 2, 64, 64, 64)):
        s = 2048
        x, d, A, B, C, _ = ssd_inputs(b, s, f32, False, gen, nh=nh, hd=hd,
                                      ds=ds)
        dy = torch.randn(x.shape, device="cuda", generator=gen)
        out = {}

        def plain():
            out["plain"] = ss.ssd_scan_bwd_plain(x, d, A, B, C, dy,
                                                 chunk=ss.CHUNK)

        def kernel():
            out.setdefault("kernel", []).append(
                ss.ssd_scan_bwd_cuda(x, d, A, B, C, dy))
            del out["kernel"][:-2]
        k_ms, p_ms = alternate(plain, kernel, 3)
        shape = f"B{b} S{s} nh{nh} hd{hd} ds{ds} f32"
        r["max_abs_err"] = max(r["max_abs_err"], _hold_ssd_bwd(
            f"{shape} (timed inputs)", out["kernel"], out["plain"]))
        r["max_err_share_of_max"] = r["max_abs_err"]
        del out
        dev_ms = graph_ms(lambda: ss.ssd_scan_bwd_cuda(x, d, A, B, C, dy), 5)
        (b_ms, b_by), (tc_ms, tc_by), flops = ssd_bwd_cost(x, B, None, None)
        slices, group = ss.cuda_bwd_plan(b, nh, hd, ds)
        moved = ssd_bwd_bytes(b, s, nh, hd, ds, slices, group)
        clusters = ss.clusters_in_flight(nh, ds, slices, group, b)
        row = {"shape": shape, "ms": k_ms, "device_ms": dev_ms,
               "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
               "bound_share": b_ms / k_ms, "bound_3xtf32_ms": tc_ms,
               "bound_3xtf32_by": tc_by, "bound_3xtf32_share": tc_ms / k_ms,
               "gflop": flops / 1e9, "tflops": flops / k_ms / 1e9,
               "device_tflops": flops / dev_ms / 1e9,
               "bytes_moved": moved, "gb_moved": sum(moved.values()) / 1e9,
               "plan": {"slices": slices, "group": group,
                        "blocks": b * nh * slices,
                        "clusters": b * nh // group,
                        "clusters_in_flight": clusters},
               "library_ms": None}
        if key == "mamba2":
            r.update(row)
        else:
            r[key] = row
        log(f"  ssd_scan_bwd {row['shape']}: kernel {k_ms:.3f} ms eager, "
            f"{dev_ms:.3f} ms device ({row['device_tflops']:.2f} TFLOP/s); "
            f"bound {b_ms:.4f} ms ({b_by}, f32 CUDA cores, "
            f"{100 * row['bound_share']:.1f}%) / {tc_ms:.4f} ms ({tc_by}, "
            f"3xTF32, {100 * row['bound_3xtf32_share']:.1f}%), "
            f"{flops / 1e9:.1f} GFLOP; moves {row['gb_moved']:.3f} GB ("
            + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in moved.items())
            + f"), {1e3 * row['gb_moved'] / k_ms:.0f} GB/s; plan {slices} "
            f"slices x clusters of {group} heads, {b * nh * slices} blocks, "
            f"{clusters} clusters in flight of {b * nh // group}; plain "
            f"{p_ms:.3f} ms")


# ------------------------------------------------------------------ phases
def phase_kernels(results):
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import decode_attention_paged as dap
    from repro_torch.kernels import decode_attention_q8 as dq8
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    specs = {
        "decode_attention_paged": (dap.decode_attention_paged_plain,
                                   dap.decode_attention_paged_cuda, [
            # (label, inputs): Qwen2.5-7B heads, 16-page (256-token) ring
            ("B1 len1", lambda dt: decode_inputs(1, [1], 16, dt, 0, gen)),
            ("B4 len1/partial/long/wrapped",
             lambda dt: decode_inputs(4, [1, 13, 200, 300], 16, dt, 0, gen)),
            ("B4 window64",
             lambda dt: decode_inputs(4, [1, 13, 200, 300], 16, dt, 64,
                                      gen)),
            ("B3 hd80 H32 KV8 window64",
             lambda dt: decode_inputs(3, [1, 70, 300], 16, dt, 64, gen,
                                      h=32, kv=8, hd=80)),
            ("B4 serve len40/90/150/220",
             lambda dt: decode_inputs(4, [40, 90, 150, 220], 16, dt, 0, gen,
                                      n_blocks=65)),
            # a 128-page (2048-token) ring: many splits, some wholly past
            # the length, a wrapped ring under a window, group 12 (the
            # starcoder2-3b 24 q / 2 kv heads), hd 80, the timed shape
            ("B4 L2048 len1/100/1000/2048",
             lambda dt: decode_inputs(4, [1, 100, 1000, 2048], 128, dt, 0,
                                      gen)),
            ("B4 L2048 wrapped window1024",
             lambda dt: decode_inputs(4, [2049, 2100, 3000, 4113], 128, dt,
                                      1024, gen)),
            ("B4 L2048 g12 H24 KV2",
             lambda dt: decode_inputs(4, [1, 100, 1000, 2048], 128, dt, 0,
                                      gen, h=24, kv=2)),
            ("B4 L2048 hd80 H32 KV8",
             lambda dt: decode_inputs(4, [1, 100, 1000, 2048], 128, dt, 0,
                                      gen, h=32, kv=8, hd=80)),
            # zamba2-1.2b's shared block: MHA, group 1 (15 of the m16
            # tile's 16 rows zero)
            ("B4 L2048 g1 H32 KV32 hd64",
             lambda dt: decode_inputs(4, [1, 100, 1000, 2048], 128, dt, 0,
                                      gen, **ZAMBA2_HEADS)),
            # dbrx-132b's attention: GQA group 6 (48 q / 8 kv heads)
            ("B4 L2048 g6 H48 KV8 hd128",
             lambda dt: decode_inputs(4, [1, 100, 1000, 2048], 128, dt, 0,
                                      gen, **DBRX_HEADS)),
            # one tensor-parallel rank's heads (phase mesh)
            *((f"B4 L2048 g{h // kv} H{h} KV{kv} hd{hd} ({label} rank)",
               lambda dt, h=h, kv=kv, hd=hd: decode_inputs(
                   4, [1, 100, 1000, 2048], 128, dt, 0, gen, h=h, kv=kv,
                   hd=hd))
              for label, h, kv, hd in MESH_HEADS),
            ("B16 len2048 (timed)",
             lambda dt: decode_inputs(16, [2048] * 16, 128, dt, 0, gen)),
        ]),
        "decode_attention_paged_q8": (dap.decode_attention_paged_q8_plain,
                                      dap.decode_attention_paged_q8_cuda, [
            ("B1 len1", lambda dt: decode_q8_inputs(1, [1], 16, dt, 0, gen)),
            ("B4 len1/partial/long/wrapped",
             lambda dt: decode_q8_inputs(4, [1, 13, 200, 300], 16, dt, 0,
                                         gen)),
            ("B4 window64",
             lambda dt: decode_q8_inputs(4, [1, 13, 200, 300], 16, dt, 64,
                                         gen)),
            ("B3 hd80 H32 KV8 window64",
             lambda dt: decode_q8_inputs(3, [1, 70, 300], 16, dt, 64, gen,
                                         h=32, kv=8, hd=80)),
            ("B4 serve len40/90/150/220",
             lambda dt: decode_q8_inputs(4, [40, 90, 150, 220], 16, dt, 0,
                                         gen, n_blocks=65)),
            # the 2048-slot ring of K1's list, split the same ways
            ("B4 L2048 len1/100/1000/2048",
             lambda dt: decode_q8_inputs(4, [1, 100, 1000, 2048], 128, dt,
                                         0, gen)),
            ("B4 L2048 wrapped window1024",
             lambda dt: decode_q8_inputs(4, [2049, 2100, 3000, 4113], 128,
                                         dt, 1024, gen)),
            ("B4 L2048 g12 H24 KV2",
             lambda dt: decode_q8_inputs(4, [1, 100, 1000, 2048], 128, dt,
                                         0, gen, h=24, kv=2)),
            ("B4 L2048 hd80 H32 KV8",
             lambda dt: decode_q8_inputs(4, [1, 100, 1000, 2048], 128, dt,
                                         0, gen, h=32, kv=8, hd=80)),
            ("B4 L2048 hd64 H16 KV2 window512",
             lambda dt: decode_q8_inputs(4, [1, 100, 1000, 3000], 128, dt,
                                         512, gen, h=16, kv=2, hd=64)),
            ("B4 L2048 g1 H32 KV32 hd64",
             lambda dt: decode_q8_inputs(4, [1, 100, 1000, 2048], 128, dt,
                                         0, gen, **ZAMBA2_HEADS)),
            ("B16 len2048 (timed)",
             lambda dt: decode_q8_inputs(16, [2048] * 16, 128, dt, 0, gen)),
        ]),
        "decode_attention": (da.decode_attention_plain,
                             da.decode_attention_cuda, [
            ("L256 n_valid 1/90/256",
             lambda dt: dense_inputs(3, [1, 90, 256], 256, dt, gen)),
            ("L64 n_valid 1/33/64",
             lambda dt: dense_inputs(3, [1, 33, 64], 64, dt, gen)),
            ("hd80 H32 KV8 L256 n_valid 1/90/256",
             lambda dt: dense_inputs(3, [1, 90, 256], 256, dt, gen, h=32,
                                     kv=8, hd=80)),
            ("B4 serve L256 n_valid 40/90/150/220",
             lambda dt: dense_inputs(4, [40, 90, 150, 220], 256, dt, gen)),
            ("L256 n_valid 1/300 (> L keeps all L)",
             lambda dt: dense_inputs(2, [1, 300], 256, dt, gen)),
            ("L2048 n_valid 1/33/1000/2048",
             lambda dt: dense_inputs(4, [1, 33, 1000, 2048], 2048, dt, gen)),
            ("L2048 g12 H24 KV2 n_valid 1/33/1000/2048",
             lambda dt: dense_inputs(4, [1, 33, 1000, 2048], 2048, dt, gen,
                                     h=24, kv=2)),
            ("L2048 g1 H32 KV32 hd64 n_valid 1/33/1000/2048",
             lambda dt: dense_inputs(4, [1, 33, 1000, 2048], 2048, dt, gen,
                                     **ZAMBA2_HEADS)),
            ("B16 L2048 n_valid 2048 (timed)",
             lambda dt: dense_inputs(16, [2048] * 16, 2048, dt, gen)),
        ]),
        "decode_attention_q8": (dq8.decode_attention_q8_plain,
                                dq8.decode_attention_q8_cuda, [
            ("L256 n_valid 1/90/256",
             lambda dt: dense_q8_inputs(3, [1, 90, 256], 256, dt, gen)),
            ("L64 n_valid 1/33/64",
             lambda dt: dense_q8_inputs(3, [1, 33, 64], 64, dt, gen)),
            ("hd80 H32 KV8 L256 n_valid 1/90/256",
             lambda dt: dense_q8_inputs(3, [1, 90, 256], 256, dt, gen, h=32,
                                        kv=8, hd=80)),
            ("B4 serve L256 n_valid 40/90/150/220",
             lambda dt: dense_q8_inputs(4, [40, 90, 150, 220], 256, dt,
                                        gen)),
            ("L256 n_valid 1/300 (> L keeps all L)",
             lambda dt: dense_q8_inputs(2, [1, 300], 256, dt, gen)),
            ("L2048 n_valid 1/33/1000/2048",
             lambda dt: dense_q8_inputs(4, [1, 33, 1000, 2048], 2048, dt,
                                        gen)),
            ("L2048 g12 H24 KV2 n_valid 1/33/1000/2048",
             lambda dt: dense_q8_inputs(4, [1, 33, 1000, 2048], 2048, dt,
                                        gen, h=24, kv=2)),
            ("L2048 hd80 H32 KV8 n_valid 1/33/1000/2048",
             lambda dt: dense_q8_inputs(4, [1, 33, 1000, 2048], 2048, dt,
                                        gen, h=32, kv=8, hd=80)),
            ("L2048 hd64 H16 KV2 n_valid 1/33/1000/2048",
             lambda dt: dense_q8_inputs(4, [1, 33, 1000, 2048], 2048, dt,
                                        gen, h=16, kv=2, hd=64)),
            ("L2048 g1 H32 KV32 hd64 n_valid 1/33/1000/2048",
             lambda dt: dense_q8_inputs(4, [1, 33, 1000, 2048], 2048, dt,
                                        gen, **ZAMBA2_HEADS)),
            ("B16 L2048 n_valid 2048 (timed)",
             lambda dt: dense_q8_inputs(16, [2048] * 16, 2048, dt, gen)),
        ]),
    }
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (plain, kernel, cases) in specs.items():
        split = name in SPLIT_KERNELS
        worst = dict.fromkeys(dtypes, 0.0)
        for label, make in cases:
            for dn, dt in dtypes.items():
                args, kw = make(dt)
                if split and dn == "bfloat16":
                    splits, split_len = decode_split_plan(args, sms)
                    b, kv = args[0].shape[0], args[1].shape[2]
                    log(f"  {name:<24} {label:<38} split plan: {splits} x "
                        f"{split_len} slots ({splits * b * kv} blocks of "
                        f"pass 1 on {sms} SMs, "
                        f"{2 if splits > 1 else 1} launches)")
                runs = [kernel(*args, **kw) for _ in range(1 + split)]
                want = plain(*args, **kw)
                torch.cuda.synchronize()
                got = runs[0]
                same = all(torch.equal(got, r) for r in runs[1:])
                err = (got.float() - want.float()).abs()
                ok = same and bool((err <= TOL[dn] + TOL[dn]
                                    * want.float().abs()).all())
                worst[dn] = max(worst[dn], float(err.max()))
                log(f"  {name:<24} {label:<38} {dn:<8} "
                    f"max_abs_err={float(err.max()):.3e} tol={TOL[dn]:g} "
                    + (f"bitwise_repeat={same} " if split else "")
                    + ("ok" if ok else "FAIL"))
                if not ok:
                    raise AssertionError(f"{name} {label} {dn} disagrees"
                                         + ("" if same else
                                            " or is not repeatable"))
        results[name] = {"name": name, **KERNELS[name],
                         "max_abs_err": max(worst.values()),
                         "max_err": worst, "tol": TOL}
        if split:
            results[name].update(bitwise_repeatable=True, cases=len(cases))
    # int8: NaN scale bits (and random values) in every pool row past each
    # length change no bit of the output
    for name, kernel, make, paged in (
            ("decode_attention_paged_q8", dap.decode_attention_paged_q8_cuda,
             lambda dt: decode_q8_inputs(4, [1, 100, 1000, 2047], 128, dt, 0,
                                         gen), True),
            ("decode_attention_q8", dq8.decode_attention_q8_cuda,
             lambda dt: dense_q8_inputs(4, [1, 33, 1000, 2047], 2048, dt,
                                        gen), False)):
        for dn, dt in dtypes.items():
            args, kw = make(dt)
            nan, zero = (kernel(*a, **kw) for a in nan_past_length(args, paged))
            torch.cuda.synchronize()
            ok = bool(torch.isfinite(nan).all()) and torch.equal(nan, zero)
            log(f"  {name:<24} NaN scales past each length {dn:<8} finite and "
                f"bitwise equal to zeroed rows: {ok}")
            if not ok:
                raise AssertionError(f"{name} {dn} reads rows past the length")
        results[name]["nan_past_length_ok"] = True
    fwd_worst = check_flash_forward(results)

    def timed(plain, kernel, args, kw, cost, lib, iters, dn, graph=False):
        """Eager CUDA-event times (plain, kernel, kernel, plain; the
        library call); with ``graph`` also the device times of the kernel
        and the library call from CUDA-graph replays."""
        k_ms, p_ms = alternate(lambda: plain(*args, **kw),
                               lambda: kernel(*args, **kw), iters)
        b_ms, b_by = cost(args, kw.get("window", 0), dn)
        lib_ms = time_ms(lib, iters) if lib else None
        row = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": lib_ms}
        if graph:
            row["device_ms"] = graph_ms(lambda: kernel(*args, **kw), 50)
            row["library_device_ms"] = graph_ms(lib, 50) if lib else None
        if b_by == "bytes":   # the bytes the bound counts, over the time
            row["achieved_gbps"] = b_ms * PEAK_BYTES / 1e9 / k_ms
            if graph:
                row["device_gbps"] = \
                    b_ms * PEAK_BYTES / 1e9 / row["device_ms"]
        return row

    bf = torch.bfloat16
    # the serve path's shapes: 4 slots over a 256-token ring (65 pages,
    # as the engine sizes its pool), one whole-prompt bucket of 128
    a, kw = decode_inputs(4, [40, 90, 150, 220], 16, bf, 0, gen, n_blocks=65)
    results["decode_attention_paged"].update(
        shape="B4 H28 KV4 hd128 P16 L256 len[40,90,150,220] bf16",
        **timed(dap.decode_attention_paged_plain,
                dap.decode_attention_paged_cuda, a, kw, decode_cost, None,
                50, "bfloat16", graph=True))
    a, kw = flash_inputs(1, 128, bf, 0, gen)
    results["flash_attention"].update(
        shape="B1 S128 H28 KV4 hd128 causal bf16",
        **timed(fa.flash_attention_plain,
                fa.flash_attention_cuda, a, kw, flash_cost, sdpa_fn(a), 50,
                "bfloat16"))
    results["flash_attention"]["achieved_tflops"] = \
        attn_flops(a[0], 0) / results["flash_attention"]["ms"] / 1e9
    # one long shape each
    a, kw = decode_inputs(16, [2048] * 16, 128, bf, 0, gen)
    results["decode_attention_paged"]["long"] = dict(
        shape="B16 len2048 H28 KV4 hd128 P16 bf16",
        **timed(dap.decode_attention_paged_plain,
                dap.decode_attention_paged_cuda, a, kw, decode_cost, None,
                10, "bfloat16", graph=True))
    a, kw = flash_inputs(1, 2048, bf, 0, gen)
    long = results["flash_attention"]["long"] = dict(
        shape="B1 S2048 H28 KV4 hd128 causal bf16",
        **timed(fa.flash_attention_plain,
                fa.flash_attention_cuda, a, kw, flash_cost, sdpa_fn(a), 5,
                "bfloat16"))
    long["achieved_tflops"] = attn_flops(a[0], 0) / long["ms"] / 1e9
    # the int8 paged and the dense kernels at the same two shapes: the
    # serve path's 4 slots over a 256-token ring, and B16 x 2048
    for name, plain, kernel, make, cost, lib in (
            ("decode_attention_paged_q8",
             dap.decode_attention_paged_q8_plain,
             dap.decode_attention_paged_q8_cuda,
             lambda b, n, L: decode_q8_inputs(
                 b, n, L // PAGE, bf, 0, gen,
                 n_blocks=65 if b == 4 else None), decode_q8_cost, None),
            ("decode_attention", da.decode_attention_plain,
             da.decode_attention_cuda,
             lambda b, n, L: dense_inputs(b, n, L, bf, gen), dense_cost,
             sdpa_decode_fn),
            ("decode_attention_q8", dq8.decode_attention_q8_plain,
             dq8.decode_attention_q8_cuda,
             lambda b, n, L: dense_q8_inputs(b, n, L, bf, gen),
             dense_q8_cost, None)):
        kv_type = "int8" if name.endswith("q8") else "bf16"
        a, kw = make(4, [40, 90, 150, 220], 256)
        results[name].update(
            shape=f"B4 H28 KV4 hd128 L256 len[40,90,150,220] {kv_type} KV, "
                  "bf16 q",
            **timed(plain, kernel, a, kw, cost, lib and lib(a), 50,
                    "bfloat16", graph=True))
        a, kw = make(16, [2048] * 16, 2048)
        results[name]["long"] = dict(
            shape=f"B16 len2048 H28 KV4 hd128 {kv_type} KV, bf16 q",
            **timed(plain, kernel, a, kw, cost, lib and lib(a), 10,
                    "bfloat16", graph=True))
    for shape, r in (("serve", results["decode_attention"]),
                     ("B16x2048", results["decode_attention"]["long"])):
        verdict = "no slower" if r["device_ms"] <= r["library_device_ms"] \
            else "SLOWER"
        log(f"  decode_attention {shape}: device {r['device_ms']:.4f} ms "
            f"against SDPA's {r['library_device_ms']:.4f} ms ({verdict}; "
            "CUDA-graph replays, same run)")
    # the int8 kernels beside the bf16 ones at the same shapes (device
    # time from CUDA-graph replays, same run): the share of the byte bound
    # at B16 x 2048, and the ratio to the bf16 kernel at both shapes
    for q8, bf16 in (("decode_attention_paged_q8", "decode_attention_paged"),
                     ("decode_attention_q8", "decode_attention")):
        for shape, key in (("serve", None), ("B16x2048", "long")):
            r8, rb = results[q8], results[bf16]
            if key:
                r8, rb = r8[key], rb[key]
            r8["bound_share"] = r8["bound_ms"] / r8["device_ms"]
            r8["vs_bf16"] = r8["device_ms"] / rb["device_ms"]
            log(f"  {q8} {shape}: device {r8['device_ms']:.4f} ms, "
                f"{100 * r8['bound_share']:.1f}% of its byte bound "
                f"{r8['bound_ms']:.4f} ms, {r8['vs_bf16']:.2f}x {bf16}'s "
                f"{rb['device_ms']:.4f} ms")
    # K1 and K6 at zamba2-1.2b's serve shape: the shared block's 32 q / 32
    # kv heads of hd 64 (group 1), 4 slots over a 256-token ring
    for name, plain, kernel, a_kw, cost, lib in (
            ("decode_attention_paged", dap.decode_attention_paged_plain,
             dap.decode_attention_paged_cuda,
             decode_inputs(4, [40, 90, 150, 220], 16, bf, 0, gen,
                           n_blocks=65, **ZAMBA2_HEADS), decode_cost, None),
            ("decode_attention", da.decode_attention_plain,
             da.decode_attention_cuda,
             dense_inputs(4, [40, 90, 150, 220], 256, bf, gen,
                          **ZAMBA2_HEADS), dense_cost, sdpa_decode_fn)):
        a, kw = a_kw
        r = results[name]["zamba2"] = dict(
            shape="B4 H32 KV32 hd64 L256 len[40,90,150,220] bf16 (group 1)",
            **timed(plain, kernel, a, kw, cost, lib and lib(a), 50,
                    "bfloat16", graph=True))
        log(f"  {name} zamba2 serve shape (group 1): device "
            f"{r['device_ms']:.4f} ms, eager {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms (device "
            f"{r['library_device_ms']})")
    # K1 and K2 at one tensor-parallel rank's heads (phase mesh): the
    # serve engine's 4 slots over a 256-token ring, a 128-token prompt
    for label, h, kv, hd in MESH_HEADS:
        a, kw = decode_inputs(4, [40, 90, 150, 220], 16, bf, 0, gen,
                              n_blocks=65, h=h, kv=kv, hd=hd)
        r1 = results["decode_attention_paged"].setdefault("mesh", {})[
            label] = dict(shape=f"B4 H{h} KV{kv} hd{hd} L256 "
                                "len[40,90,150,220] bf16",
                          **timed(dap.decode_attention_paged_plain,
                                  dap.decode_attention_paged_cuda, a, kw,
                                  decode_cost, None, 50, "bfloat16",
                                  graph=True))
        a = flash_train_inputs(1, 128, h, kv, hd, bf, gen)[:3]
        kw = {"causal": True, "window": 0}
        r2 = results["flash_attention"].setdefault("mesh", {})[label] = dict(
            shape=f"B1 S128 H{h} KV{kv} hd{hd} causal bf16",
            **timed(fa.flash_attention_plain, fa.flash_attention_cuda, a,
                    kw, flash_cost, sdpa_fn(a), 50, "bfloat16"))
        for name, r in (("decode_attention_paged", r1),
                        ("flash_attention", r2)):
            log(f"  {name} at a {label} rank's heads ({r['shape']}): "
                f"kernel {r['ms']:.4f} ms"
                + (f", device {r['device_ms']:.4f}" if "device_ms" in r
                   else "")
                + f", bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
                f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}")
    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{r['library_ms']} ms at {r['shape']}; long: "
            f"{json.dumps(r['long'])}")
    check_train_kernels(results, fwd_worst)
    check_flash_offset(results)
    check_ssd_kernel(results)
    check_ssd_bwd_kernel(results)


def _serve_run(cfg, params, model, pairs, policy, discipline, paged,
               profiler=None):
    import torch
    from repro_torch.core.policies import make
    from repro_torch.engine.engine import Engine
    from repro_torch.launch.serve import _to_rts
    rts = _to_rts(pairs)
    eng = Engine(cfg, params, max_slots=4, max_seq_len=256, paged=paged,
                 profiler=profiler, device="cuda")
    pol = make(policy, model=model, max_batch=4, device=eng.device)
    out = eng.run_policy(rts, pol, discipline=discipline, model=model)
    torch.cuda.synchronize()
    for rt in rts:
        got = out[rt.req_id]["tokens"]
        if len(got) != rt.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in got):
            raise AssertionError(f"request {rt.req_id}: {len(got)} of "
                                 f"{rt.max_new_tokens} tokens, or one out "
                                 "of the vocabulary")
    met = sum(v["met"] for v in out.values())
    e2e = sum(v["e2e"] for v in out.values())
    ntok = sum(len(v["tokens"]) for v in out.values())
    return {"layout": "paged" if paged else "dense", "policy": policy,
            "discipline": discipline, "n": len(out),
            "completed": len(out), "G": met / e2e if e2e else 0.0,
            "attainment": met / len(out),
            "ttft_mean_s": sum(v["ttft"] for v in out.values()) / len(out),
            "tokens": ntok, "engine_s": eng.clock,
            "tok_per_s": ntok / eng.clock,
            "preemptions": sum(v["preemptions"] for v in out.values()),
            "prefix_hit_rate": eng.prefix_stats()["hit_rate"],
            # prefill passes: timed steps (whole prompts and chunks) and
            # the off-clock warm-ups of new lengths
            "prefill_passes": (None if profiler is None else
                               len(profiler.prefill_samples) + sum(
                                   1 for k in eng._warm
                                   if k[0] in ("prefill", "chunk")))}


def full_model(ctx):
    """Qwen2.5-7B at its published config, random seeded bf16 weights,
    drawn on the card once and shared by the serve and int8 phases."""
    if "params" not in ctx:
        import torch
        from repro_torch.configs import get_config
        from repro_torch.models.model import init_params
        cfg = get_config("qwen2.5-7b")
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        log(f"  {cfg.name}: {cfg.num_layers} layers d={cfg.d_model} "
            f"heads={cfg.num_heads}/{cfg.num_kv_heads} "
            f"vocab={cfg.vocab_size} {cfg.dtype}: {nbytes / 1e9:.2f} GB of "
            f"weights drawn in {time.perf_counter() - t0:.1f} s")
        ctx["cfg"], ctx["params"] = cfg, params
    return ctx["cfg"], ctx["params"]


def count_path(results, path, fn):
    """Drive one path with the launch counts set to 0 just before and
    read just after; every kernel of the path must have launched."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    counts = ops.launch_counts()
    log(f"  launches on the {path} path: {counts}")
    for name in PATHS[path]:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"{name} was never launched on the "
                                 f"{path} path")
    for name, n in counts.items():
        if n and name in KERNELS:
            r = results.setdefault(name, {"name": name, **KERNELS[name]})
            r.setdefault("launches_by_path", {})[path] = n
            r["launches"] = sum(r["launches_by_path"].values())
    return out


def _log_runs(card, runs):
    for r in runs:
        log(f"  serve {card} {r['layout']:<5} {r['policy']:<12} "
            f"{r['discipline']:<10} completed={r['completed']}/{r['n']} "
            f"G={r['G']:.4f} attainment={r['attainment']:.2f} "
            f"ttft_mean={r['ttft_mean_s'] * 1e3:.2f}ms "
            f"tok/s={r['tok_per_s']:.1f} engine_s={r['engine_s']:.3f} "
            f"preemptions={r['preemptions']} "
            f"prefix_hit_rate={r['prefix_hit_rate']:.3f}")
    log("  serve runs: " + json.dumps(runs))


def phase_serve(ctx):
    import numpy as np
    from repro_torch.core.latency_model import PAPER_TABLE2
    from repro_torch.data.synthetic import (sample_multiturn_token_requests,
                                            sample_serve_workload)
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import fit_latency_model
    from repro_torch.models.model import init_params
    card, results = ctx["card"], ctx["results"]
    cfg, params = full_model(ctx)
    policies = (("fcfs", "stall"), ("slo-reanneal", "stall"),
                ("slo-preempt", "chunked:32"))

    def paged_path():
        rng = np.random.default_rng(0)
        model = fit_latency_model(cfg, params, 4, rng, device="cuda")
        if model == PAPER_TABLE2:
            raise AssertionError("the latency model fell back to the "
                                 "paper's V100 table instead of fitting "
                                 "this card")
        log(f"  latency model fit on {card}: {model}")
        runs = [_serve_run(cfg, params, model,
                           sample_serve_workload(8, cfg.vocab_size, seed=1),
                           policy, disc, True) for policy, disc in policies]
        pairs = sample_multiturn_token_requests(2, turns=3,
                                                vocab=cfg.vocab_size)
        runs.append(_serve_run(cfg, params, model, pairs, "fcfs", "stall",
                               True))
        runs[-1]["workload"] = "multiturn"
        return model, runs

    model, runs = count_path(results, "serve_paged", paged_path)
    _log_runs(card, runs)
    if runs[-1]["prefix_hit_rate"] <= 0:
        raise AssertionError("multi-turn run had no prefix hit")
    # the dense layout: same workload, same fitted latency model
    runs = count_path(results, "serve_dense", lambda: [
        _serve_run(cfg, params, model,
                   sample_serve_workload(8, cfg.vocab_size, seed=1), policy,
                   disc, False) for policy, disc in policies])
    _log_runs(card, runs)
    # head_dim 80 end to end: h2o-danube-1.8b at its published config on
    # the paged engine under fcfs (which plans nothing with the latency
    # model, so Qwen's fit serves)
    dcfg = get_config("h2o-danube-1.8b")
    dparams = init_params(dcfg, seed=0, device="cuda")
    log(f"  {dcfg.name}: {dcfg.num_layers} layers d={dcfg.d_model} heads="
        f"{dcfg.num_heads}/{dcfg.num_kv_heads} hd={dcfg.head_dim} window="
        f"{dcfg.sliding_window} {dcfg.dtype}")
    runs = count_path(results, "serve_hd80", lambda: [
        _serve_run(dcfg, dparams, model,
                   sample_serve_workload(8, dcfg.vocab_size, seed=1), "fcfs",
                   "stall", True)])
    _log_runs(card, runs)
    del dparams


STREAM_RATE = 4.0       # Poisson arrivals of the stream phase, req/s
# requests a stream run serves: ~4 s of arrivals (64 until the mesh
# phases joined, 32 until the script ran past its time limit)
STREAM_N = 16
# the pool a deployment of Qwen2.5-7B on one 80 GB card holds: 64
# sequences of up to 4096 tokens, 15.0 GB of bf16 K/V (paged or dense)
STREAM_SLOTS, STREAM_SEQ = 64, 4096
TURNS = (True, False)   # paged fcfs: overlapped, then synchronous
# the stream phase's Qwen2.5-7B and Mamba2-780M, and the stream runs of
# the hybrid and moe phases (Zamba2-1.2B, DeepSeek-V2-Lite: since the
# mesh phase joined), at an eighth of their published depth (published
# widths, the first layers; a quarter until the script ran past its time
# limit), Zamba2 down to its first shared attention block, so that the
# whole script keeps inside its time limit: each run's wall is set by the
# trace's longest request, a chain of decode rounds whose host dispatch
# grows with the layers
STREAM_DEPTH = 0.125


def _stream_run(make, pairs, what):
    """Serve ``pairs`` through the ServeLoop or EngineFleet that
    ``make()`` builds, on the wall clock; every request must complete
    with its whole output budget of in-vocabulary tokens.  Returns the
    run's row: wall-clock TTFT and TBT percentiles, tok/s, attainment,
    G, dispatch widths, the share of overlapped ticks, and, per loop,
    where its host time went as shares of the wall: the policy
    (``_schedule``), the prefill steps (timed, so synchronized), queuing
    the decode rounds (``_dispatch_round``) and waiting on a round's
    readback (near 0 while the host, not the card, is the bottleneck).
    The engines are freed before and after the run: each holds a
    deployment-sized pool."""
    import collections
    import gc
    import numpy as np
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    loop = make()
    loops = getattr(loop, "loops", [loop])
    # one loop, one stream: fleet members never share one
    if len({id(lp._stream) for lp in loops}) != len(loops) or any(
            lp._stream == torch.cuda.default_stream() for lp in loops):
        raise AssertionError(f"{what}: loops share a stream")
    spent = [collections.Counter() for _ in loops]   # one per loop thread

    def timed(fn, key, box):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                box[key] += time.perf_counter() - t0
        return run

    for lp, box in zip(loops, spent):
        def consume(ticket, real=lp._consume, box=box):
            t0 = time.perf_counter()
            if ticket.done is not None:
                ticket.done.synchronize()
            box["readback_wait"] += time.perf_counter() - t0
            real(ticket)
        lp._consume = consume
        lp._schedule = timed(lp._schedule, "schedule", box)
        lp._run_prefill_plan = timed(lp._run_prefill_plan, "prefill", box)
        lp._dispatch_round = timed(lp._dispatch_round, "dispatch", box)
    loop.start(warm_lengths=[len(p) for _, p in pairs])
    streams = loop.submit_trace(pairs)
    t0 = time.perf_counter()
    loop.serve()
    wall = time.perf_counter() - t0
    vocab = loops[0].eng.cfg.vocab_size
    for (r, _), st in zip(pairs, streams):
        want = r.planning_output_len()
        if st.error is not None or len(st.tokens) != want or not all(
                0 <= t < vocab for t in st.tokens):
            raise AssertionError(f"{what}: request {st.req_id} gave "
                                 f"{len(st.tokens)} of {want} tokens "
                                 f"(error {st.error})")
    m = loop.metrics
    s = m.summary()
    done = [tl for tl in m.timelines.values() if not tl.rejected]
    ttft = [tl.ttft for tl in done]
    tbt = [g for tl in done for g in tl.tbt]
    pct = lambda xs, q: float(np.percentile(xs, q)) * 1e3   # noqa: E731
    widths = collections.Counter(g.dispatch_width for g in m.gauges
                                 if g.dispatch_width)
    rounds = [sum(1 for g in lp.metrics.gauges if g.dispatch_width)
              for lp in loops]
    row = {"run": what, "n": len(pairs), "completed": s["n"],
           "G": s["G"], "attainment": s["attainment"],
           "ttft_p50_ms": pct(ttft, 50), "ttft_p90_ms": pct(ttft, 90),
           "ttft_p99_ms": pct(ttft, 99),
           "tbt_p50_ms": pct(tbt, 50), "tbt_p90_ms": pct(tbt, 90),
           "tbt_p99_ms": pct(tbt, 99), "n_tbt": len(tbt),
           "tok_per_s_wall": s["tokens_per_s"], "tokens": s["tokens"],
           "serve_s": wall, "ticks": len(m.gauges),
           "dispatch_widths": dict(sorted(widths.items())),
           "overlap_frac": s["overlap_frac"],
           "host_share": [{k: box[k] / wall for k in (
               "schedule", "prefill", "dispatch", "readback_wait")}
               for box in spent],
           "dispatch_ms_per_round": [box["dispatch"] * 1e3 / max(1, n)
                                     for box, n in zip(spent, rounds)],
           "preemptions": s["preemptions"],
           "tokens_by_request": [st.tokens for st in streams]}
    del loop, loops, streams
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _log_stream(card, smi, runs):
    for r in runs:
        log(f"  stream {card} | {smi} | {r['run']}: completed="
            f"{r['completed']}/{r['n']} G={r['G']:.4f} attainment="
            f"{r['attainment']:.2f} TTFT p50/p90/p99="
            f"{r['ttft_p50_ms']:.2f}/{r['ttft_p90_ms']:.2f}/"
            f"{r['ttft_p99_ms']:.2f} ms TBT p50/p90/p99="
            f"{r['tbt_p50_ms']:.2f}/{r['tbt_p90_ms']:.2f}/"
            f"{r['tbt_p99_ms']:.2f} ms (of {r['n_tbt']} gaps) tok/s(wall)="
            f"{r['tok_per_s_wall']:.1f} tokens={r['tokens']} serve_s="
            f"{r['serve_s']:.3f} widths={r['dispatch_widths']} overlapped="
            f"{r['overlap_frac']:.3f} preemptions={r['preemptions']}")
        for i, (share, ms) in enumerate(zip(r["host_share"],
                                            r["dispatch_ms_per_round"])):
            log(f"    loop {i}: dispatch ms/round={ms:.2f} host share of "
                "the wall: " + " ".join(f"{k}={v:.3f}"
                                        for k, v in share.items()))
    log("  stream runs: " + json.dumps(
        [{k: v for k, v in r.items() if k != "tokens_by_request"}
         for r in runs]))


def _stream_anneal_runs(ctx, engine, workload, model):
    """The two serving paths that reach the batched annealer, on the
    stream phase's trace and pools, each driven with the launch counts
    set to 0 just before it.  A ServeLoop under ``slo-reanneal:jax``
    anneals the waiting queue at every admission event with two or more
    waiting: once as the trace arrives (at 4 req/s a queue of two forms
    only when two arrivals share a tick), once with the whole trace
    waiting at t=0, the setting of the paper's Algorithm 1 and of the
    serve phase's batch runs (``arrival_rate=0``), which anneals all 64
    requests at once.  A 2-engine EngineFleet under ``route:annealed``
    plans the arriving trace by Algorithm 2: memory-greedy assignment
    against each engine's pool, then every instance's queue annealed in
    one launch."""
    from repro_torch.core.profiler import MemoryModel
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineFleet, ServeLoop
    # the mapper's memory: each engine's pool in tokens (the default,
    # unbounded, sends every request to instance 0)
    memory = MemoryModel(total_memory=STREAM_SLOTS * STREAM_SEQ)

    def counted(make, pairs, what):
        before = ops.launch_counts().get("anneal", 0)
        row = _stream_run(make, pairs, what)
        row["anneal_launches"] = ops.launch_counts().get("anneal", 0) - before
        return row

    def reanneal():
        return [counted(lambda: ServeLoop(engine(), "slo-reanneal:jax",
                                          model=model), w, what)
                for w, what in ((workload(), "paged slo-reanneal:jax stall"),
                                (workload(rate=0.0), "paged slo-reanneal:jax "
                                 "stall, all waiting at t=0"))]

    def route():
        return [counted(lambda: EngineFleet(
            [engine(), engine()], "fcfs", mapper="annealed", model=model,
            discipline="stall", memory=memory), workload(),
            "fleet x2 route:annealed fcfs stall")]

    runs = count_path(ctx["results"], "serve_stream_reanneal_jax", reanneal)
    runs += count_path(ctx["results"], "serve_stream_route_annealed", route)
    for row in runs:
        if min(row["dispatch_ms_per_round"]) <= 0:
            raise AssertionError(f"{row['run']}: an engine served nothing")
        log(f"  stream {ctx['card']} | {ctx['smi']} | {row['run']}: "
            f"completed={row['completed']}/{row['n']} attainment="
            f"{row['attainment']:.2f} G={row['G']:.4f} anneal launches="
            f"{row['anneal_launches']} policy share of the wall="
            f"{row['host_share'][0]['schedule']:.4f}")
    # one anneal at least where a queue is certain to be waiting
    if runs[1]["anneal_launches"] < 1 or runs[2]["anneal_launches"] < 1:
        raise AssertionError("anneal: no launch with the whole trace "
                             "waiting, or no plan on the annealed fleet")
    return runs


def _cut_depth(cfg):
    """``cfg`` at ``STREAM_DEPTH`` of its layers, published widths (a
    uniform stack: the pattern is rebuilt from the family, never cut)."""
    return dataclasses.replace(cfg, num_layers=round(cfg.num_layers
                                                     * STREAM_DEPTH),
                               layer_pattern=())


def _first_layers(cfg, params, n):
    """``cfg`` and ``params`` cut to the first ``n`` layers of the
    published stack (its pattern's prefix; a hybrid's shared block kept),
    published widths, no new weights."""
    return (dataclasses.replace(cfg, num_layers=n,
                                layer_pattern=cfg.layer_pattern[:n]),
            dict(params, layers=params["layers"][:n]))


def _stream_cut(cfg, params):
    """``cfg`` and ``params`` at ``STREAM_DEPTH`` of the layers
    (``_first_layers``; a hybrid's down to its shared block's first
    use)."""
    n = round(cfg.num_layers * STREAM_DEPTH)
    if "attn" in cfg.layer_pattern:
        n = max(n, cfg.layer_pattern.index("attn") + 1)
    return _first_layers(cfg, params, n)


def phase_stream(ctx):
    """The streaming serving loop on the wall clock: each request's
    tokens stream out as the loop delivers them, decode rounds are
    dispatched one ahead of the host's readback."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.latency_model import PAPER_TABLE2
    from repro_torch.data.traces import sample_trace_workload
    from repro_torch.engine.engine import Engine
    from repro_torch.launch.serve import fit_latency_model
    from repro_torch.models.model import init_params
    from repro_torch.serving import EngineFleet, ServeLoop
    card, smi, results = ctx["card"], ctx["smi"], ctx["results"]
    full_cfg, full_params = full_model(ctx)
    cfg = _cut_depth(full_cfg)
    params = {**full_params, "layers": full_params["layers"][
        :cfg.num_layers]}
    model = fit_latency_model(cfg, params, 4, np.random.default_rng(0),
                              device="cuda")
    log(f"  stream {cfg.name} at {cfg.num_layers} of {full_cfg.num_layers} "
        f"layers: latency model fit on {card}: {model}")

    def engine(p=params, c=cfg, paged=True):
        return Engine(c, p, max_slots=STREAM_SLOTS, max_seq_len=STREAM_SEQ,
                      paged=paged, device="cuda")

    def workload(c=cfg, rate=STREAM_RATE):
        # ShareGPT (Vicuna) and python-code lengths from the in-repo
        # histograms, uncut, paced as a Poisson process (rate 0: all at
        # t=0)
        return sample_trace_workload(STREAM_N, c.vocab_size, rate=rate,
                                     seed=1)

    def loop(policy, disc="stall", overlap=True, paged=True):
        return lambda: ServeLoop(engine(paged=paged), policy, model=model,
                                 discipline=disc, overlap=overlap)

    pairs = workload()
    lens = np.array([[r.input_len, r.planning_output_len()]
                     for r, _ in pairs])
    log(f"  stream workload: {STREAM_N} requests at {STREAM_RATE} req/s "
        f"over {pairs[-1][0].arrival_time:.2f} s, prompt tokens median "
        f"{np.median(lens[:, 0]):.0f} max {lens[:, 0].max()}, output "
        f"tokens median {np.median(lens[:, 1]):.0f} max "
        f"{lens[:, 1].max()} sum {lens[:, 1].sum()}; pool {STREAM_SLOTS} "
        f"slots x {STREAM_SEQ} tokens")

    def paged_path():
        # overlapped, then synchronous: one card, one call, so the two
        # compare without the spread between calls
        runs = [_stream_run(loop("fcfs", overlap=overlap), workload(),
                            "paged fcfs stall" + ("" if overlap else
                                                  " --no-overlap"))
                for overlap in TURNS]
        runs += [_stream_run(loop("slo-preempt", "chunked:32"), workload(),
                             "paged slo-preempt chunked:32"),
                 _stream_run(lambda: EngineFleet(
                     [engine(), engine()], "fcfs", mapper="least-loaded",
                     model=model, discipline="stall"),
                     workload(), "fleet x2 least-loaded fcfs stall")]
        return runs

    runs = count_path(results, "serve_stream", paged_path)
    same = all(r["tokens_by_request"] == runs[0]["tokens_by_request"]
               for r in runs[1:len(TURNS)])
    log(f"  stream {cfg.name} bf16: overlapped vs synchronous tokens "
        f"identical={same} (reported only: bf16 rounds of other widths "
        "may flip an argmax; the parity phase holds it at f32)")
    for key in ("tbt_p50_ms", "tbt_p90_ms", "tbt_p99_ms", "ttft_p50_ms",
                "ttft_p90_ms", "tok_per_s_wall", "serve_s"):
        by = {o: [r[key] for r, t in zip(runs, TURNS) if t == o]
              for o in (True, False)}
        log(f"  stream {card} | {smi} | paged fcfs {key}, overlapped / "
            f"synchronous, mean of {len(by[True])} turns each: "
            f"{np.mean(by[True]):.2f} / {np.mean(by[False]):.2f} "
            f"(each: {[round(v, 2) for v in by[True]]} / "
            f"{[round(v, 2) for v in by[False]]})")
    runs += count_path(results, "serve_stream_dense", lambda: [
        _stream_run(loop("fcfs", paged=False), workload(),
                    "dense fcfs stall")])
    runs += _stream_anneal_runs(ctx, engine, workload, model)
    for r in runs:
        r["model"], r["layers"] = cfg.name, cfg.num_layers
    # Mamba2-780M at its published width: fcfs plans nothing with the
    # latency model, so the paper's table serves
    scfg = _cut_depth(get_config("mamba2-780m"))
    sparams = init_params(scfg, seed=0, device="cuda")
    log(f"  stream {scfg.name} at {scfg.num_layers} layers")
    ssm_runs = count_path(results, "serve_stream_ssm", lambda: [
        _stream_run(lambda: ServeLoop(engine(sparams, scfg), "fcfs",
                                      model=PAPER_TABLE2), workload(scfg),
                    "mamba2 dense fcfs stall")])
    ssm_runs[0]["model"], ssm_runs[0]["layers"] = scfg.name, scfg.num_layers
    del sparams
    torch.cuda.empty_cache()
    runs += ssm_runs
    _log_stream(card, smi, runs)
    pow2 = {1 << k for k in range(STREAM_SLOTS.bit_length())}
    for r in runs:
        sync = "no-overlap" in r["run"]
        widths = set(r["dispatch_widths"])
        # pow-2 buckets on the paged engine (the fleet's too), the whole
        # pool on the dense one; overlap in every overlapped run only
        ok_widths = widths == {STREAM_SLOTS} if "dense" in r["run"] \
            else widths <= pow2
        if not widths or not ok_widths or \
                (r["overlap_frac"] > 0) == sync:
            raise AssertionError(f"stream run {r['run']}: widths {widths}, "
                                 f"overlapped share {r['overlap_frac']}")
    ctx["stream"] = runs


def phase_ssm(ctx):
    """Mamba2-780M at its published config on the dense engine: the SSD
    scan launches once per layer per prefill pass (whole prompt or
    chunk, warm-ups included); no attention kernel launches."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.latency_model import PAPER_TABLE2
    from repro_torch.core.profiler import LatencyProfiler
    from repro_torch.data.synthetic import sample_serve_workload
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import fit_latency_model
    from repro_torch.models.model import init_params
    card, results = ctx["card"], ctx["results"]
    cfg = get_config("mamba2-780m")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    log(f"  {cfg.name}: {cfg.num_layers} layers d={cfg.d_model} d_inner="
        f"{cfg.ssm.d_inner(cfg.d_model)} heads={cfg.ssm.n_heads(cfg.d_model)}"
        f"x{cfg.ssm.head_dim} d_state={cfg.ssm.d_state} conv="
        f"{cfg.ssm.d_conv} chunk={cfg.ssm.chunk_size} vocab="
        f"{cfg.vocab_size} {cfg.dtype}: "
        f"{sum(t.numel() for t in leaves) / 1e9:.3f} B params, "
        f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} GB "
        f"drawn in {time.perf_counter() - t0:.1f} s")
    policies = (("fcfs", "stall"), ("slo-reanneal", "stall"),
                ("slo-preempt", "chunked:32"))

    def path():
        rng = np.random.default_rng(0)
        model = fit_latency_model(cfg, params, 4, rng, device="cuda")
        if model == PAPER_TABLE2:
            raise AssertionError("the latency model fell back to the "
                                 "paper's V100 table instead of fitting "
                                 "this card")
        log(f"  latency model fit on {card}: {model}")
        runs = []
        for policy, disc in policies:
            before = ops.launch_counts()
            r = _serve_run(cfg, params, model,
                           sample_serve_workload(8, cfg.vocab_size, seed=1),
                           policy, disc, False, profiler=LatencyProfiler())
            r["launches"] = {k: n - before[k] for k, n in
                             ops.launch_counts().items() if n - before[k]}
            runs.append(r)
        return runs

    runs = count_path(results, "serve_ssm", path)
    _log_runs(card, runs)
    for r in runs:
        k4 = r["launches"].get("ssd_scan", 0)
        log(f"  ssm {r['policy']} {r['discipline']}: ssd_scan launches "
            f"{k4} = {cfg.num_layers} x {r['prefill_passes']} prefill "
            f"passes; other kernels: "
            f"{ {k: n for k, n in r['launches'].items() if k != 'ssd_scan'} }")
        if r["completed"] != r["n"] or k4 != cfg.num_layers \
                * r["prefill_passes"] or set(r["launches"]) != {"ssd_scan"}:
            raise AssertionError(f"ssm run {r['policy']} {r['discipline']}: "
                                 f"{r}")
    ctx["ssm"] = runs
    ctx["ssm_prefill"] = long_prefill(cfg, params, results)
    del params
    torch.cuda.empty_cache()


def long_prefill(cfg, params, results, s=2048, runs=3, key="prefill"):
    """One prefill of an ``s``-token prompt at full depth (B1, into a
    dense cache, the LM head on the last position, as the engine
    prefills): the host clock around each synchronized pass, median of
    ``runs`` after one warm-up; the SSD scan's launches in one pass (one
    per SSM layer; a hybrid's attention layers launch the flash kernel
    once each, and nothing else launches), its device time at that shape
    (float32 x, B, C as the model hands it, CUDA-graph replays) and its
    share of the pass (launches x device time over the pass), stored
    under ``results["ssd_scan"][key]``."""
    import statistics
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models.cache import init_cache
    from repro_torch.models.model import forward_full
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                           device="cuda")

    def prefill():
        cache = init_cache(cfg, 1, s, device="cuda")
        with torch.inference_mode():
            logits, _, _ = forward_full(params, cfg, tokens=tokens,
                                        cache=cache, last_only=True)
        torch.cuda.synchronize()
        return logits

    logits = prefill()
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError("long prefill: non-finite logits")
    ops.reset_launch_counts()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        prefill()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    k4 = counts.get("ssd_scan", 0) // runs
    want = {k: runs * n for k, n in (("ssd_scan", len(cfg.ssm_layers)),
                                      ("flash_attention",
                                       len(cfg.attn_layers))) if n}
    if counts != want:
        raise AssertionError(f"long prefill: launches {counts} over {runs} "
                             f"passes, want {want}")
    nh, hd, ds = (cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim,
                  cfg.ssm.d_state)
    x, d, A, B, C, _ = ssd_inputs(1, s, torch.float32, False, gen, nh=nh,
                                  hd=hd, ds=ds)
    dev = graph_ms(lambda: ss.ssd_scan_cuda(x, d, A, B, C), 10)
    ms = statistics.median(times)
    out = {"model": cfg.name, "prompt": s, "batch": 1,
           "layers": cfg.num_layers, "prefill_ms": ms,
           "prefill_ms_runs": times, "launches_per_pass": {
               k: n // runs for k, n in counts.items()},
           "ssd_scan_launches": k4, "ssd_scan_device_ms": dev,
           "ssd_scan_share": k4 * dev / ms}
    results.setdefault("ssd_scan", {"name": "ssd_scan",
                                    **KERNELS["ssd_scan"]})[key] = out
    log(f"  {cfg.name} prefill B1 S{s} x {cfg.num_layers} layers: {ms:.2f} ms "
        f"(median of {runs}: {', '.join(f'{t:.2f}' for t in times)}); "
        f"ssd_scan {k4} launches x {dev:.4f} ms device = "
        f"{k4 * dev:.2f} ms, {100 * out['ssd_scan_share']:.1f}% of it")
    return out


# the hybrid's stream run: the stream phase's trace and pool; the count
# of requests may be cut for the time limit (printed with the run)
HYBRID_STREAM_N = STREAM_N
# the hybrid phase's batch serve runs at the first 12 of Zamba2's 38
# layers (10 Mamba2 blocks, the shared block twice; the mesh phase's
# cut), so that the script keeps inside its time limit (the whole stack
# until it ran past it); its long prefill stays at full depth
HYBRID_SERVE_LAYERS = 12


def phase_hybrid(ctx):
    """Zamba2-1.2B at its published config (38 layers: 32 Mamba2 blocks
    and six uses of one shared attention+MLP block, d 2048, bf16, random
    seeded weights): the parameter tree (one ``shared_block``, ``{}`` at
    the six attention layers); at ``HYBRID_SERVE_LAYERS`` a latency-model
    fit on the paged engine, then fcfs stall, ``slo-reanneal:jax`` stall
    and slo-preempt + chunked:32 on the paged engine and on the dense one
    (K1 or K6, K2 and K4 launch on each; K4 once per SSM layer per
    prefill pass); one
    timed full-depth B1 2048-token prefill; one ServeLoop run of the
    stream phase's trace on its pool (fcfs, paged); then cuda-vs-cpu
    parity at full width, 4 layers, float32."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.latency_model import PAPER_TABLE2
    from repro_torch.core.profiler import LatencyProfiler
    from repro_torch.data.synthetic import sample_serve_workload
    from repro_torch.data.traces import sample_trace_workload
    from repro_torch.engine.engine import Engine
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import fit_latency_model
    from repro_torch.models.config import ATTN
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServeLoop
    card, smi, results = ctx["card"], ctx["smi"], ctx["results"]
    cfg = get_config("zamba2-1.2b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    attn = [i for i, kind in enumerate(cfg.layer_pattern) if kind == ATTN]
    if any(params["layers"][i] for i in attn) or not all(
            params["layers"][i] for i in cfg.ssm_layers) or set(
            params["shared_block"]) != {"attn_norm", "mlp_norm", "attn",
                                        "mlp"}:
        raise AssertionError("zamba2: the parameter tree has no shared "
                             "block, or an attention layer holds weights")
    leaves = list(_leaves(params))
    n_ssm, n_attn = len(cfg.ssm_layers), len(attn)
    log(f"  {cfg.name}: {cfg.num_layers} layers ({n_ssm} Mamba2, {n_attn} "
        f"uses of one shared attention block at {attn}) d={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} ff="
        f"{cfg.d_ff} d_inner={cfg.ssm.d_inner(cfg.d_model)} ssm heads="
        f"{cfg.ssm.n_heads(cfg.d_model)}x{cfg.ssm.head_dim} d_state="
        f"{cfg.ssm.d_state} vocab={cfg.vocab_size} {cfg.dtype}: "
        f"{sum(t.numel() for t in leaves) / 1e9:.3f} B params, "
        f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.2f} GB "
        f"drawn in {time.perf_counter() - t0:.1f} s")
    policies = (("fcfs", "stall"), ("slo-reanneal:jax", "stall"),
                ("slo-preempt", "chunked:32"))
    model = None
    vcfg, vparams = _first_layers(cfg, params, HYBRID_SERVE_LAYERS)
    n_ssm = len(vcfg.ssm_layers)
    log(f"  hybrid serve runs at the first {vcfg.num_layers} of "
        f"{cfg.num_layers} layers ({n_ssm} Mamba2, "
        f"{vcfg.layer_pattern.count(ATTN)} uses of the shared block)")

    def serve(paged):
        nonlocal model
        if model is None:
            model = fit_latency_model(vcfg, vparams, 4,
                                      np.random.default_rng(0),
                                      device="cuda")
            if model == PAPER_TABLE2:
                raise AssertionError("the latency model fell back to the "
                                     "paper's V100 table instead of "
                                     "fitting this card")
            log(f"  latency model fit on {card} (paged): {model}")
        runs = []
        for policy, disc in policies:
            before = ops.launch_counts()
            r = _serve_run(vcfg, vparams, model,
                           sample_serve_workload(8, cfg.vocab_size, seed=1),
                           policy, disc, paged, profiler=LatencyProfiler())
            r["launches"] = {k: n - before.get(k, 0) for k, n in
                             ops.launch_counts().items()
                             if n - before.get(k, 0)}
            runs.append(r)
        return runs

    runs = []
    for paged, path in ((True, "serve_hybrid_paged"),
                        (False, "serve_hybrid_dense")):
        got = count_path(results, path, lambda: serve(paged))
        _log_runs(card, got)
        decode = "decode_attention_paged" if paged else "decode_attention"
        for r in got:
            k = r["launches"]
            log(f"  hybrid {r['layout']} {r['policy']} {r['discipline']}: "
                f"launches {k}; ssd_scan {k.get('ssd_scan', 0)} = {n_ssm} "
                f"x {r['prefill_passes']} prefill passes")
            # K2 runs whole prompts only: a chunked prefill attends
            # through the plain chunk path, as the reference's does
            if r["completed"] != r["n"] or k.get("ssd_scan", 0) != \
                    n_ssm * r["prefill_passes"] or k.get(decode, 0) <= 0:
                raise AssertionError(f"hybrid run {r['layout']} "
                                     f"{r['policy']} {r['discipline']}: {r}")
        runs += got
    prefill = long_prefill(cfg, params, results, key="prefill_hybrid")
    pairs = sample_trace_workload(HYBRID_STREAM_N, cfg.vocab_size,
                                  rate=STREAM_RATE, seed=1)
    scfg, sparams = _stream_cut(cfg, params)
    log(f"  hybrid stream: {HYBRID_STREAM_N} of the stream phase's "
        f"{STREAM_N} requests at {STREAM_RATE} req/s, pool {STREAM_SLOTS} "
        f"slots x {STREAM_SEQ} tokens, at {scfg.num_layers} of "
        f"{cfg.num_layers} layers ({scfg.layer_pattern.count('attn')} "
        "through the shared attention block)")
    stream = count_path(results, "serve_stream_hybrid", lambda: [
        _stream_run(lambda: ServeLoop(Engine(
            scfg, sparams, max_slots=STREAM_SLOTS, max_seq_len=STREAM_SEQ,
            device="cuda"), "fcfs", model=model), pairs,
            "zamba2 paged fcfs stall")])
    stream[0]["model"] = f"{cfg.name} at {scfg.num_layers} layers"
    _log_stream(card, smi, stream)
    widths = set(stream[0]["dispatch_widths"])
    if not widths or not widths <= {1 << k for k in range(
            STREAM_SLOTS.bit_length())} or stream[0]["overlap_frac"] <= 0:
        raise AssertionError(f"hybrid stream: widths {widths}, overlapped "
                             f"share {stream[0]['overlap_frac']}")
    del params, sparams, vparams
    torch.cuda.empty_cache()
    ctx["hybrid"] = {"serve": runs, "prefill": prefill, "stream": stream,
                     "parity": _hybrid_parity()}


# DeepSeek-V2-Lite's stream run: the stream phase's trace and pool
MOE_STREAM_N = STREAM_N
# the moe phase's DeepSeek batch serve runs at 7 of its 27 layers (layer
# 0 dense, 6 MoE), so that the script keeps inside its time limit (the
# whole stack until it ran past it); its long prefill and sync-free round
# stay at full depth
MOE_SERVE_LAYERS = 7
# DBRX (132B) at its published width: 4 of its 40 layers fit one card
DBRX_LAYERS = 4
MLA_FALLBACK = "falling back to whole-prompt (stalling) prefill"


def _mla_serve_runs(cfg, params, model, paged):
    """fcfs, ``slo-reanneal:jax`` and slo-preempt with ``chunked:32`` asked
    for, on one layout: the chunked run must warn and fall back to
    stalling prefill (MLA has no chunked path), the others must not."""
    import warnings
    from repro_torch.data.synthetic import sample_serve_workload
    from repro_torch.kernels import ops
    runs = []
    for policy, disc in (("fcfs", "stall"), ("slo-reanneal:jax", "stall"),
                         ("slo-preempt", "chunked:32")):
        before = ops.launch_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            r = _serve_run(cfg, params, model,
                           sample_serve_workload(8, cfg.vocab_size, seed=1),
                           policy, disc, paged)
        fell_back = any(MLA_FALLBACK in str(w.message) for w in caught)
        if fell_back != (disc != "stall"):
            raise AssertionError(f"{cfg.name} {policy} {disc}: stall "
                                 f"fall-back warned={fell_back}")
        r["launches"] = {k: n - before.get(k, 0) for k, n in
                         ops.launch_counts().items() if n - before.get(k, 0)}
        r["fell_back_to_stall"] = fell_back
        runs.append(r)
    return runs


def _moe_prefill(cfg, params, s=2048, runs=3):
    """One synchronized full-depth prefill of an ``s``-token prompt (B1,
    into a dense cache, the LM head on the last position): the host
    clock around each pass, median of ``runs`` after one warm-up; the
    grouped products a pass (three per MoE layer) and no hand-written
    kernel (MLA runs none)."""
    import statistics
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.cache import init_cache
    from repro_torch.models.model import forward_full
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                           device="cuda")

    def prefill():
        cache = init_cache(cfg, 1, s, device="cuda")
        with torch.inference_mode():
            logits, _, _ = forward_full(params, cfg, tokens=tokens,
                                        cache=cache, last_only=True)
        torch.cuda.synchronize()
        return logits

    if not bool(torch.isfinite(prefill().float()).all()):
        raise AssertionError("moe prefill: non-finite logits")
    ops.reset_launch_counts()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        prefill()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = {k: n // runs for k, n in ops.launch_counts().items() if n}
    n_moe = sum(1 for i in cfg.attn_layers if i not in cfg.moe.dense_layers)
    if counts != {"ragged_dot": 3 * n_moe}:
        raise AssertionError(f"moe prefill: launches a pass {counts}, want "
                             f"{3 * n_moe} grouped products only")
    ms = statistics.median(times)
    log(f"  {cfg.name} prefill B1 S{s} x {cfg.num_layers} layers: {ms:.2f} "
        f"ms (median of {runs}: {', '.join(f'{t:.2f}' for t in times)}); "
        f"launches a pass {counts}")
    return {"model": cfg.name, "prompt": s, "batch": 1,
            "layers": cfg.num_layers, "prefill_ms": ms,
            "prefill_ms_runs": times, "launches_per_pass": counts}


def _sync_free_round(cfg, params):
    """One ``dispatch_decode`` round of ``cfg`` (paged, width 2 of a
    4-slot pool, two requests prefilled and the width warmed first) under
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync on the
    round's path raises.  Returns its sampled ids on the host."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import sample_serve_workload
    from repro_torch.engine.engine import Engine
    from repro_torch.launch.serve import _to_rts
    eng = Engine(cfg, params, max_slots=4, max_seq_len=256, device="cuda")
    rts = _to_rts(sample_serve_workload(2, cfg.vocab_size, seed=4))
    for slot, rt in enumerate(rts):
        eng.begin_prefill(rt, slot)
        eng.prefill_step(rt)
    feed = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    for slot, rt in enumerate(rts):
        feed[slot, 0] = rt.generated[-1]
    active = np.array([True, True, False, False])
    eng.dispatch_decode(feed, active, width=2)         # warms width 2
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = eng.dispatch_decode(feed, active, width=2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    toks = toks.cpu().tolist()
    if len(toks) != 2 or not all(0 <= t < cfg.vocab_size for t in toks):
        raise AssertionError(f"sync-free round: tokens {toks}")
    log(f"  {cfg.name} dispatch_decode round (width 2) under sync debug "
        f"mode 'error': no host sync, tokens {toks}")
    return toks


def _ragged_check(results):
    """The grouped product (``torch._grouped_mm``) against its plain
    version (a product per expert over its rows, on the card) at the
    expert widths of DeepSeek-V2-Lite (64 experts, d 2048, ff 1408) and
    DBRX (16 experts, d 6144, ff 10752), gate/up and down shapes: rows
    routed top-k from random router probabilities at a decode round's
    batch (so some experts get no row), and every row given to one
    expert; bf16 and float32 within ``TOL``.  Timed (CUDA events, plain /
    grouped / grouped / plain) at DeepSeek's decode shape: 8 tokens x
    top-6 = 48 rows, gate/up product, beside its bound (the weights of
    the experts hit, x and the output each moved once)."""
    import torch
    from repro_torch.kernels import ragged_dot as rd
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rows = []
    timed = None
    for model, e, d, ff, k, t in (("deepseek-v2-lite-16b", 64, 2048, 1408,
                                   6, 8),
                                  ("dbrx-132b", 16, 6144, 10752, 4, 8)):
        for dn, dt in (("bfloat16", torch.bfloat16),
                       ("float32", torch.float32)):
            w_up = (torch.randn((e, d, ff), generator=gen, device="cuda")
                    * d ** -0.5).to(dt)
            w_down = (torch.randn((e, ff, d), generator=gen, device="cuda")
                      * ff ** -0.5).to(dt)
            probs = torch.rand((t, e), generator=gen, device="cuda")
            routed = torch.topk(probs, k, dim=-1).indices.reshape(-1)
            sizes = {"routed": (routed[:, None] == torch.arange(
                e, device="cuda")).sum(0, dtype=torch.int32),
                "one expert takes all": torch.zeros(
                    e, dtype=torch.int32, device="cuda")}
            sizes["one expert takes all"][e // 2] = t * k
            for label, gs in sizes.items():
                for shape, w, width in (("gate/up", w_up, d),
                                        ("down", w_down, ff)):
                    x = torch.randn((t * k, width), generator=gen,
                                    device="cuda").to(dt)
                    got = rd.ragged_dot_cuda(x, w, gs)
                    want = rd.ragged_dot_plain(x, w, gs)
                    err = (got.float() - want.float()).abs()
                    ok = bool((err <= TOL[dn] + TOL[dn]
                               * want.float().abs()).all())
                    empty = int((gs == 0).sum())
                    rows.append({"model": model, "dtype": dn, "case": label,
                                 "shape": shape, "rows": t * k,
                                 "experts_without_rows": empty,
                                 "max_abs_err": float(err.max())})
                    log(f"  ragged_dot {model} {shape:<7} {label:<20} {dn:<8}"
                        f" {t * k} rows over {e} experts ({empty} without "
                        f"rows) max_abs_err={float(err.max()):.3e} tol="
                        f"{TOL[dn]:g} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"ragged_dot {model} {shape} "
                                             f"{label} {dn} disagrees")
                    if (model, dn, label, shape) == (
                            "deepseek-v2-lite-16b", "bfloat16", "routed",
                            "gate/up"):
                        hit = e - empty
                        nbytes = (hit * d * ff + x.numel() + t * k * ff) \
                            * x.element_size()
                        b_ms, b_by = bound(nbytes, 2.0 * t * k * d * ff, dn)
                        ms, plain_ms = alternate(
                            lambda: rd.ragged_dot_plain(x, w, gs),
                            lambda: rd.ragged_dot_cuda(x, w, gs), 50)
                        timed = {"shape": f"{t} tokens x top-{k} = {t * k} "
                                 f"rows over {e} experts ({hit} hit), "
                                 f"{d} -> {ff}, bf16", "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": b_ms,
                                 "bound_by": b_by, "experts_hit": hit}
            del w_up, w_down
    torch.cuda.empty_cache()
    log(f"  ragged_dot at {timed['shape']}: grouped {timed['ms']:.4f} ms, "
        f"plain (a product per expert) {timed['plain_ms']:.4f} ms, bound "
        f"{timed['bound_ms']:.4f} ms ({timed['bound_by']})")
    results["ragged_dot"] = {"cases": rows, "timed": timed,
                             "max_abs_err": max(r["max_abs_err"]
                                                for r in rows)}


def _moe_model_summary(cfg, params, t0):
    import torch
    leaves = list(_leaves(params))
    n = sum(x.numel() for x in leaves)
    gb = sum(x.numel() * x.element_size() for x in leaves) / 1e9
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.num_layers} layers d={cfg.d_model} heads="
        f"{cfg.num_heads}/{cfg.num_kv_heads} "
        + (f"MLA rank {cfg.mla.kv_lora_rank} nope {cfg.mla.qk_nope_head_dim}"
           f" rope {cfg.mla.qk_rope_head_dim} v {cfg.mla.v_head_dim} "
           if cfg.mla is not None else f"hd={cfg.head_dim} ")
        + f"experts {cfg.moe.num_experts} top-{cfg.moe.top_k} ff "
        f"{cfg.moe.d_ff_expert} shared {cfg.moe.num_shared_experts} dense "
        f"layers {cfg.moe.dense_layers} vocab={cfg.vocab_size} {cfg.dtype}:"
        f" {n / 1e9:.3f} B params, {gb:.2f} GB drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"params_b": n / 1e9, "gb": gb}


def phase_moe(ctx):
    """MoE and MLA (ROADMAP M9) on the card.  DeepSeek-V2-Lite at its
    published config (27 layers, d 2048, MLA rank 512, 64 experts top-6
    + 2 shared, layer 0 dense at 10944, bf16, random seeded weights): at
    ``MOE_SERVE_LAYERS`` a latency-model fit on the paged engine, fcfs /
    ``slo-reanneal:jax`` /
    slo-preempt with ``chunked:32`` asked for (it must warn and stall)
    on the paged and on the dense engine; a timed full-depth B1
    2048-token prefill; one ServeLoop run of the stream phase's trace on
    its pool (paged fcfs); a ServeLoop asked for ``chunked:16`` must
    raise; one decode round under sync debug mode "error".  Then DBRX at
    its published width and 4 of its 40 layers (GQA group 6): paged fcfs
    and slo-preempt chunked:32 with the prefix cache, the multi-turn
    run, K1 and K2 launched.  The grouped product against its plain
    version; cuda-vs-cpu parity in float32 for both (DeepSeek 2 layers,
    DBRX 1)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.latency_model import PAPER_TABLE2
    from repro_torch.data.synthetic import (sample_multiturn_token_requests,
                                            sample_serve_workload)
    from repro_torch.data.traces import sample_trace_workload
    from repro_torch.engine.engine import Engine
    from repro_torch.launch.serve import fit_latency_model
    from repro_torch.models.model import init_params
    from repro_torch.serving import ServeLoop, UnsupportedDisciplineError
    card, smi, results = ctx["card"], ctx["smi"], ctx["results"]
    # every earlier phase's model off the card before DeepSeek's 31 GB
    # (the int8 phase draws Qwen2.5-7B again)
    ctx.pop("params", None)
    ctx.pop("cfg", None)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  moe phase on {smi}")
    out = {"seconds": {}}
    clock = [time.perf_counter()]

    def lap(step):
        now = time.perf_counter()
        out["seconds"][step] = now - clock[0]
        log(f"  moe phase: {step} took {now - clock[0]:.1f} s")
        clock[0] = now

    def fit(cfg, params):
        model = fit_latency_model(cfg, params, 4, np.random.default_rng(0),
                                  device="cuda")
        if model == PAPER_TABLE2:
            raise AssertionError("the latency model fell back to the "
                                 "paper's V100 table instead of fitting "
                                 "this card")
        log(f"  latency model fit on {card} ({cfg.name}, paged): {model}; "
            f"decode intercept {model.delta_d * 1e3:.2f} ms a round")
        return model

    cfg = get_config("deepseek-v2-lite-16b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    out["deepseek"] = _moe_model_summary(cfg, params, t0)
    blocks = params["layers"]
    if "mlp" not in blocks[0] or blocks[0]["mlp"]["w_gate"].shape[1] != \
            cfg.moe.d_ff_dense or not all(
            "moe" in b and b["moe"]["router"].dtype == torch.float32
            and b["moe"]["shared"]["w_gate"].shape[1]
            == cfg.moe.d_ff_expert * cfg.moe.num_shared_experts
            for b in blocks[1:]):
        raise AssertionError("deepseek: layer 0 is not the dense FFN, or a "
                             "later layer is not MoE with its shared "
                             "experts and a float32 router")
    vcfg, vparams = _first_layers(cfg, params, MOE_SERVE_LAYERS)
    log(f"  deepseek serve runs at {vcfg.num_layers} of {cfg.num_layers} "
        "layers")
    model = fit(vcfg, vparams)
    lap("deepseek draw + fit")
    runs = []
    for paged, path in ((True, "serve_mla_paged"),
                        (False, "serve_mla_dense")):
        got = count_path(results, path,
                         lambda: _mla_serve_runs(vcfg, vparams, model, paged))
        _log_runs(card, got)
        for r in got:
            k = r["launches"]
            log(f"  deepseek {r['layout']} {r['policy']} {r['discipline']}"
                f" (fell back to stall: {r['fell_back_to_stall']}): "
                f"launches {k}")
            if r["completed"] != r["n"] or set(k) - {"ragged_dot",
                                                     "anneal"}:
                raise AssertionError(f"deepseek run {r['layout']} "
                                     f"{r['policy']} {r['discipline']}: {r}")
        runs += got
        lap(f"deepseek {path}")
    out["deepseek_serve"] = runs
    out["deepseek_prefill"] = _moe_prefill(cfg, params)
    try:
        ServeLoop(Engine(cfg, params, max_slots=4, max_seq_len=256,
                         device="cuda"), "fcfs", model=model,
                  discipline="chunked:16")
    except UnsupportedDisciplineError as e:
        log(f"  ServeLoop(deepseek, chunked:16) refused: {e}")
    else:
        raise AssertionError("ServeLoop took chunked:16 on an MLA arch")
    out["sync_free_round"] = _sync_free_round(cfg, params)
    lap("deepseek prefill, chunked refusal, sync-free round")
    pairs = sample_trace_workload(MOE_STREAM_N, cfg.vocab_size,
                                  rate=STREAM_RATE, seed=1)
    scfg, sparams = _stream_cut(cfg, params)
    log(f"  deepseek stream: {MOE_STREAM_N} of the stream phase's "
        f"{STREAM_N} requests at {STREAM_RATE} req/s, pool {STREAM_SLOTS} "
        f"slots x {STREAM_SEQ} tokens, at {scfg.num_layers} of "
        f"{cfg.num_layers} layers")
    stream = count_path(results, "serve_stream_mla", lambda: [
        _stream_run(lambda: ServeLoop(Engine(
            scfg, sparams, max_slots=STREAM_SLOTS, max_seq_len=STREAM_SEQ,
            device="cuda"), "fcfs", model=model), pairs,
            "deepseek paged fcfs stall")])
    stream[0]["model"] = f"{cfg.name} at {scfg.num_layers} layers"
    _log_stream(card, smi, stream)
    out["deepseek_stream"] = stream
    lap("deepseek stream")
    del params, sparams, vparams, blocks
    gc.collect()
    torch.cuda.empty_cache()

    dcfg = dataclasses.replace(get_config("dbrx-132b"),
                               num_layers=DBRX_LAYERS, layer_pattern=())
    t0 = time.perf_counter()
    dparams = init_params(dcfg, seed=0, device="cuda")
    out["dbrx"] = _moe_model_summary(dcfg, dparams, t0)
    dmodel = fit(dcfg, dparams)

    def dbrx_path():
        got = [_serve_run(dcfg, dparams, dmodel,
                          sample_serve_workload(8, dcfg.vocab_size, seed=1),
                          policy, disc, True)
               for policy, disc in (("fcfs", "stall"),
                                    ("slo-preempt", "chunked:32"))]
        got.append(_serve_run(dcfg, dparams, dmodel,
                              sample_multiturn_token_requests(
                                  2, turns=3, vocab=dcfg.vocab_size),
                              "fcfs", "stall", True))
        got[-1]["workload"] = "multiturn"
        return got

    got = count_path(results, "serve_moe_gqa", dbrx_path)
    _log_runs(card, got)
    if any(r["completed"] != r["n"] for r in got) or \
            got[-1]["prefix_hit_rate"] <= 0:
        raise AssertionError(f"dbrx runs: {got}")
    out["dbrx_serve"] = got
    del dparams
    gc.collect()
    torch.cuda.empty_cache()
    lap("dbrx draw, fit and runs")
    _ragged_check(results)
    out["ragged_dot"] = results["ragged_dot"]
    lap("ragged product check")
    out["parity"] = _moe_parity()
    lap("parity")
    ctx["moe"] = out
    log("  moe summary: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("deepseek_serve",
                                                   "dbrx_serve",
                                                   "deepseek_stream")}))


def _moe_parity():
    """DeepSeek-V2-Lite (2 layers: layer 0 dense, layer 1 MoE) and DBRX
    (1 MoE layer) at full width, float32, under fcfs (an MLA arch
    serves every discipline stalling): identical greedy tokens, cuda vs
    cpu, and logits within 1e-4 of max |logit| (``_recurrent_parity``),
    DeepSeek on both layouts, DBRX on the paged one (its GQA layout,
    the one it serves on) with 2 requests: its float32 experts are 12.7
    GB a layer and copy, and the cpu side reads them every round (both
    layouts at 2 layers took 73 s against DeepSeek's 17 s, the paged one
    32 s, on the host of an H100 machine; 2 layers until the script ran
    past its time limit)."""
    from repro_torch.configs import get_config
    out = {}
    for arch, layers, layouts, n in (
            ("deepseek-v2-lite-16b", 2, ("paged", "dense"), 4),
            ("dbrx-132b", 1, ("paged",), 2)):
        t0 = time.perf_counter()
        out[arch] = _recurrent_parity(dataclasses.replace(
            get_config(arch), num_layers=layers, layer_pattern=(),
            dtype="float32"), layouts, policies=(("fcfs", "stall"),),
            n_requests=n)
        out[arch]["seconds"] = time.perf_counter() - t0
        log(f"  parity {arch}: {out[arch]['seconds']:.1f} s")
    return out


def _decode_run(cfg, params, prompt, steps, quantized, layout,
                tokens=None, step_ms=None):
    """Prefill ``prompt`` then ``steps`` decode steps through a paged or
    a dense cache (int8 when ``quantized``).  Decode inputs are
    ``tokens`` when given (teacher forcing), else greedy.  With a list
    ``step_ms``, appends the host time of each decode step, synchronized
    before and after.  Returns (logits [steps+1, V] float32 on the CPU,
    greedy tokens)."""
    import torch
    from repro_torch.models.cache import init_cache, init_paged_cache
    from repro_torch.models.model import (forward_decode,
                                          forward_decode_paged,
                                          forward_full, forward_prefill_paged)
    dev = params["embed"].device
    n = prompt.shape[1]
    if layout == "paged":
        cache = init_paged_cache(cfg, 1, 256, 17, PAGE, quantized=quantized,
                                 device=dev)
        cache["block_tables"][0] = torch.arange(1, 17, dtype=torch.int32)
        last, cache = forward_prefill_paged(params, cfg, tokens=prompt,
                                            cache=cache, slot=0, length=n)
        step = forward_decode_paged
    else:
        cache = init_cache(cfg, 1, 256, quantized=quantized, device=dev)
        lg, cache, _ = forward_full(params, cfg, tokens=prompt, cache=cache,
                                    last_only=True)
        last = lg[0, -1]
        step = forward_decode
    rows = [last.float()]
    greedy = []
    for i in range(steps):
        greedy.append(int(torch.argmax(rows[-1])))
        nxt = greedy[-1] if tokens is None else tokens[i]
        tok = torch.tensor([[nxt]], dtype=torch.int32, device=dev)
        if step_ms is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        lg, cache = step(params, cfg, tokens=tok, cache=cache)
        if step_ms is not None:
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        rows.append(lg[0, -1].float())
    return torch.stack(rows).cpu(), greedy


def phase_int8(ctx):
    """int8 KV at full width: K3 (paged) and K7 (dense) on the path, each
    held against the same run on a bf16 cache fed the same tokens; the
    synchronized host time of a decode step (median of the 32) on each
    cache."""
    import statistics
    import torch
    cfg, params = full_model(ctx)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen,
                           device="cuda", dtype=torch.int32)
    steps = 32
    layouts = ("paged", "dense")
    step_ms = {(layout, kv): [] for layout in layouts
               for kv in ("bf16", "int8")}
    with torch.no_grad():
        ref = {layout: _decode_run(cfg, params, prompt, steps, False, layout,
                                   step_ms=step_ms[layout, "bf16"])
               for layout in layouts}
        q8 = count_path(ctx["results"], "int8", lambda: {
            layout: _decode_run(cfg, params, prompt, steps, True, layout,
                                tokens=ref[layout][1],
                                step_ms=step_ms[layout, "int8"])
            for layout in layouts})
    report = {}
    for layout in ("paged", "dense"):
        want, got = ref[layout][0], q8[layout][0]
        if not torch.isfinite(got).all():
            raise AssertionError(f"int8 {layout}: non-finite logits")
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        ms = {kv: statistics.median(step_ms[layout, kv])
              for kv in ("bf16", "int8")}
        report[layout] = {"max_abs_logit_diff": diff,
                          "max_abs_logit": scale, "top1_agreement": agree,
                          "step_ms_bf16": ms["bf16"],
                          "step_ms_int8": ms["int8"]}
        log(f"  int8 {layout:<5} {cfg.name} 128-token prompt + {steps} "
            f"decode steps vs bf16 cache: max |logit diff|={diff:.4f} "
            f"(max |logit| {scale:.3f}), top-1 agreement={agree:.3f}")
        log(f"  int8 {layout:<5} {cfg.name} decode step, host time "
            f"synchronized (median of {steps}): int8 cache "
            f"{ms['int8']:.3f} ms, bf16 cache {ms['bf16']:.3f} ms")
    ctx["int8"] = report


def _attn_grads_ok(grads):
    """Every leaf's gradient finite, and wq/wk/wv/wo of every layer not
    all zero: the check that attention passed its gradient back."""
    import torch
    from repro_torch.train.optimizer import leaves
    for i, g in enumerate(leaves(grads)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"gradient leaf {i} is not finite")
    zero = [f"layer {i} {n}" for i, layer in enumerate(grads["layers"])
            for n in ("wq", "wk", "wv", "wo")
            if not bool(layer["attn"][n].abs().max() > 0)]
    if zero:
        raise AssertionError(f"all-zero attention gradients: {zero}")
    log(f"  first step: every gradient finite; wq/wk/wv/wo nonzero in all "
        f"{len(grads['layers'])} layers")


def phase_train(ctx):
    """Qwen3-1.7B at its published config, bf16, trained on the card as
    the launcher trains (token_stream batches, labels = tokens)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models.model import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import loss_and_grads, train_step
    B, S, STEPS = 4, 2048, 5
    cfg = get_config("qwen3-1.7b")
    ctx.pop("params", None)                # the serve model's 15 GB
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device="cuda")
    n = sum(t.numel() for t in opt.leaves(params))
    log(f"  {cfg.name}: {cfg.num_layers} layers d={cfg.d_model} "
        f"heads={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
        f"vocab={cfg.vocab_size} {cfg.dtype}: {n / 1e9:.3f} B params; "
        f"B={B} S={S}, AdamW lr 3e-4, remat per layer")
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=max((STEPS + 1) // 10, 1))
    state = opt.init(params)

    def batch(step):
        toks = torch.from_numpy(token_stream(S, cfg.vocab_size, seed=step,
                                             batch=B)).cuda()
        return {"tokens": toks, "labels": toks}

    # warm-up step, off the clock: train_step's two halves, so the
    # gradients can be checked
    t = time.perf_counter()
    loss, _, grads = loss_and_grads(cfg, params, batch(0))
    _attn_grads_ok(grads)
    opt.apply(ocfg, params, grads, state)
    del grads
    losses = [float(loss)]
    torch.cuda.synchronize()
    log(f"  step 0 (warm-up) loss {losses[0]:.4f} "
        f"{(time.perf_counter() - t) * 1e3:.1f} ms")

    def timed():
        out = []
        for step in range(1, STEPS + 1):
            b = batch(step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, m = train_step(cfg, ocfg, params, state, b)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            out.append({"step": step, "loss": loss, "ms": ms,
                        "tok_per_s": B * S / ms * 1e3,
                        "grad_norm": float(m["grad_norm"]),
                        "lr": float(m["lr"])})
            log(f"  step {step} loss {loss:.4f} {ms:.1f} ms "
                f"{out[-1]['tok_per_s']:.0f} tokens/s "
                f"grad_norm {out[-1]['grad_norm']:.3f}")
        return out

    rows = count_path(ctx["results"], "train", timed)
    launches = ctx["results"].get("flash_attention", {}).get(
        "launches_by_path", {}).get("train", 0)
    if launches:
        raise AssertionError(f"the forward-only flash kernel launched "
                             f"{launches} times on the train path")
    per_step = {k: ctx["results"][k]["launches_by_path"]["train"] / STEPS
                for k in TRAIN_KERNELS}
    losses += [r["loss"] for r in rows]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = sorted(r["ms"] for r in rows)
    report = {"model": cfg.name, "batch": B, "seq": S, "steps": rows,
              "warmup_loss": losses[0], "median_ms": ms[len(ms) // 2],
              "median_tok_per_s": B * S / ms[len(ms) // 2] * 1e3,
              "peak_gib": peak, "launches_per_step": per_step}
    log(f"  train {cfg.name}: losses {[round(x, 4) for x in losses]}, "
        f"median {report['median_ms']:.1f} ms/step "
        f"({report['median_tok_per_s']:.0f} tokens/s), peak "
        f"max_memory_allocated {peak:.2f} GiB, launches per step "
        f"{per_step} (forward-only flash: 0)")
    log("  train run: " + json.dumps(report))
    del params, state
    torch.cuda.empty_cache()
    ctx["train_archs"] = [_train_arch(ctx, *spec) for spec in TRAIN_ARCHS]


# (arch, layers kept (None: all), B, S, launch path): every arch the JAX
# launcher trains beyond the dense decoders, at published width, as the
# launcher draws its batches (launch/train.py make_batch).  Qwen2-VL runs
# float32 end to end (float32 embeds through bf16 weights, as in JAX), so
# one sequence; DeepSeek at 4 of 27 layers is layer 0 dense and three
# MoE layers
TRAIN_ARCHS = (("mamba2-780m", None, 4, 2048, "train_ssm"),
               ("zamba2-1.2b", None, 4, 2048, "train_hybrid"),
               ("musicgen-medium", None, 4, 2048, "train_audio"),
               ("qwen2-vl-7b", 4, 1, 2048, "train_vlm"),
               ("deepseek-v2-lite-16b", 4, 2, 2048, "train_moe"))
TRAIN_ARCH_STEPS = 3


def _depth(cfg, layers):
    """``cfg`` at its first ``layers`` layers (its own pattern cut)."""
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, num_layers=layers,
                               layer_pattern=cfg.layer_pattern[:layers])


def _launches_per_step(cfg):
    """What the layer count predicts a remat train step launches: the
    SSD scan twice per SSM layer (forward and re-forward) and its
    backward once; the flash forward + lse twice per GQA attention layer
    (an MLA layer attends in plain PyTorch, as in JAX), dq and dk/dv
    once; three grouped products per MoE layer, twice (their backward is
    PyTorch's own, not counted); the forward-only flash kernel never."""
    from repro_torch.models.config import SSM
    n_ssm = sum(k == SSM for k in cfg.layer_pattern)
    n_attn = 0 if cfg.mla is not None else len(cfg.attn_layers)
    n_moe = 0 if cfg.moe is None else sum(
        1 for i in cfg.attn_layers if i not in cfg.moe.dense_layers)
    return {"ssd_scan": 2 * n_ssm, "ssd_scan_bwd": n_ssm,
            "flash_attention_fwd_lse": 2 * n_attn,
            "flash_attention_dq": n_attn, "flash_attention_dkv": n_attn,
            "ragged_dot": 6 * n_moe, "flash_attention": 0}


def _grads_reach(cfg, grads):
    """Every gradient leaf finite, and nonzero where the loss reaches it
    (all but a VLM's token table under an embeds batch); an MoE layer's
    expert weights nonzero in every expert slice (at 4096 tokens x top-6
    of 64 experts every expert is hit).  -> the names checked."""
    import torch
    names = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{path}[{i}]")
        else:
            if not bool(torch.isfinite(tree).all()):
                raise AssertionError(f"{path}: gradient not finite")
            if cfg.uses_extra_embeds and path == "embed":
                return
            flat = tree.reshape(tree.shape[0], -1) if ".moe.w_" in path \
                else tree.reshape(1, -1)
            zero = (flat.abs().amax(dim=1) == 0).nonzero().flatten()
            if zero.numel():
                raise AssertionError(f"{path}: all-zero gradient (slices "
                                     f"{zero.tolist()[:8]})")
            names.append(path)
    walk(grads, "")
    return names


def _train_arch(ctx, arch, layers, B, S, path):
    """One arch of TRAIN_ARCHS trained on the card: random seeded weights
    in its published dtype, AdamW lr 3e-4, per-layer remat; one warm-up
    step (gradients checked: finite, nonzero where reached; DeepSeek's
    loss_and_grads under sync debug mode "error"), then TRAIN_ARCH_STEPS
    timed steps on the ``path`` launch counts, checked against
    :func:`_launches_per_step`."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_batch
    from repro_torch.models.model import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import loss_and_grads, train_step
    cfg = _depth(get_config(arch), layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    n = sum(t.numel() for t in opt.leaves(params))
    log(f"  {cfg.name}: {cfg.num_layers} of {get_config(arch).num_layers} "
        f"layers d={cfg.d_model} {cfg.dtype}: {n / 1e9:.3f} B params; "
        f"B={B} S={S}, AdamW lr 3e-4, remat per layer")
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=1)
    state = opt.init(params)
    rng = np.random.default_rng(0)

    def batch(step):
        return {k: torch.from_numpy(v).cuda()
                for k, v in make_batch(cfg, B, S, step, rng).items()}

    b0 = batch(0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    sync_free = cfg.moe is not None
    if sync_free:
        torch.cuda.set_sync_debug_mode("error")
    try:
        loss, _, grads = loss_and_grads(cfg, params, b0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    reached = _grads_reach(cfg, grads)
    opt.apply(ocfg, params, grads, state)
    del grads
    losses = [float(loss)]
    torch.cuda.synchronize()
    log(f"  step 0 (warm-up) loss {losses[0]:.4f} "
        f"{(time.perf_counter() - t) * 1e3:.1f} ms; {len(reached)} "
        f"gradient leaves finite and nonzero"
        + (" (no host sync in loss_and_grads: sync debug mode 'error')"
           if sync_free else ""))

    def timed():
        out = []
        for step in range(1, TRAIN_ARCH_STEPS + 1):
            bb = batch(step)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, _, m = train_step(cfg, ocfg, params, state, bb)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            out.append({"step": step, "loss": loss,
                        "ms": (time.perf_counter() - t1) * 1e3})
        return out

    rows = count_path(ctx["results"], path, timed)
    from repro_torch.kernels import ops
    got = {k: v / TRAIN_ARCH_STEPS for k, v in ops.launch_counts().items()}
    want = _launches_per_step(cfg)
    losses += [r["loss"] for r in rows]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = sorted(r["ms"] for r in rows)[len(rows) // 2]
    report = {"model": cfg.name, "layers": cfg.num_layers, "batch": B,
              "seq": S, "dtype": cfg.dtype, "params_b": n / 1e9,
              "losses": losses, "median_ms": ms,
              "tok_per_s": B * S / ms * 1e3, "peak_gib": peak,
              "launches_per_step": {k: v for k, v in got.items() if v},
              "predicted": {k: v for k, v in want.items() if v},
              "card": ctx["smi"], "seconds": time.perf_counter() - t0}
    log(f"  train {cfg.name} ({ctx['smi']}): losses "
        f"{[round(x, 4) for x in losses]}, median {ms:.1f} ms/step "
        f"({report['tok_per_s']:.0f} tokens/s), peak max_memory_allocated "
        f"{peak:.2f} GiB, launches per step {report['launches_per_step']} "
        f"(predicted {report['predicted']})")
    log("  train run: " + json.dumps(report))
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{cfg.name}: non-finite loss {losses}")
    bad = {k: (got.get(k, 0), v) for k, v in want.items()
           if got.get(k, 0) != v}
    if bad:
        raise AssertionError(f"{cfg.name}: launches per step (got, "
                             f"predicted) {bad}")
    del params, state
    torch.cuda.empty_cache()
    return report


def phase_parity(ctx):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import sample_serve_workload
    from repro_torch.engine.engine import Engine
    from repro_torch.launch.serve import _to_rts
    from repro_torch.models.cache import init_paged_cache
    from repro_torch.models.model import (forward_decode_paged,
                                          forward_prefill_paged, init_params)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen2.5-7b"), num_layers=2,
                              layer_pattern=(), dtype="float32")
    p_gpu = init_params(cfg, seed=1, device="cuda")
    p_cpu = _map(p_gpu, lambda t: t.cpu())
    for paged in (True, False):
        tokens = {}
        for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            pairs = sample_serve_workload(4, cfg.vocab_size, seed=2)
            rts = _to_rts(pairs)
            for rt in rts:
                rt.max_new_tokens = 8
            eng = Engine(cfg, params, max_slots=4, max_seq_len=256,
                         paged=paged, device=dev)
            out = eng.run_fcfs(rts)
            tokens[dev] = {k: v["tokens"] for k, v in out.items()}
        same = tokens["cuda"] == tokens["cpu"]
        layout = "paged" if paged else "dense"
        log(f"  parity {cfg.name} x2 layers f32 {layout} engine: tokens "
            f"identical={same} "
            f"({sum(len(v) for v in tokens['cuda'].values())} tokens)")
        if not same:
            raise AssertionError(f"{layout} engine: cuda vs cpu tokens "
                                 f"differ: {tokens}")
    _stream_parity(cfg, p_gpu, p_cpu)
    # logits of one prefill (padded to a 128 bucket) and one decode step
    logits = {}
    r, prompt = sample_serve_workload(1, cfg.vocab_size, seed=3)[0]
    n = len(prompt)
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        cache = init_paged_cache(cfg, 1, 256, 17, 16, device=dev)
        cache["block_tables"][0] = torch.arange(1, 17, dtype=torch.int32)
        toks = torch.zeros((1, 128), dtype=torch.int32)
        toks[0, :n] = torch.from_numpy(prompt)
        lp, cache = forward_prefill_paged(params, cfg, tokens=toks.to(dev),
                                          cache=cache, slot=0, length=n)
        nxt = torch.argmax(lp).reshape(1, 1).to(torch.int32)
        ld, _ = forward_decode_paged(params, cfg, tokens=nxt.to(dev),
                                     cache=cache)
        logits[dev] = (lp.cpu(), ld.cpu())
    d_pre = float((logits["cuda"][0] - logits["cpu"][0]).abs().max())
    d_dec = float((logits["cuda"][1] - logits["cpu"][1]).abs().max())
    log(f"  parity {cfg.name} x2 layers f32: max |logit diff| "
        f"prefill={d_pre:.3e} decode={d_dec:.3e}")
    # int8 caches: 8 greedy decode steps (cuda's tokens fed to both)
    prompt_t = torch.from_numpy(prompt[None]).to(torch.int32)
    for layout in ("paged", "dense"):
        with torch.no_grad():
            g, toks = _decode_run(cfg, p_gpu, prompt_t.cuda(), 8, True,
                                  layout)
            c, _ = _decode_run(cfg, p_cpu, prompt_t, 8, True, layout,
                               tokens=toks)
        diff = float((g - c).abs().max())
        scale = float(c.abs().max())
        agree = float((g.argmax(-1) == c.argmax(-1)).float().mean())
        # the reference's own int8 bound (tests/test_arch_smoke.py):
        # 5% of the logit scale; cuda and cpu round f32 matmuls apart, so
        # a K/V value on a rounding tie may quantize one int8 step apart
        limit = 0.05 * max(scale, 1.0)
        log(f"  parity {cfg.name} x2 layers f32 int8 {layout}: prefill + "
            f"8 decode steps, max |logit diff| cuda vs cpu={diff:.3e} "
            f"(limit {limit:.3e}), top-1 agreement={agree:.3f}")
        if not diff <= limit:
            raise AssertionError(f"int8 {layout}: cuda vs cpu logits "
                                 f"differ by {diff} > {limit}")
    _train_parity()
    _ssm_parity()


def _stream_parity(cfg, p_gpu, p_cpu):
    """The ServeLoop's greedy tokens per request at 2 layers in float32,
    TF32 off, on both layouts: identical on cuda (kernels, the readback
    behind a pinned copy and an event) and cpu (plain versions), and
    between the overlapped and the synchronous loop."""
    from repro_torch.data.synthetic import sample_serve_workload
    from repro_torch.engine.engine import Engine
    from repro_torch.serving import ServeLoop
    for paged in (True, False):
        got = {}
        for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            for overlap in (True, False):
                pairs = sample_serve_workload(4, cfg.vocab_size, seed=2)
                for r, _ in pairs:
                    r.output_len = 8
                lp = ServeLoop(Engine(cfg, params, max_slots=4,
                                      max_seq_len=256, paged=paged,
                                      device=dev), "fcfs", overlap=overlap)
                lp.start(warm_lengths=[len(p) for _, p in pairs])
                streams = lp.submit_trace(pairs)
                lp.serve()
                got[dev, overlap] = [st.tokens for st in streams]
        ref = got["cuda", True]
        same = all(v == ref for v in got.values()) and \
            all(len(t) == 8 for t in ref)
        layout = "paged" if paged else "dense"
        log(f"  parity {cfg.name} x2 layers f32 {layout} ServeLoop: tokens "
            f"identical cuda/cpu x overlap/sync={same} "
            f"({sum(len(t) for t in ref)} tokens each)")
        if not same:
            raise AssertionError(f"{layout} ServeLoop tokens differ: {got}")


def _ssm_parity():
    """Mamba2-780M at full width, 2 layers (its dense engine)."""
    from repro_torch.configs import get_config
    _recurrent_parity(dataclasses.replace(
        get_config("mamba2-780m"), num_layers=2, layer_pattern=(),
        dtype="float32"), ("dense",))


def _hybrid_parity():
    """Zamba2-1.2B at full width, 4 layers (SSM, ATTN, SSM, ATTN: the
    shared block used twice), on both layouts."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import ATTN, SSM
    return _recurrent_parity(dataclasses.replace(
        get_config("zamba2-1.2b"), num_layers=4,
        layer_pattern=(SSM, ATTN, SSM, ATTN), dtype="float32"),
        ("paged", "dense"))


def _recurrent_parity(cfg, layouts, policies=(("fcfs", "stall"),
                                               ("slo-preempt", "chunked:32")),
                      n_requests=4):
    """``cfg`` (float32, TF32 off) on cuda (the kernels) and on cpu (their
    plain versions), on each of ``layouts``: the engine's greedy tokens
    per request (``n_requests`` of 8 tokens) must be identical under
    ``policies`` (by default fcfs and slo-preempt + chunked:32; the
    paper's table as latency model on both, so the two devices plan
    alike), and the logits of one prefill and 4 decode
    steps (cuda's greedy tokens fed to both) must agree within 1e-4 of
    max |cpu logit|: f32 sums in other orders (the SSD scan's own bound
    against plain is 5e-5 of max |plain|; the matmuls around it and the
    other layers add their own order).  Returns the logit differences
    per layout."""
    import torch
    from repro_torch.core.latency_model import PAPER_TABLE2
    from repro_torch.core.policies import make
    from repro_torch.data.synthetic import sample_serve_workload
    from repro_torch.engine.engine import Engine
    from repro_torch.launch.serve import _to_rts
    from repro_torch.models.model import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p_gpu = init_params(cfg, seed=1, device="cuda")
    p_cpu = _map(p_gpu, lambda t: t.cpu())
    what = f"{cfg.name} x{cfg.num_layers} layers f32"
    report = {}
    for layout in layouts:
        for policy, disc in policies:
            tokens = {}
            for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
                rts = _to_rts(sample_serve_workload(n_requests,
                                                    cfg.vocab_size, seed=2))
                for rt in rts:
                    rt.max_new_tokens = 8
                eng = Engine(cfg, params, max_slots=4, max_seq_len=256,
                             paged=layout == "paged", device=dev)
                out = eng.run_policy(rts, make(policy, model=PAPER_TABLE2,
                                               max_batch=4), discipline=disc)
                tokens[dev] = {k: v["tokens"] for k, v in out.items()}
            same = tokens["cuda"] == tokens["cpu"]
            log(f"  parity {what} {layout} engine {policy} {disc}: tokens "
                f"identical={same} "
                f"({sum(len(v) for v in tokens['cuda'].values())} tokens)")
            if not same:
                raise AssertionError(f"{what} {layout} {policy} {disc}: cuda "
                                     f"vs cpu tokens differ: {tokens}")
        _, prompt = sample_serve_workload(1, cfg.vocab_size, seed=3)[0]
        prompt = torch.from_numpy(prompt[None]).to(torch.int32)
        with torch.no_grad():
            g, toks = _decode_run(cfg, p_gpu, prompt.cuda(), 4, False, layout)
            c, _ = _decode_run(cfg, p_cpu, prompt, 4, False, layout,
                               tokens=toks)
        diffs = (g - c).abs().amax(-1)
        scale = float(c.abs().max())
        limit = 1e-4 * max(scale, 1.0)
        log(f"  parity {what} {layout}: {prompt.shape[1]}-token prefill + 4 "
            f"decode steps, max |logit diff| cuda vs cpu per step "
            f"{[f'{float(d):.3e}' for d in diffs]} (max |logit| {scale:.3f}, "
            f"limit {limit:.3e})")
        if not float(diffs.max()) <= limit:
            raise AssertionError(f"{what} {layout} logits: cuda vs cpu "
                                 f"differ by {float(diffs.max())} > {limit}")
        report[layout] = {"max_abs_logit_diff": float(diffs.max()),
                          "max_abs_logit": scale}
    return report


# (arch, its 2-layer pattern (None: the arch's own first two)) for the
# train parity: the dense decoder, then every arch the JAX launcher trains
# beyond it, at published width, but Qwen2-VL and DeepSeek-V2-Lite, to
# keep the script inside its time limit (their cpu steps over 1.55 B and
# 1.1 B float32 params took 25-33 and 18-27 s; Qwen2-VL's K5a-c instance,
# float32 at group 7, is held in the kernels phase, and DeepSeek's mesh
# steps against its single-rank step in the train_mesh phase)
TRAIN_PARITY = (("qwen3-1.7b", None), ("mamba2-780m", None),
                ("zamba2-1.2b", ("ssm", "attn")),
                ("musicgen-medium", None))


def _train_parity():
    """One train step of each TRAIN_PARITY arch at full width, 2 layers,
    float32, TF32 off, on cuda (kernels) and on cpu (plain versions)
    from the same params and batch (B2 S64, drawn as the launcher draws
    it: [B, S, 4] tokens for MusicGen).  Bounds, stated
    before the first measurement: loss within 1e-5 of its value (f32
    matmuls summed in other orders); each gradient within 1e-4 of its
    leaf's max |cpu gradient| (the attention and SSD kernels' own f32
    bound is 5e-5, downstream sums add their own order); updated params
    within 1e-6 in every leaf but at most max(8, 1e-3 numel) of its
    elements, and within 2 lr everywhere: the first AdamW step moves an
    element by lr·g/(|g|+eps), a sign for all but the smallest gradients,
    so an element whose gradient is within rounding of 0 may move the
    other way.  The count is per leaf, so a leaf updated wrongly as a
    whole fails, a norm scale's included."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_batch
    from repro_torch.models.model import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import loss_and_grads
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=1)
    lr = ocfg.lr
    for arch, pattern in TRAIN_PARITY:
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(
            full, num_layers=2, dtype="float32",
            layer_pattern=pattern or full.layer_pattern[:2])
        p_gpu = init_params(cfg, seed=3, device="cuda")
        p_cpu = _map(p_gpu, lambda t: t.cpu())
        batch = make_batch(cfg, 2, 64, 0, np.random.default_rng(5))
        out, secs = {}, {}
        for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            t = time.perf_counter()
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            loss, _, grads = loss_and_grads(cfg, params, b)
            opt.apply(ocfg, params, grads, opt.init(params))
            out[dev] = (float(loss), list(opt.leaves(grads)),
                        list(opt.leaves(params)))
            secs[dev] = time.perf_counter() - t
        del p_gpu, p_cpu, grads, params
        (lg, gg, pg), (lc, gc, pc) = out["cuda"], out["cpu"]
        # compared on the card, one cpu leaf moved there at a time (the
        # same exact differences, maxima and counts as on the host)
        t = time.perf_counter()
        g_worst, p_max, counts = 0.0, 0.0, []
        for a, c in zip(gg, gc):
            c = c.cuda()
            g_worst = max(g_worst, float((a - c).abs().max())
                          / max(float(c.abs().max()), 1e-30))
        for a, c in zip(pg, pc):
            c = c.cuda()
            d = (a - c).abs()
            p_max = max(p_max, float(d.max()))
            # (elements beyond 1e-6, allowed, numel) per leaf
            counts.append((int((d > 1e-6).sum()),
                           max(8, int(1e-3 * c.numel())), c.numel()))
        secs["compare"] = time.perf_counter() - t
        n, lim, numel = max(counts, key=lambda t: t[0] / t[1])
        del out, gg, gc, pg, pc, a, c, d
        torch.cuda.empty_cache()
        log(f"  parity {cfg.name} x2 layers f32 train step B2 S64: loss "
            f"cuda {lg:.6f} cpu {lc:.6f} (|diff| {abs(lg - lc):.3e}, limit "
            f"{1e-5 * abs(lc):.3e}); worst gradient diff / leaf max "
            f"{g_worst:.3e} (limit 1e-4); updated params max |diff| "
            f"{p_max:.3e} (limit {2 * lr:.1e}), "
            f"{sum(c[0] for c in counts)} elements beyond 1e-6 over "
            f"{len(counts)} leaves; nearest its limit: {n} of {numel} "
            f"(limit {lim}); {time.perf_counter() - t0:.1f} s (cuda step "
            f"{secs['cuda']:.1f}, cpu step {secs['cpu']:.1f}, compare "
            f"{secs['compare']:.1f})")
        if not (abs(lg - lc) <= 1e-5 * abs(lc) and g_worst <= 1e-4
                and p_max <= 2 * lr and all(c[0] <= c[1] for c in counts)):
            raise AssertionError(f"{cfg.name} train step: cuda vs cpu out "
                                 "of bounds")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


# ------------------------------------------------------------------ anneal
# The batched annealer's sweep: padded N, max_batch, (instances, chains)
# (N 1024 left the sweep to keep the script inside its time limit, its
# eager plain versions the sweep's longest; the launch plan's block with
# the request rows in shared memory, which it took, is held at N 257 and
# 2048 among the thresholds below)
ANNEAL_N = (8, 64, 256)
# max_batch 1 and 32 (8, the benchmark's, is held at the benchmark
# shapes and at the launch plan's thresholds; it left the sweep to keep
# the script inside its time limit: each case's eager plain version takes
# a third of a second of the one card)
ANNEAL_MB = (1, 32)
# one and eight instances (4 x 2 left the sweep in the same cut as N 1024;
# it is held at the benchmark shapes, I4 N64 C2)
ANNEAL_IC = ((1, 8), (8, 8))
# a case at each threshold of the kernel's launch plan (csrc/anneal.cu:
# a warp per chain to N 32, three rows at once there to max_batch 10, a
# thread a position to N 256, the request rows and the state in shared
# memory while they fit) and one past it, one instance x 4 chains, both
# scoring paths: (label, padded N, n_valid, max_batch, regime, iters a
# level or None for the default budget, the plan expected: threads,
# request rows in shared memory, state in shared memory)
# a case where a chain meets every SLO after its first level of 37
# proposals, and stops inside its second tile of 32 draws
ANNEAL_EXIT = "early exit inside a draw tile"
ANNEAL_EDGES = (
    ("warp, N not a multiple of 32", 20, 20, 8, "contended", None,
     (32, True, True)),
    ("warp at its N limit, three rows at once", 32, 32, 10, "contended",
     None, (32, True, True)),
    ("warp, a row a pass", 32, 32, 11, "contended", None, (32, True, True)),
    ("block, one past the warp limit", 33, 33, 8, "contended", None,
     (96, True, True)),
    ("block, N not a multiple of 32, two members a lane", 100, 100, 64,
     "contended", None, (128, True, True)),
    ("block, a position a thread at its limit", 256, 200, 8, "contended",
     None, (256, True, True)),
    ("block, two positions a thread", 257, 257, 8, "contended", None,
     (256, True, True)),
    (ANNEAL_EXIT, 40, 24, 32, "loose", 37, (96, True, True)),
    ("request rows in shared memory", 2048, 1536, 8, "contended", None,
     (256, True, True)),
    ("request rows in device memory", 4096, 3072, 8, "contended", None,
     (256, False, True)),
    ("request rows in device memory, max_batch 64", 4096, 3072, 64,
     "contended", None, (256, False, True)),
    ("state in the global workspace", 8192, 6144, 8, "contended", None,
     (256, False, False)),
    ("state in the global workspace, max_batch 64", 8192, 6144, 64,
     "contended", None, (256, False, False)),
)
# bounds, stated before the first run on the card: the kernel's best G
# vs the plain version's within 1e-6 relative (float32 sums of up to 1024
# terms taken in another order: the kernel's block trees and scans vs
# torch's); the kernel's G vs numpy evaluate (float64) of the kernel's
# own schedule within 1e-5 relative; met counts exact; the same best
# schedule in at least 95% of chains (a within-batch swap leaves G equal
# up to summation order, so the best-so-far test `G > best` may break
# such a tie the other way)
ANNEAL_G_TOL, ANNEAL_EVAL_TOL, ANNEAL_SAME = 1e-6, 1e-5, 0.95
# the shapes of benchmarks/bench_overhead.py, timed under the reference
# config's iters=100 per level (6300 proposals a chain): (label,
# instances, chains, requests per instance); max_batch 8, contended SLOs
ANNEAL_BENCH = (("N64 C8", 1, 8, 64), ("N128 C8", 1, 8, 128),
                ("N256 C8", 1, 8, 256), ("I4 N64 C2", 4, 2, 64))
# a padded N of 8: the least work a proposal, where the dependent chain
# of a proposal's steps is all there is
ANNEAL_FLOOR = ("N8 C8", 1, 8, 8)


def _anneal_arrays(n, seed, regime):
    """Requests as the reference test's ``_arrays`` makes them: the
    paper's mix, SLOs tightened in the contended regime."""
    from repro_torch.core.slo import as_arrays
    from repro_torch.data.synthetic import sample_requests
    reqs = sample_requests(n, seed=seed)
    for r in reqs:
        if regime == "contended":
            r.slo = dataclasses.replace(
                r.slo, e2e=r.slo.e2e * 0.2 if r.slo.e2e else None,
                ttft=r.slo.ttft * 0.02 if r.slo.ttft else None,
                tpot=r.slo.tpot * 0.5 if r.slo.tpot else None)
        r.predicted_output_len = r.output_len
    return as_arrays(reqs)


def _anneal_case(sizes, pad, regime, cfg, seed):
    """(arrays per instance, reqc [I, pad, 11], n_valid [I], draws) on
    the card, float32."""
    import torch
    from repro_torch.core import annealing_torch as at
    from repro_torch.core.latency_model import PAPER_TABLE2
    arrays = [_anneal_arrays(n, 1000 * seed + k, regime)
              for k, n in enumerate(sizes)]
    reqc = torch.stack([at._pack(a, PAPER_TABLE2, pad, torch.float32, "cuda")
                        for a in arrays])
    nv = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    draws = at.make_draws([at.instance_seed(seed, k)
                           for k in range(len(sizes))], cfg).cuda()
    return arrays, reqc, nv, draws


def _anneal_cost(n_inst, chains, n, mb, props, incremental):
    """Bytes and operations of one anneal: reqc and n_valid read once,
    each chain's draw rows read once, its best schedule and G written
    once; per proposal (every proposal of the schedule, as no chain of
    a contended instance meets every SLO) the incremental path rebuilds
    3 rows of mb members at 10 flops each, takes an N-long scan and
    three N-long sums and compares each of the N slacks with its batch's
    wait once (no row needs sorting for that count); the full path 25
    flops per position."""
    nbytes = n_inst * (n * 11 * 4 + 4) + n_inst * chains * (
        props * 16 + n * 5 + 4)
    per = 30 * mb + 4 * n + n if incremental else 25 * n
    return nbytes, n_inst * chains * props * per


def _check_anneal(arrays, nv, mb, got, plain, again, label, stats):
    """Validity, determinism and agreement of one kernel launch (got)
    with the plain version (plain) and with numpy evaluate."""
    import numpy as np
    import torch
    from repro_torch.core import annealing_torch as at
    from repro_torch.core.latency_model import PAPER_TABLE2
    from repro_torch.core.objective import evaluate
    for a, b in zip(got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"anneal {label}: two launches differ")
    kp, kb, kg = (t.cpu().numpy() for t in got)
    pp, pb, pg = (t.cpu().numpy() for t in plain)
    n = kp.shape[-1]
    for i, nvi in enumerate(nv.tolist()):
        for c in range(kp.shape[1]):
            perm, bnd = kp[i, c], kb[i, c]
            if sorted(perm.tolist()) != list(range(n)) or not bnd[0] \
                    or not bnd[nvi:].all() or (perm[nvi:] !=
                                               np.arange(nvi, n)).any():
                raise AssertionError(f"anneal {label} instance {i} chain "
                                     f"{c}: not a padded permutation")
            if nvi and np.bincount(np.cumsum(bnd[:nvi]) - 1).max() > mb:
                raise AssertionError(f"anneal {label} instance {i} chain "
                                     f"{c}: a batch above max_batch {mb}")
            same = (perm == pp[i, c]).all() and (bnd == pb[i, c]).all()
            stats["chains"] += 1
            stats["same"] += int(same)
            rel = abs(float(kg[i, c]) - float(pg[i, c])) / max(
                abs(float(pg[i, c])), 1e-30)
            stats["g_rel"] = max(stats["g_rel"], rel)
            stats["g_abs"] = max(stats["g_abs"],
                                 abs(float(kg[i, c]) - float(pg[i, c])))
            if rel > ANNEAL_G_TOL:
                raise AssertionError(f"anneal {label} instance {i} chain {c}"
                                     f": G {kg[i, c]} vs plain {pg[i, c]}")
            if not nvi:
                continue
            ev = evaluate(arrays[i], PAPER_TABLE2, *at._extract(perm, bnd,
                                                                nvi))
            erel = abs(float(kg[i, c]) - ev.G) / max(ev.G, 1e-30)
            stats["eval_rel"] = max(stats["eval_rel"], erel)
            if erel > ANNEAL_EVAL_TOL:
                raise AssertionError(f"anneal {label} instance {i} chain {c}"
                                     f": G {kg[i, c]} vs evaluate {ev.G}")
            if not same:
                evp = evaluate(arrays[i], PAPER_TABLE2,
                               *at._extract(pp[i, c], pb[i, c], nvi))
                if evp.n_met != ev.n_met:
                    raise AssertionError(
                        f"anneal {label} instance {i} chain {c}: met "
                        f"{ev.n_met} vs plain's schedule {evp.n_met}")


def _check_early_exit(args, got, tag):
    """That a chain of this case stopped after its first level, inside a
    draw tile: the plain version on that chain's first ``iters`` draws
    finishes (it raises when a chain needs more), on none it does not,
    and the kernel's chain equals it bit for bit."""
    import torch
    from repro_torch.kernels import anneal as ka
    reqc, nv, draws, *rest = args
    iters = rest[-2]
    if iters % 32 == 0:
        raise AssertionError(f"anneal {tag}: {iters} proposals a level end "
                             "a draw tile")

    def plain_within(c, cut):
        one = draws[:, c:c + 1, :cut].contiguous()
        try:
            return ka.anneal_chains_plain(reqc, nv, one, *rest)
        except ValueError:
            return None
    for c in range(draws.shape[1]):
        if plain_within(c, 0) is not None:
            continue
        out = plain_within(c, iters)
        if out is None:
            continue
        if not all(torch.equal(a[:, c:c + 1], b) for a, b in zip(got, out)):
            raise AssertionError(f"anneal {tag}: chain {c} stops after "
                                 f"{iters} proposals in the plain version, "
                                 "not so in the kernel")
        return c
    raise AssertionError(f"anneal {tag}: no chain stops after its first "
                         f"{iters} proposals")


def _plain_on_card(args):
    """The plain version on the card, in a worker process, on CPU copies
    of one case's inputs: (perm, bnd, G) on the CPU."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    from repro_torch.kernels import anneal as ka
    dev = [a.cuda() if torch.is_tensor(a) else a for a in args]
    return tuple(t.cpu() for t in ka.anneal_chains_plain(*dev))


def _plan_name(plan):
    """The kind of launch plan: a warp per chain, or a block with the
    request rows and the state where they fit."""
    if plan["threads"] == 32:
        return "warp per chain"
    return ("block, request rows and state in shared memory"
            if plan["reqc_smem"] else
            "block, state in shared memory, request rows in device memory"
            if plan["state_smem"] else "block, state in the global workspace")


def _on_host(args):
    """CPU copies of an anneal call's tensors, for a worker process."""
    return tuple(a.cpu() if hasattr(a, "cpu") else a for a in args)


def _plain_and_check(args, arrays, got, tag):
    """In a worker process: the plain version on the card on CPU copies of
    one case's inputs (``_plain_on_card``), and ``_check_anneal`` of the
    kernel's result ``got`` (CPU copies; its repeat launch is compared
    where it ran) against it.  Returns this case's stats."""
    plain = _plain_on_card(args)
    stats = {"chains": 0, "same": 0, "g_rel": 0.0, "g_abs": 0.0,
             "eval_rel": 0.0}
    _check_anneal(arrays, args[1], args[3], got, plain, got, tag, stats)
    return stats


def _anneal_sweep(stats, plans, pool):
    """The kernel against its plain version on the same draws: the sweep
    and a case at each threshold of the launch plan, both scoring
    paths.  Each case's plain version (an eager loop, host-bound) and its
    check against the kernel run in ``pool``'s worker processes while
    this process launches the kernel; two launches are compared here."""
    import torch
    from repro_torch.core import annealing_torch as at
    from repro_torch.core.annealing import SAParams
    from repro_torch.kernels import anneal as ka
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    runs = 0
    pending = []            # each case's (plain version + check) future

    def submit(arrays, args, got, again, tag):
        if not all(map(torch.equal, got, again)):
            raise AssertionError(f"anneal {tag}: two launches differ")
        pending.append(pool.submit(_plain_and_check, _on_host(args), arrays,
                                   _on_host(got), tag))
    for n in ANNEAL_N:
        for mb in ANNEAL_MB:
            for n_inst, chains in ANNEAL_IC:
                cfg = at.config_from_sa_params(SAParams(seed=0),
                                               num_chains=chains)
                sizes = [max(1, n - k * n // (2 * n_inst))
                         for k in range(n_inst)]
                if n_inst == 8:
                    sizes[-1] = 0          # an empty instance
                for regime in ("contended", "loose"):
                    arrays, reqc, nv, draws = _anneal_case(
                        sizes, n, regime, cfg, seed=n + mb + n_inst)
                    for inc in (True, False):
                        args = (reqc, nv, draws, mb, cfg.T0, cfg.T_thres,
                                cfg.tau, cfg.iters, inc)
                        got = ops.anneal_chains(*args)
                        again = ops.anneal_chains(*args)
                        label = (f"N{n} mb{mb} I{n_inst} C{chains} {regime} "
                                 f"{'incremental' if inc else 'full'}")
                        submit(arrays, args, got, again, label)
                        plans.add(_plan_name(ka.launch_plan(n, mb, inc)))
                        runs += 1
    sweep = runs
    for label, n, nvi, mb, regime, iters, want in ANNEAL_EDGES:
        cfg = at.config_from_sa_params(SAParams(seed=0), num_chains=4)
        if iters:
            cfg = dataclasses.replace(cfg, iters=iters)
        arrays, reqc, nv, draws = _anneal_case([nvi], n, regime, cfg,
                                               seed=n + mb)
        for inc in (True, False):
            plan = ka.launch_plan(n, mb, inc)
            if (plan["threads"], plan["reqc_smem"],
                    plan["state_smem"]) != want:
                raise AssertionError(f"anneal {label}: plan {plan}, "
                                     f"expected {want}")
            if plan["state_smem"] != (
                    ka.workspace_bytes(1, 4, n, mb, inc) == 0):
                raise AssertionError(f"anneal {label}: workspace bytes "
                                     "disagree with the plan")
            args = (reqc, nv, draws, mb, cfg.T0, cfg.T_thres, cfg.tau,
                    cfg.iters, inc)
            tag = (f"{label}: N{n} n_valid {nvi} mb{mb} {regime} iters "
                   f"{cfg.iters} {'incremental' if inc else 'full'}")
            got = ops.anneal_chains(*args)
            submit(arrays, args, got, ops.anneal_chains(*args), tag)
            plans.add(_plan_name(plan))
            log(f"  anneal {tag}: {_plan_name(plan)} ({plan['threads']} "
                "threads)")
            if label == ANNEAL_EXIT:
                c = _check_early_exit(args, got, tag)
                log(f"  anneal {tag}: chain {c} meets every SLO and stops "
                    f"after {cfg.iters} proposals, inside its draw tile "
                    f"{cfg.iters // 32}")
            runs += 1
    for case in pending:
        got = case.result()
        for key in ("chains", "same"):
            stats[key] += got[key]
        for key in ("g_rel", "g_abs", "eval_rel"):
            stats[key] = max(stats[key], got[key])
    log(f"  anneal sweep: {sweep} runs (N {ANNEAL_N} x max_batch "
        f"{ANNEAL_MB} x (instances, chains) {ANNEAL_IC} x contended/loose x "
        f"incremental/full, global budget) and plan thresholds: "
        f"{runs - sweep} runs, their plain versions in worker processes, "
        f"in {time.perf_counter() - t0:.1f} s; plans taken: "
        f"{sorted(plans)}")
    if len(plans) != 4:
        raise AssertionError(f"anneal: plans taken {sorted(plans)}, not "
                             "all four")


def phase_anneal(ctx):
    """The batched annealer's kernel against its plain version on the
    same draws, over the sweep, the launch plan's thresholds and both
    scoring paths, then timed at the benchmark's shapes."""
    import torch
    from repro_torch.core import annealing_torch as at
    from repro_torch.kernels import _build
    from repro_torch.kernels import anneal as ka
    from repro_torch.kernels import ops
    card, smi, results = ctx["card"], ctx["smi"], ctx["results"]
    ptxas = _build.compiler_log("anneal")
    bad = [ln for ln in ptxas if "0 bytes stack frame, 0 bytes spill "
           "stores, 0 bytes spill loads" not in ln]
    if bad or len(ptxas) != 6:
        raise AssertionError(f"anneal: not six kernel instances with a "
                             f"0-byte stack and 0 spill: {ptxas}")
    stats = {"chains": 0, "same": 0, "g_rel": 0.0, "g_abs": 0.0,
             "eval_rel": 0.0}
    plans = set()
    mb = 8
    bench = []
    for label, n_inst, chains, n in ANNEAL_BENCH + (ANNEAL_FLOOR,):
        cfg = at.TorchSAConfig(iters=100, num_chains=chains)
        case = _anneal_case([n] * n_inst, n, "contended", cfg, seed=7)
        for inc in (True, False) if label == "N64 C8" else (True,):
            bench.append((label, n_inst, chains, n, cfg, case, inc))
    # the plain version at the benchmark's shapes (an eager run takes
    # 10-30 s of host time) in worker processes on the card while the
    # sweep runs, all but the first, which is timed here, and then the
    # sweep's; no worker runs while the kernel is timed
    pool = ProcessPoolExecutor(max_workers=4, mp_context=(
        multiprocessing.get_context("spawn")))
    try:
        futures = {}
        for k, (label, _, _, _, cfg, (_, reqc, nv, draws), inc) in \
                enumerate(bench):
            if k and label != ANNEAL_FLOOR[0]:
                futures[k] = pool.submit(_plain_on_card, (
                    reqc.cpu(), nv.cpu(), draws.cpu(), mb, cfg.T0,
                    cfg.T_thres, cfg.tau, cfg.iters, inc))
        _anneal_sweep(stats, plans, pool)
        t0 = time.perf_counter()
        plain_of = {k: f.result() for k, f in futures.items()}
        wait = time.perf_counter() - t0
        log(f"  anneal: the plain version at {len(futures)} benchmark "
            f"shapes in worker processes, waited {wait:.1f} s after the "
            "sweep")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    rows = []
    for k, (label, n_inst, chains, n, cfg, case, inc) in enumerate(bench):
        arrays, reqc, nv, draws = case
        args = (reqc, nv, draws, mb, cfg.T0, cfg.T_thres, cfg.tau,
                cfg.iters, inc)
        got = ops.anneal_chains(*args)
        again = ops.anneal_chains(*args)
        tag = f"{label} mb{mb} {'incremental' if inc else 'full'}"
        plain_ms = None
        if k == 0:
            torch.cuda.synchronize()
            t = time.perf_counter()
            plain = ka.anneal_chains_plain(*args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t) * 1e3
            _check_anneal(arrays, nv, mb, got, plain, again,
                          tag + " per_level", stats)
        elif k in plain_of:
            _check_anneal(arrays, nv, mb, got, plain_of[k], again,
                          tag + " per_level", stats)
        elif not all(map(torch.equal, got, again)):
            raise AssertionError(f"anneal {tag}: two launches differ")
        ms = time_ms(lambda: ops.anneal_chains(*args), 10)
        props = at.temperature_levels(cfg.T0, cfg.T_thres,
                                      cfg.tau) * cfg.iters
        nbytes, flops = _anneal_cost(n_inst, chains, n, mb, props, inc)
        b_ms, b_by = bound(nbytes, flops, "float32")
        row = {"shape": tag, "instances": n_inst, "chains": chains,
               "n": n, "max_batch": mb, "proposals": props, "ms": ms,
               "us_per_proposal": ms * 1e3 / props,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "plan": _plan_name(ka.launch_plan(n, mb, inc))}
        rows.append(row)
        log(f"  anneal {card} | {smi} | {tag} ({props} proposals a "
            f"chain, {row['plan']}): kernel {ms:.3f} ms "
            f"({row['us_per_proposal']:.3f} us a proposal), plain eager "
            f"{plain_ms} ms, bound {b_ms:.6f} ms ({b_by})")
    same = stats["same"] / stats["chains"]
    log(f"  anneal: {stats['chains']} chains, best schedule identical to "
        f"the plain version's in {same:.4f}, max |G - plain| relative "
        f"{stats['g_rel']:.3e} (limit {ANNEAL_G_TOL:g}), max |G - numpy "
        f"evaluate| relative {stats['eval_rel']:.3e} (limit "
        f"{ANNEAL_EVAL_TOL:g}), two launches bitwise equal, ptxas 0 spill "
        f"and 0-byte stacks")
    if same < ANNEAL_SAME:
        raise AssertionError(f"anneal: identical best schedules in {same} "
                             f"< {ANNEAL_SAME} of chains")
    first = rows[0]
    r = results.setdefault("anneal", {"name": "anneal", **KERNELS["anneal"]})
    r.update({"max_abs_err": stats["g_abs"], "ms": first["ms"],
              "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
              "bound_by": first["bound_by"], "library_ms": None,
              "shape": first["shape"], "shapes": rows,
              "n8_us_per_proposal": rows[-1]["us_per_proposal"],
              "identical_share": same, "max_rel_err_G": stats["g_rel"],
              "max_rel_err_vs_evaluate": stats["eval_rel"],
              "plans": sorted(plans), "ptxas": ptxas})
    log("  anneal rows: " + json.dumps(rows))


MESH_TP = 2
# the serve phase's engine (``_serve_run``) and workload
MESH_ENGINE = dict(max_slots=4, max_seq_len=256)
# depth cuts of the mesh phase (published widths), so that the script
# keeps inside its time limit: every decode round makes gloo reductions
# staged through the host.  Qwen2.5-7B at 4 of its 28 layers (14 until
# Zamba2 and DeepSeek joined the phase, 7 until the script ran past its
# time limit), DeepSeek-V2-Lite at 4 of 27 (7 before), DBRX at 4 of 40
# (the other 36 do not fit one card), Zamba2-1.2B at its first 12 of 38
# layers (10 Mamba2 blocks and two applications of the shared block)
MESH_QWEN_LAYERS = 4
MESH_DEEPSEEK_LAYERS = 4
MESH_ZAMBA2_LAYERS = 12
MESH_LAYERS = {"qwen2.5-7b": MESH_QWEN_LAYERS, "dbrx-132b": DBRX_LAYERS,
               "deepseek-v2-lite-16b": MESH_DEEPSEEK_LAYERS,
               "zamba2-1.2b": MESH_ZAMBA2_LAYERS}
PARITY_LAYERS = 2
# Zamba2 in float32: 4 layers with the shared block used twice, the
# parity phase's pattern (``_hybrid_parity``)
HYBRID_PARITY = dict(layers=4, pattern=("ssm", "attn", "ssm", "attn"))
# the engine clock of the runs whose policy decides by it (slo-reanneal,
# slo-preempt), in their tp 1 run and on rank 0 alike: every timed step
# takes MESH_STEP_S, so that both decide alike and launch alike, and slow
# enough that slo-preempt preempts (3 times on this trace); their tok/s
# is then taken on the wall clock
MESH_STEP_S = 0.3
_F32 = dict(layers=PARITY_LAYERS, dtype="float32")
_QWEN = dict(arch="qwen2.5-7b", path="serve_mesh")
_DBRX = dict(arch="dbrx-132b", kind="policy", policy="fcfs", ref="same",
             path="serve_mesh")
_ZAMBA2 = dict(arch="zamba2-1.2b", kind="policy", ref="same",
               path="serve_mesh_hybrid")
_DEEPSEEK = dict(arch="deepseek-v2-lite-16b", kind="policy", policy="fcfs",
                 ref="same", path="serve_mesh_mla")
# the mesh phase's runs, in order; consecutive runs of one model share
# its weights.  "ref": a tp 1 run in this process on the same config,
# weights (seed 0), engine and workload ("same": the same kind of run;
# "loop": one ServeLoop over one engine, the reference's fleet parity),
# whose launches each rank must match; in float32 also its tokens and
# (but against the loop) first-step logits.  "path": the PATHS entry of
# what each rank must launch; "clock": the engine clock moves
# MESH_STEP_S a step (policies that decide by it)
MESH_JOBS = (
    dict(_QWEN, name="qwen fcfs", kind="policy", policy="fcfs", ref="same"),
    dict(_QWEN, name="qwen slo-reanneal:jax", kind="policy",
         policy="slo-reanneal:jax"),
    dict(_QWEN, name="qwen ServeLoop fcfs", kind="loop", policy="fcfs"),
    dict(_QWEN, name="qwen fleet x2 route:annealed", kind="fleet",
         policy="fcfs", mapper="annealed", ref="same"),
    dict(_QWEN, name="qwen f32 2 layers fcfs", kind="policy",
         policy="fcfs", ref="same", **_F32),
    dict(_QWEN, name="qwen f32 2 layers fleet x2 least-loaded",
         kind="fleet", policy="fcfs", mapper="least-loaded", ref="loop",
         **_F32),
    dict(_DBRX, name="dbrx expert-parallel fcfs", ep=True),
    dict(_DBRX, name="dbrx baseline fcfs", ep=False),
    dict(_DBRX, name="dbrx f32 2 layers expert-parallel fcfs", ep=True,
         **_F32),
    dict(_DBRX, name="dbrx f32 2 layers baseline fcfs", ep=False, **_F32),
    dict(_ZAMBA2, name="zamba2 fcfs", policy="fcfs"),
    dict(_ZAMBA2, name="zamba2 slo-reanneal:jax", policy="slo-reanneal:jax",
         clock=True),
    dict(_ZAMBA2, name="zamba2 slo-preempt chunked:32", policy="slo-preempt",
         discipline="chunked:32", clock=True,
         path="serve_mesh_hybrid_chunked"),
    dict(_ZAMBA2, name="zamba2 f32 4 layers fcfs", policy="fcfs",
         dtype="float32", **HYBRID_PARITY),
    dict(_DEEPSEEK, name="deepseek expert-parallel fcfs", ep=True),
    dict(_DEEPSEEK, name="deepseek f32 2 layers expert-parallel fcfs",
         ep=True, **_F32),
    dict(_DEEPSEEK, name="deepseek f32 2 layers baseline fcfs", ep=False,
         **_F32),
)
# engines on a mesh with a data axis: (data 2, tp 1), each rank the whole
# pool (the reference's placement), the params whole over data or
# FSDP-sliced (every layer's shards gathered each pass: 3.7 GB of float32
# at Qwen2.5-7B's 4 layers, staged through the host, 3.8 s a round on the
# H100's host, so that run serves the trace's first request, 2 tokens:
# a prefill and a decode round, each warmed once)
MESH_DATA = 2
MESH_DATA_JOBS = (
    dict(_QWEN, name="qwen 2x1 fcfs", kind="policy", policy="fcfs",
         ref="same", data=MESH_DATA),
    dict(_QWEN, name="qwen 2x1 fsdp fcfs", kind="policy", policy="fcfs",
         ref="same", data=MESH_DATA, fsdp=True, requests=1, cap=2),
    dict(_QWEN, name="qwen f32 2 layers 2x1 fcfs", kind="policy",
         policy="fcfs", ref="same", data=MESH_DATA, **_F32),
)


def _mesh_cfg(job):
    """A mesh job's config: published widths, the job's depth (its
    pattern, or the first layers of the published one) or
    ``MESH_LAYERS``', the job's dtype."""
    from repro_torch.configs import get_config
    cfg = get_config(job["arch"])
    layers = job.get("layers") or MESH_LAYERS[job["arch"]]
    if job.get("pattern"):
        cfg = dataclasses.replace(cfg, num_layers=layers,
                                  layer_pattern=tuple(job["pattern"]))
    else:
        cfg = _depth(cfg, layers)
    if job.get("dtype"):
        cfg = dataclasses.replace(cfg, dtype=job["dtype"])
    return cfg


def _ref_key(job):
    """Mesh runs that one tp 1 run serves as reference (the two MoE
    branches compute the same function, and so do params whole or
    FSDP-sliced over a data axis)."""
    return (job["arch"], job.get("layers"), job.get("dtype"), job["kind"],
            job["policy"], job.get("discipline"), job.get("mapper"),
            job["ref"], job.get("requests"), job.get("cap"))


def _weights_key(job):
    return (job["arch"], job.get("layers"), job.get("dtype"),
            job.get("ep", False), job.get("fsdp", False))


class _StepClock:
    """A stand-in for the engine module's ``time`` whose ``perf_counter``
    moves ``step`` seconds a call: every timed engine step (the span
    between two calls) then takes ``step``."""

    def __init__(self, step):
        self.t, self.step = 0.0, step

    def perf_counter(self):
        self.t += self.step
        return self.t


def _time_collectives(stats):
    """Count the mesh's collectives (``all_reduce``, ``broadcast``), the
    bytes of the tensors they reduce or send, and their host seconds,
    each timed between two synchronizes of the current stream (gloo
    stages a CUDA tensor through the host and the call returns once the
    sum is back): the rank's time in collectives, what it waited for
    before them excluded."""
    import torch
    import torch.distributed as dist
    for name in ("all_reduce", "broadcast"):
        fn = getattr(dist, name)

        def timed(*args, _fn=fn, **kw):
            torch.cuda.current_stream().synchronize()
            t = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.current_stream().synchronize()
            stats["s"] += time.perf_counter() - t
            stats["n"] += 1
            t = args[0] if args else kw["tensor"]
            stats["bytes"] += t.numel() * t.element_size()
            return out
        setattr(dist, name, timed)


def _time_rounds(eng):
    """Host ms of each synchronized decode round rank 0 (or the tp 1
    run) runs through ``run_policy``, on the real clock."""
    import torch
    rounds = []
    run = eng._do_decode

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run(*args)
        torch.cuda.synchronize()
        rounds.append(1e3 * (time.perf_counter() - t))
        return out
    eng._do_decode = timed
    return rounds


def _round_bytes(eng, stats):
    """The collective bytes of each synchronous decode round of ``eng``
    on this rank (``stats``: :func:`_time_collectives`'s)."""
    rounds = []
    run = eng._do_decode

    def counted(*args):
        before = stats["bytes"]
        out = run(*args)
        rounds.append(stats["bytes"] - before)
        return out
    eng._do_decode = counted
    return rounds


def _mesh_workload(job, vocab):
    """The mesh phase's trace, ``sample_serve_workload(8)``, or its first
    ``requests`` with each output cut to ``cap`` tokens."""
    from repro_torch.data.synthetic import sample_serve_workload
    pairs = sample_serve_workload(8, vocab, seed=1)[:job.get("requests", 8)]
    if job.get("cap"):
        pairs = [(dataclasses.replace(r, output_len=min(r.output_len,
                                                        job["cap"])), p)
                 for r, p in pairs]
    return pairs


def _mesh_run(engines, job, cfg):
    """Rank 0's side (or the tp 1 reference): the job's requests through
    ``run_policy``, a ``ServeLoop`` or an ``EngineFleet`` of the two
    engines, which are then closed; each request's tokens (by its index
    in the trace), their budgets, the seconds the run took and on which
    clock, and the host ms of its decode rounds (``run_policy``
    only)."""
    import numpy as np
    from repro_torch.core.latency_model import PAPER_TABLE2
    from repro_torch.core.policies import make
    from repro_torch.engine import engine as engine_mod
    from repro_torch.launch.serve import _to_rts
    pairs = _mesh_workload(job, cfg.vocab_size)
    budgets = {i: r.output_len for i, (r, _) in enumerate(pairs)}
    warm = [len(p) for _, p in pairs]
    real = engine_mod.time
    if job.get("clock"):
        engine_mod.time = _StepClock(MESH_STEP_S)
    rounds = []
    try:
        if job["kind"] in ("loop", "fleet"):
            from repro_torch.serving import EngineFleet, ServeLoop
            if job["kind"] == "fleet":
                target = EngineFleet(engines, job["policy"],
                                     mapper=job["mapper"],
                                     model=PAPER_TABLE2)
            else:
                target = ServeLoop(engines[0], job["policy"],
                                   model=PAPER_TABLE2)
            target.start(warm_lengths=warm)
            t0 = time.perf_counter()
            streams = target.submit_trace(pairs)
            target.serve()
            seconds, clock = time.perf_counter() - t0, "wall"
            tokens = {i: list(s.tokens) for i, s in enumerate(streams)}
        else:
            eng = engines[0]
            rounds = _time_rounds(eng)
            pol = make(job["policy"], model=PAPER_TABLE2,
                       max_batch=eng.max_slots, device=eng.device)
            t0 = time.perf_counter()
            out = eng.run_policy(_to_rts(pairs), pol,
                                 discipline=job.get("discipline", "stall"))
            if job.get("clock"):
                seconds, clock = time.perf_counter() - t0, "wall"
            else:
                seconds, clock = eng.clock, "engine clock"
            tokens = {rid: v["tokens"] for rid, v in out.items()}
            preempted = sum(v["preemptions"] for v in out.values())
    finally:
        engine_mod.time = real
    for eng in engines:       # on rank 0: stop the other ranks' follow()
        eng.close()
    return {"tokens": tokens, "budgets": budgets, "seconds": seconds,
            "clock": clock, "rounds": len(rounds),
            "preemptions": preempted if job["kind"] == "policy" else None,
            "decode_ms": float(np.mean(rounds)) if rounds else None}


def _first_prefill(eng):
    """Keep the logits of the engine's first prefill step, a whole
    prompt's or a chunk's (the row the first token is drawn from, or the
    chunk's last), as float32 numpy."""
    first = {}
    for name in ("_do_prefill", "_do_chunk"):
        def hooked(*args, _run=getattr(eng, name)):
            row = _run(*args)
            if "row" not in first:
                first["row"] = row.float().cpu().numpy()
            return row
        setattr(eng, name, hooked)
    return first


def _cache_facts(eng):
    """The shape of the first attention layer's pages, and the bytes of
    the engine's cache by kind: K/V pages, MLA latent pages, per-slot SSM
    state."""
    kinds = {"k": "kv", "v": "kv", "ckv": "latent", "kpe": "latent",
             "conv": "ssm", "ssm": "ssm"}
    nbytes, pages = {}, None
    for layer in eng.cache["layers"]:
        for name, t in layer.items():
            kind = kinds[name]
            nbytes[kind] = nbytes.get(kind, 0) + t.numel() * t.element_size()
            if pages is None and kind != "ssm":
                pages = tuple(t.shape)
    return pages, nbytes


def _rank_params(mesh, cfg, par):
    """This rank's slice of the weights, drawn whole from seed 0 on the
    card one rank at a time (two ranks' transient whole copies of a big
    model would not fit the card together)."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import (param_specs,
                                                  placement_specs,
                                                  shard_params)
    from repro_torch.models.model import init_params
    params = None
    for r in range(mesh.size):
        if r == mesh.rank:
            full = init_params(cfg, seed=0, device=mesh.device)
            params = shard_params(full, placement_specs(
                param_specs(full, cfg, mesh, par), cfg, mesh, par), mesh)
            del full
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier(group=mesh.control_group)
    return params


def mesh_rank(mesh, jobs):
    """One rank of the mesh phase: each job's engine (a fleet's two, the
    second on the first's params) on this rank's shard of the weights,
    rank 0 driving it and the other ranks following.  Per job and rank:
    launch counts, collectives, peak memory, the cache's page shape and
    bytes, the first prefill's logits; on rank 0 the run's tokens, clock
    and decode ms a round."""
    import gc

    import torch
    from repro_torch.distributed.sharding import ParallelismConfig
    from repro_torch.engine.engine import Engine
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stats = {"s": 0.0, "n": 0, "bytes": 0}
    _time_collectives(stats)
    out, params, key, held_gb = [], None, None, 0.0
    for job in jobs:
        cfg = _mesh_cfg(job)
        par = ParallelismConfig(fsdp=job.get("fsdp", False),
                                expert_parallel=job.get("ep", False))
        draw_s = 0.0
        if _weights_key(job) != key:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            held_gb = torch.cuda.memory_allocated() / 1e9
            # the first run of each model's peak counts its draw
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params = _rank_params(mesh, cfg, par)
            key = _weights_key(job)
            draw_s = time.perf_counter() - t0
        else:
            torch.cuda.reset_peak_memory_stats()
        engines = []
        for _ in range(2 if job["kind"] == "fleet" else 1):
            engines.append(Engine(cfg, engines[0].params if engines
                                  else params, device=mesh.device,
                                  mesh=mesh, parallelism=par,
                                  **MESH_ENGINE))
        first = _first_prefill(engines[0])
        rounds = _round_bytes(engines[0], stats)
        ops.reset_launch_counts()
        layers.reset_collective_counts()
        stats.update(s=0.0, n=0, bytes=0)
        pages, nbytes = _cache_facts(engines[0])
        res = {"name": job["name"], "rank": mesh.rank, "draw_s": draw_s,
               "held_gb": held_gb,
               "pages": pages, "cache_bytes": nbytes,
               "params_gb": sum(t.numel() * t.element_size()
                                for t in _leaves(params)) / 1e9}
        t0 = time.perf_counter()
        if mesh.rank == 0:
            res.update(_mesh_run(engines, job, cfg))
        else:
            engines[0].follow()
        torch.cuda.synchronize()
        res.update(wall_s=time.perf_counter() - t0,
                   counts=ops.launch_counts(), coll_s=stats["s"],
                   coll_n=stats["n"], coll_bytes=stats["bytes"],
                   round_bytes=sorted(set(rounds)), n_rounds=len(rounds),
                   tally=layers.collective_counts(), first=first.get("row"),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        out.append(res)
        del engines, first
    return out


def nccl_probe(mesh):
    """One NCCL all_reduce over the ranks (two of them on one card)."""
    import torch
    import torch.distributed as dist
    x = torch.ones(1, device=mesh.device)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    return float(x)


def _mesh_reference(job, held):
    """The job's tp 1 reference in this process: the same config,
    weights (seed 0), engine and workload, through the same kind of run
    or (``ref="loop"``) one ServeLoop over one engine; its tokens, launch
    counts, first prefill logits and cache bytes.  ``held``: the weights
    of the previous reference, kept while the next one shares them."""
    import gc

    import torch
    from repro_torch.engine.engine import Engine
    from repro_torch.kernels import ops
    from repro_torch.models.model import init_params
    cfg = _mesh_cfg(job)
    kind = job["kind"] if job["ref"] == "same" else "loop"
    key = _weights_key(dict(job, ep=False, fsdp=False))
    if held.get("key") != key:
        held.clear()
        gc.collect()
        torch.cuda.empty_cache()
        held.update(key=key, params=init_params(cfg, seed=0,
                                                device="cuda"))
    engines = [Engine(cfg, held["params"], device="cuda", **MESH_ENGINE)
               for _ in range(2 if kind == "fleet" else 1)]
    first = _first_prefill(engines[0])
    ops.reset_launch_counts()
    res = _mesh_run(engines, dict(job, kind=kind), cfg)
    torch.cuda.synchronize()
    res.update(counts=ops.launch_counts(), first=first["row"],
               cache_bytes=_cache_facts(engines[0])[1])
    del engines, first
    gc.collect()
    return res


def _check_mesh_job(job, ranks, ref, smi):
    """The checks of one mesh run (module docstring, phase mesh)."""
    import numpy as np
    lead = ranks[0]
    cfg = _mesh_cfg(job)
    data = job.get("data", 1)
    where = f"tp {len(ranks)}" if data == 1 else \
        f"(data {data}, tp {len(ranks) // data})" + \
        (" FSDP" if job.get("fsdp") else " params whole")
    n = len(lead["budgets"])
    for rid, toks in lead["tokens"].items():
        if len(toks) != lead["budgets"][rid] or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"mesh {job['name']}: request {rid} got "
                                 f"{len(toks)} of {lead['budgets'][rid]} "
                                 "tokens, or one out of the vocabulary")
    if len(lead["tokens"]) != n:
        raise AssertionError(f"mesh {job['name']}: {len(lead['tokens'])} "
                             f"of {n} requests completed")
    # every rank computes the whole logits: bit for bit alike
    for r in ranks[1:]:
        if not np.array_equal(r["first"], lead["first"]):
            raise AssertionError(
                f"mesh {job['name']}: rank {r['rank']}'s first-step logits "
                "differ from rank 0's")
    for r in ranks:
        for name in PATHS[job["path"]]:
            if r["counts"].get(name, 0) <= 0:
                raise AssertionError(f"mesh {job['name']}: rank {r['rank']} "
                                     f"never launched {name}")
        # a run's launches equal its tp 1 run's (not a single loop's,
        # against which a fleet checks its tokens only)
        same = ref is not None and job["ref"] == "same"
        want = {k: v for k, v in (ref or lead)["counts"].items()
                if k != "anneal"}
        got = {k: v for k, v in r["counts"].items() if k != "anneal"}
        if same and got != want:
            raise AssertionError(f"mesh {job['name']}: rank {r['rank']} "
                                 f"launched {got}, the tp 1 run {want}")
    if job["policy"] == "slo-preempt" and not lead["preemptions"]:
        raise AssertionError(f"mesh {job['name']}: nothing was preempted")
    if ref is not None and lead["preemptions"] != ref["preemptions"]:
        raise AssertionError(f"mesh {job['name']}: {lead['preemptions']} "
                             f"preemptions, the tp 1 run "
                             f"{ref['preemptions']}")
    anneals = [r["counts"].get("anneal", 0) for r in ranks]
    if (job["policy"] == "slo-reanneal:jax" or job.get("mapper")
            == "annealed") and (anneals[0] < 1 or any(anneals[1:])):
        raise AssertionError(f"mesh {job['name']}: anneal launches by rank "
                             f"{anneals}: rank 0 must anneal, alone")
    if ref is not None and job["ref"] == "same" \
            and ref["counts"].get("anneal", 0) != anneals[0]:
        raise AssertionError(f"mesh {job['name']}: rank 0 annealed "
                             f"{anneals[0]} times, the tp 1 run "
                             f"{ref['counts'].get('anneal', 0)}")
    ntok = sum(len(t) for t in lead["tokens"].values())
    coll = [r["coll_s"] / lead["seconds"] for r in ranks]
    log(f"  mesh {smi} | {len(ranks)} ranks time-sharing one card | "
        f"{job['name']}: {where}, {cfg.num_layers} layers "
        f"{cfg.dtype}, pages {lead['pages']} a rank, cache bytes a rank "
        + " / ".join(json.dumps(r["cache_bytes"]) for r in ranks)
        + f": completed {len(lead['tokens'])}/{n}, {ntok} tokens, "
        f"{ntok / lead['seconds']:.1f} tok/s over {lead['seconds']:.3f} s "
        f"({lead['clock']}), "
        + (f"decode {lead['decode_ms']:.2f} host ms a round over "
           f"{lead['rounds']} rounds, " if lead.get("decode_ms") else "")
        + (f"{lead['preemptions']} preemptions, "
           if lead["preemptions"] is not None else "")
        + "collectives " + " / ".join(
            f"{r['coll_n']} calls {r['coll_bytes']} bytes {r['coll_s']:.3f} s"
            for r in ranks)
        + ", a decode round's bytes " + " / ".join(
            f"{r['round_bytes']} over {r['n_rounds']} rounds" for r in ranks)
        + f", the port's tally on rank 0 {json.dumps(lead['tally'])}"
        + " (share of the run: " + " / ".join(f"{c:.3f}" for c in coll)
        + "); peak GB a rank " + " / ".join(
            f"{r['peak_gb']:.2f}" for r in ranks)
        + f"; weights GB a rank {lead['params_gb']:.2f} (GB held before "
        "drawing them: " + " / ".join(f"{r['held_gb']:.2f}" for r in ranks)
        + f"); rank 0 drew its weights in {lead['draw_s']:.1f} s and "
        f"served in {lead['wall_s']:.1f} s (warm-ups included); launches "
        "rank 0 "
        + json.dumps({k: v for k, v in lead["counts"].items() if v})
        + (f", tp 1 {json.dumps({k: v for k, v in ref['counts'].items() if v})}"
           if ref is not None else ""))
    if ref is None:
        return
    for kind in ("latent", "ssm"):
        if kind in ref["cache_bytes"]:
            got = [r["cache_bytes"].get(kind) for r in ranks]
            if any(g != ref["cache_bytes"][kind] for g in got):
                raise AssertionError(
                    f"mesh {job['name']}: {kind} bytes a rank {got}, tp 1 "
                    f"{ref['cache_bytes'][kind]} (whole on every rank)")
            log(f"  mesh {job['name']}: {kind} bytes a rank "
                + " / ".join(str(g) for g in got)
                + f", tp 1 {ref['cache_bytes'][kind]} (whole on every rank)")
    same = sum(a == b for rid in ref["tokens"]
               for a, b in zip(lead["tokens"][rid], ref["tokens"][rid]))
    total = sum(len(t) for t in ref["tokens"].values())
    gap = float(np.max(np.abs(lead["first"] - ref["first"])))
    scale = float(np.max(np.abs(ref["first"])))
    against = "one tp 1 ServeLoop" if job["ref"] == "loop" else "tp 1"
    if cfg.dtype == "float32":
        # a fleet's first prefill need not be the single loop's
        bad_gap = job["ref"] != "loop" and gap > 1e-4 * scale
        if lead["tokens"] != ref["tokens"] or bad_gap:
            raise AssertionError(f"mesh {job['name']}: {where} vs "
                                 f"{against} tokens identical="
                                 f"{lead['tokens'] == ref['tokens']}, first "
                                 f"logits gap {gap:.3e} of max {scale:.3e}")
        log(f"  mesh {job['name']}: {where} vs {against} greedy "
            f"tokens identical ({total}), "
            + ("" if job["ref"] == "loop" else
               f"first-step logits max gap {gap:.3e} of max |logit| "
               f"{scale:.3e} (bound 1e-4 of it), ")
            + "ranks' logits bit for bit alike")
    elif data > 1 and len(ranks) == data:
        # a data axis alone: each rank runs tp 1's computation (an FSDP
        # gather is an exact zero-padded sum), so the same tokens
        if lead["tokens"] != ref["tokens"]:
            raise AssertionError(f"mesh {job['name']}: {where} vs tp 1 "
                                 f"tokens matching {same}/{total}")
        log(f"  mesh {job['name']}: {where} vs tp 1 bf16 greedy tokens "
            f"identical ({total}), first-step logits max gap {gap:.3e} of "
            f"max |logit| {scale:.3e}; ranks' logits bit for bit alike")
    else:
        log(f"  mesh {job['name']}: {where} vs tp 1 tokens "
            f"matching {same}/{total} ({same / total:.3f}), first-step "
            f"logits max gap {gap:.3e} of max |logit| {scale:.3e} (bf16: "
            "each rank's row-parallel partial sums are rounded to bf16 "
            "before the float32 sum, where tp 1 rounds the whole product "
            "once, so one flipped argmax changes every later token of "
            "that request; reported, not bounded); ranks' logits bit for "
            "bit alike")


def _check_round_bytes(job, ranks, smi):
    """Each synchronous decode round of a ``run_policy`` mesh job moved,
    on every rank, the collective bytes the dry run predicts for one
    paged decode round of the pool (``dryrun.collectives``, the rank's
    rows the whole pool)."""
    from repro_torch.distributed.sharding import ParallelismConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    data = job.get("data", 1)
    tp = len(ranks) // data
    slots = MESH_ENGINE["max_slots"]
    nbytes, calls = dryrun.collectives(
        _mesh_cfg(job), "decode", Mesh({"data": data, "model": tp}),
        ParallelismConfig(fsdp=job.get("fsdp", False),
                          expert_parallel=job.get("ep", False)),
        slots, 1, rows=slots)
    want = sum(nbytes.values())
    got = [r["round_bytes"] for r in ranks]
    ok = all(g == [want] and r["n_rounds"] > 0 for g, r in zip(got, ranks))
    log(f"  mesh {job['name']} ({smi}): a decode round's collective bytes "
        f"on each rank {got} (counted by _time_collectives over "
        f"{ranks[0]['n_rounds']} rounds), the dry run predicts {want} in "
        f"{sum(calls.values())} calls {json.dumps(nbytes)} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"mesh {job['name']}: decode round bytes {got}"
                             f", the dry run predicts {want}")


def _dryrun_table():
    """The dry run's record of every ``ASSIGNED`` arch x shape x both
    production meshes (spec arithmetic on the host), and its seconds."""
    from repro_torch.configs import ASSIGNED
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    recs = [dryrun.run_one(arch, shape, mp, save=False, verbose=False)
            for arch in ASSIGNED for shape in dryrun.SHAPES
            for mp in (False, True)]
    return recs, time.perf_counter() - t0


def _dryrun_line(rec):
    """A dry-run record as a table row: per device GiB and collectives by
    kind (MiB, calls)."""
    from repro_torch.launch import dryrun
    kinds = ", ".join(
        f"{k} {v / 2**20:.1f} MiB/{rec['collective_counts'][k]}"
        for k, v in rec["collective_bytes_per_device"].items())
    return dryrun.line(rec) + f" [{kinds}]"


def _ragged_past_check():
    """The grouped product as the expert-parallel branch calls it: one
    rank's 8 of DBRX's 16 experts (gate/up and down widths), the rows of
    a decode round's routed pairs whose experts live on the other rank
    sorted past the last group, so the group sizes sum to fewer than the
    rows.  ``torch._grouped_mm`` leaves those rows unwritten; selected
    away (``torch.where``, as ``moe._experts`` does), the result must
    equal the plain version (zeros past the last group) within ``TOL``,
    in bf16 and float32."""
    import torch
    from repro_torch.kernels import ragged_dot as rd
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    e, d, ff, k, t = 16, 6144, 10752, 4, 8
    local = e // MESH_TP
    routed = torch.topk(torch.rand((t, e), generator=gen, device="cuda"),
                        k, dim=-1).indices.reshape(-1)
    gs = (routed[:, None] == torch.arange(local, device="cuda")).sum(
        0, dtype=torch.int32)
    n = int(gs.sum())
    if not 0 < n < t * k:
        raise AssertionError(f"ragged_dot past the last group: {n} of "
                             f"{t * k} rows in the groups, the case needs "
                             "rows on both sides")
    keep = torch.arange(t * k, device="cuda")[:, None] < n
    for dn, dt in (("bfloat16", torch.bfloat16),
                   ("float32", torch.float32)):
        for shape, rows_in, cols in (("gate/up", d, ff), ("down", ff, d)):
            w = (torch.randn((local, rows_in, cols), generator=gen,
                             device="cuda") * rows_in ** -0.5).to(dt)
            x = torch.randn((t * k, rows_in), generator=gen,
                            device="cuda").to(dt)
            got = rd.ragged_dot_cuda(x, w, gs)
            got = torch.where(keep, got, torch.zeros_like(got))
            want = rd.ragged_dot_plain(x, w, gs)
            err = (got.float() - want.float()).abs()
            ok = bool((err <= TOL[dn] + TOL[dn] * want.float().abs()).all())
            log(f"  ragged_dot dbrx-132b {shape:<7} one rank's {local} of "
                f"{e} experts, {n} of {t * k} rows in the groups (the rest "
                f"past the last group, selected away) {dn:<8} "
                f"max_abs_err={float(err.max()):.3e} tol={TOL[dn]:g} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"ragged_dot past the last group "
                                     f"{shape} {dn} disagrees")
            del w
    torch.cuda.empty_cache()


def phase_mesh(ctx):
    """Tensor-parallel paged serving: two ranks (spawned processes) on
    the one card over gloo, K1 and K2 on each rank's kv heads, K4 whole
    on each rank, MLA on each rank's heads, fleets of mesh engines."""
    import gc

    import torch
    from repro_torch.launch.mesh import spawn
    smi, results = ctx["smi"], ctx["results"]
    log(f"  mesh phase on {smi}: {MESH_TP} processes time-sharing one "
        "card over a host-staged gloo reduction; every time below is "
        "that, not tensor-parallel speed")
    log(f"  mesh: published widths; Qwen2.5-7B at {MESH_QWEN_LAYERS} of "
        f"its 28 layers, DeepSeek-V2-Lite at {MESH_DEEPSEEK_LAYERS} of 27 "
        f"and Zamba2-1.2B at {MESH_ZAMBA2_LAYERS} of 38, cut so that the "
        f"script keeps inside its time limit; DBRX at {DBRX_LAYERS} of its "
        "40 layers")
    # the tp 1 runs and the ranks need the card: free every model this
    # process holds
    for k in [k for k in ctx if k not in ("card", "smi", "results")]:
        del ctx[k]
    gc.collect()
    torch.cuda.empty_cache()
    _ragged_past_check()
    refs, held = {}, {}
    t0 = time.perf_counter()
    for job in MESH_JOBS + MESH_DATA_JOBS:
        if job.get("ref") and _ref_key(job) not in refs:
            refs[_ref_key(job)] = _mesh_reference(job, held)
    held.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  mesh: tp 1 runs done in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB left allocated")
    # the dry run's table, on the host while the ranks run
    pool = ThreadPoolExecutor(1)
    table = pool.submit(_dryrun_table)
    for tp, data, jobs in ((MESH_TP, 1, MESH_JOBS),
                           (1, MESH_DATA, MESH_DATA_JOBS)):
        t0 = time.perf_counter()
        out = spawn(mesh_rank, tp, (list(jobs),), data=data, device="cuda",
                    backend="gloo", timeout=300, deadline=900)
        log(f"  mesh ranks (data {data}, tp {tp}) done in "
            f"{time.perf_counter() - t0:.1f} s (spawn to results)")
        for i, job in enumerate(jobs):
            ranks = [out[r][i] for r in range(tp * data)]
            _check_mesh_job(job, ranks, refs[_ref_key(job)]
                            if job.get("ref") else None, smi)
            if job["kind"] == "policy":
                _check_round_bytes(job, ranks, smi)
            for r in ranks:
                for name, n in r["counts"].items():
                    if n and name in KERNELS:
                        res = results.setdefault(
                            name, {"name": name, **KERNELS[name]})
                        res.setdefault("launches_by_path", {})[
                            f"serve_mesh rank {r['rank']} {job['name']}"] = n
                        res["launches"] = sum(
                            res["launches_by_path"].values())
    recs, seconds = table.result()
    pool.shutdown()
    log(f"  dryrun: {len(recs)} records (every ASSIGNED arch x shape x "
        f"both production meshes) by spec arithmetic on the host in "
        f"{seconds:.1f} s, no process group and no compile; per device: "
        "arguments, outputs, the port's collectives in one step by kind")
    for rec in recs:
        log("  " + _dryrun_line(rec))
    try:
        got = spawn(nccl_probe, MESH_TP, device="cuda", backend="nccl",
                    timeout=60, deadline=120)
    except RuntimeError as e:
        # a rank's traceback, whose last line is NCCL's own error
        lines = [ln for ln in str(e).splitlines() if ln.strip()]
        if "Duplicate GPU detected" not in lines[-1]:
            raise AssertionError("mesh: the NCCL run over two ranks on one "
                                 "card failed, but not as a duplicate "
                                 f"GPU: {lines[-1].strip()}") from e
        log(f"  mesh: NCCL refuses {MESH_TP} ranks on one card: "
            f"{lines[-1].strip()}")
    else:
        raise AssertionError(f"mesh: NCCL accepted {MESH_TP} ranks on one "
                             f"card (all_reduce gave {got}), so the mesh "
                             "phase's gloo runs are not what one card "
                             "allows")


# ------------------------------------------------------------ train_mesh
# timed steps of each bf16 run (1 since the script ran past its time
# limit with the sequence-parallel run added; 3 before it, then 2)
TRAIN_MESH_STEPS = 1
# depth cuts of the train_mesh phase (published widths, TRAIN_MESH_RUNS),
# so that the phase keeps near 180 s of the script's 1200: two ranks
# time-share the one card, every step gathers each layer's FSDP shards
# (twice: forward and re-forward) and sums their gradients over gloo,
# staged through the host.  Qwen3-1.7B and MusicGen-medium at 4 of 28 /
# 48 layers, Zamba2-1.2B at its first 6 of 38 (5 Mamba2 blocks, the
# shared block once), DeepSeek-V2-Lite at the train phase's 4 of 27
# bf16 runs: (name, arch, layers, (data, tp), global batch, seq, expert
# parallel, attn_sharding, path).  DeepSeek at B2 S2048 is 4096 tokens: the reference's
# 2-D expert-parallel branch under FSDP (at data 1 it equals the plain
# expert-parallel one).  DeepSeek's baseline branch at 2 layers (one
# dense, one MoE): its 64 experts are whole on every tp rank, so each
# step sums their gradients over tp, 6.6 GB in float32 at 4 layers
# (8585 ms a step on the H100 over gloo)
# No bf16 Qwen3 run at (2, 1), to keep the script inside its time limit
# (27-42 s, most of it the whole embedding's gradient summed over data
# through the host): Zamba2's and DeepSeek's runs hold the data axis at
# this width, Qwen3's f32 parity at (2, 1) its dense decoder.
TRAIN_MESH_RUNS = (
    ("zamba2 2x1", "zamba2-1.2b", 6, (2, 1), 4, 2048, False, "none",
     "train_mesh_hybrid"),
    ("deepseek 2d 2x1", "deepseek-v2-lite-16b", 4, (2, 1), 2, 2048, True,
     "none", "train_mesh_moe"),
    ("qwen3 1x2", "qwen3-1.7b", 4, (1, 2), 4, 2048, False, "none",
     "train_mesh"),
    # sequence-parallel attention: each rank's 1024 of the 2048 rows,
    # K5a-c at its offset against the gathered k / v
    ("qwen3 auto 1x2", "qwen3-1.7b", 4, (1, 2), 4, 2048, False, "auto",
     "train_mesh"),
    ("deepseek ep 1x2", "deepseek-v2-lite-16b", 4, (1, 2), 2, 2048, True,
     "none", "train_mesh_moe"),
    ("deepseek base 1x2", "deepseek-v2-lite-16b", 2, (1, 2), 2, 2048,
     False, "none", "train_mesh_moe"),
    ("musicgen 1x2", "musicgen-medium", 4, (1, 2), 4, 2048, False, "none",
     "train_mesh_audio"))
# f32 parity runs, 2 layers (Zamba2 4: SSM, ATTN, SSM, ATTN), S64:
# (name, arch, (data, tp), expert parallel, attn_sharding, global batch);
# a batch of 3 at data 2 is taken whole by both data ranks (replicated,
# as the reference does where the data axis does not divide it); Qwen3's
# B2 run at (2, 1) gave way to it to keep the script inside its time
# limit (Mamba2's and DeepSeek's hold the data axis on split rows)
TRAIN_MESH_PARITY = (
    ("qwen3 2x1 B3 replicated", "qwen3-1.7b", (2, 1), False, "none", 3),
    ("qwen3 1x2", "qwen3-1.7b", (1, 2), False, "none", 2),
    ("qwen3 auto 1x2", "qwen3-1.7b", (1, 2), False, "auto", 2),
    ("mamba2 2x1", "mamba2-780m", (2, 1), False, "none", 2),
    ("zamba2 1x2", "zamba2-1.2b", (1, 2), False, "none", 2),
    ("deepseek ep 1x2", "deepseek-v2-lite-16b", (1, 2), True, "none", 2),
    ("deepseek base 1x2", "deepseek-v2-lite-16b", (1, 2), False, "none", 2),
    ("deepseek 2d 2x1", "deepseek-v2-lite-16b", (2, 1), True, "none", 2),
    ("musicgen 1x2", "musicgen-medium", (1, 2), False, "none", 2))
# no Qwen2-VL run, to keep the script inside its time limit: its untied
# 152064-row embedding and head, 4.4 GB in float32, summed over data
# through the host took 26-30 s; its K5a-c instance, float32 at group 7,
# is held in the kernels phase


def _tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _bits_hash(t) -> int:
    """A hash of a tensor's bits, taken on its device: its bytes as
    int64 words (zero-padded) times the odd weights 1, 3, 5, ...,
    summed modulo 2^64.  Two tensors differing in one word differ in
    it (an odd weight times a nonzero difference is nonzero mod 2^64)."""
    import torch
    b = t.detach().contiguous().view(torch.uint8).reshape(-1)
    b = torch.cat([b, b.new_zeros((-b.numel()) % 8)])
    words = b.view(torch.int64)
    weights = 2 * torch.arange(words.numel(), device=words.device) + 1
    return int((words * weights).sum())


def _digests(params, state, specs, mesh):
    """Per leaf: (its slice's start on each dim, hashes of the bits of
    the param and of its two moments on this rank)."""
    from repro_torch.distributed.sharding import _slice
    return [(tuple(_slice(spec, mesh, d)[1] * n
                   for d, n in enumerate(t.shape)),
             (_bits_hash(t), _bits_hash(mu), _bits_hash(nu)))
            for t, mu, nu, spec in zip(_leaves(params), _leaves(state.mu),
                                       _leaves(state.nu),
                                       _spec_leaves(specs, params))]


def _spec_leaves(specs, params):
    """The specs in the order of the params' leaves (paired by key)."""
    from repro_torch.distributed.sharding import tree_map
    box = []
    tree_map(lambda t, s: box.append(s), params, specs)
    return box


def train_mesh_rank(mesh, runs, parity):
    """One rank of the train_mesh phase: the bf16 ``runs``
    (:func:`train_mesh_bf16`), then the f32 ``parity`` runs
    (:func:`train_mesh_parity`)."""
    import gc

    import torch
    bf16 = train_mesh_bf16(mesh, runs)
    gc.collect()
    torch.cuda.empty_cache()
    return bf16, train_mesh_parity(mesh, parity)


def train_mesh_bf16(mesh, runs):
    """One rank of the train_mesh phase's bf16 runs: each run's params
    drawn whole one rank at a time and sliced under FSDP, a warm-up step,
    then TRAIN_MESH_STEPS timed steps on this data rank's rows of the
    global batches (the launcher's), the launch counts set to 0 just
    before them.  Per run: losses, step ms, collectives, peak memory,
    the bytes of the rank's params and moments against the whole tree's,
    launches, digests of every leaf and moment."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_batch
    from repro_torch.models.model import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import train_step
    stats = {"s": 0.0, "n": 0, "bytes": 0}
    _time_collectives(stats)
    # (q rows, keys, q_offset) of every flash-attention call in the timed
    # steps: a sequence-parallel rank's own rows at its offset
    calls, flash = [], ops.flash_attention

    def record(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("q_offset", 0)))
        return flash(q, k, v, **kw)
    ops.flash_attention = record
    out = []
    for name, arch, layers, _, gb, seq, ep, attn, path in runs:
        cfg = _depth(get_config(arch), layers)
        par = sh.ParallelismConfig(fsdp=True, expert_parallel=ep,
                                   attn_sharding=attn)
        ctx = sh.make_ctx(mesh, par)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_run = time.perf_counter()
        params = _rank_params(mesh, cfg, par)
        state = opt.init(params)
        draw_s = time.perf_counter() - t_run
        whole = init_params(cfg, device="meta")
        ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=1)
        rng = np.random.default_rng(0)

        def batch(step):
            b = {k: torch.from_numpy(v).to(mesh.device)
                 for k, v in make_batch(cfg, gb, seq, step, rng).items()}
            return sh.shard_batch(b, cfg, mesh, par)
        losses = []
        t0 = time.perf_counter()
        _, _, m = train_step(cfg, ocfg, params, state, batch(0), ctx=ctx)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        ops.reset_launch_counts()
        stats.update(s=0.0, n=0, bytes=0)
        calls.clear()
        ms = []
        for step in range(1, TRAIN_MESH_STEPS + 1):
            b = batch(step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, m = train_step(cfg, ocfg, params, state, b, ctx=ctx)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        specs = sh.rank_specs(cfg, mesh, par)
        # the leaves the data axis shards (FSDP): this rank's bytes of
        # them, and the bytes it would hold of them without the data split
        fsdp = [(t, math.prod(sh.local_shape(
            w.shape, sh._drop_axis(s, "data"), mesh)) * t.element_size())
            for t, w, s in zip(_leaves(params), _leaves(sh.tree_map(
                lambda a, b: b, params, whole)), _spec_leaves(specs, params))
            if sh.fsdp_dim(s, par) is not None]
        out.append({
            "name": name, "rank": mesh.rank, "path": path,
            "data": mesh.shape["data"], "layers": cfg.num_layers, "batch_rows": gb // mesh.shape["data"],
            "losses": losses, "ms": ms, "coll_n": stats["n"],
            "coll_s": stats["s"], "grad_norm": float(m["grad_norm"]),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "rank_bytes": _tree_bytes(params) + _tree_bytes(state.mu)
            + _tree_bytes(state.nu),
            "whole_bytes": _tree_bytes(whole) + 2 * 4 * sum(
                t.numel() for t in _leaves(whole)),
            "fsdp_bytes": sum(t.numel() * t.element_size()
                              for t, _ in fsdp),
            "fsdp_unsplit_bytes": sum(n for _, n in fsdp),
            "counts": counts,
            "attn": attn, "seq": seq, "tp": mesh.shape["model"],
            "tp_rank": mesh.coords["model"],
            "attention_calls": sorted(set(calls)),
            "n_attention_calls": len(calls),
            "predicted": _launches_per_step(cfg),
            "digests": _digests(params, state, specs, mesh),
            "draw_s": draw_s, "warm_s": warm_s,
            "run_s": time.perf_counter() - t_run})
        del params, state
    ops.flash_attention = flash
    return out


def _sliced_aux(tp, rows):
    """The reference's load-balance loss on the MoE FFN's baseline branch
    at tp > 1, for a single-rank step: the mean of the losses of the tp
    slices of the sequence (its ``pmean`` over them), from the router
    probabilities of ``rows`` x S tokens in (row, position) order."""
    from repro_torch.models import moe
    whole = moe.load_balance_loss

    def sliced(probs, idx, top_k):
        t, e = probs.shape
        p = probs.reshape(rows, tp, t // rows // tp, e)
        return sum(whole(p[:, i].reshape(-1, e), idx, top_k)
                   for i in range(tp)) / tp
    return sliced


def train_mesh_parity(mesh, runs):
    """One rank of the train_mesh phase's f32 parity runs: one mesh step
    (loss_and_grads under the ctx, then AdamW as train_step applies it)
    against the single-rank step on the card, from the same params (seed
    3) and global batch (the run's B, S64, the launcher's; at data 2 a
    batch of 3 is whole on both data ranks).  Every rank runs the
    single-rank step too, one rank at a time, and compares its own
    slices of the gradients and updated params with the same slices of
    the single-rank ones, on the card; a leaf's gradient error is a
    share of the whole leaf's max, and its elements beyond 1e-6 are
    counted on the ranks that own each slice once (index 0 on the axes
    its spec does not name)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.train import make_batch
    from repro_torch.models.model import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import loss_and_grads
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for name, arch, _, ep, attn, rows in runs:
        t_run = time.perf_counter()
        full_cfg = get_config(arch)
        pattern = HYBRID_PARITY["pattern"] if arch == "zamba2-1.2b" \
            else full_cfg.layer_pattern[:PARITY_LAYERS]
        cfg = dataclasses.replace(full_cfg, num_layers=len(pattern),
                                  dtype="float32", layer_pattern=pattern)
        par = sh.ParallelismConfig(fsdp=True, expert_parallel=ep,
                                   attn_sharding=attn)
        ctx = sh.make_ctx(mesh, par)
        specs = sh.rank_specs(cfg, mesh, par)
        ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=1)
        batch = {k: torch.from_numpy(v).to(mesh.device)
                 for k, v in make_batch(cfg, rows, 64, 0,
                                        np.random.default_rng(5)).items()}
        leaf_specs = _spec_leaves(specs, init_params(cfg, device="meta"))
        # the single-rank step, one rank at a time (two whole f32 trees
        # with their gradients and moments would not fit the card
        # together); each rank keeps its slices of it
        for r in range(mesh.size):
            if r == mesh.rank:
                ref = _single_rank_step(cfg, ep, mesh, batch, ocfg)
                # kept on the host, a leaf brought back at a time
                mine = [(rg[sh.leaf_index(rg.shape, s, mesh)].cpu(),
                         rp[sh.leaf_index(rp.shape, s, mesh)].cpu(),
                         float(rg.abs().max()), rp.numel())
                        for rg, rp, s in zip(_leaves(ref[1]),
                                             _leaves(ref[2]), leaf_specs)]
                r_loss = ref[0]
                del ref
                torch.cuda.empty_cache()
            dist.barrier(group=mesh.control_group)
        params = sh.shard_params(init_params(cfg, seed=3, device=mesh.device),
                                 specs, mesh)
        loss, _, grads = loss_and_grads(
            cfg, params, sh.shard_batch(batch, cfg, mesh, par), ctx=ctx)
        opt.apply(ocfg, params, grads, opt.init(params), mesh=mesh,
                  specs=specs)
        g_worst, p_max, counts = 0.0, 0.0, []
        for g, p, (rg, rp, g_max, _), spec in zip(
                _leaves(grads), _leaves(params), mine, leaf_specs):
            g_worst = max(g_worst, float((g - rg.to(g.device)).abs().max())
                          / max(g_max, 1e-30))
            d = (p - rp.to(p.device)).abs()
            p_max = max(p_max, float(d.max()))
            named = {a for e in spec if e is not None
                     for a in sh._axes(e)}
            owner = all(mesh.coords[a] == 0 for a in mesh.axis_names
                        if a not in named)
            counts.append(int((d > 1e-6).sum()) if owner else 0)
        out.append({"name": name, "rank": mesh.rank, "loss": float(loss),
                    "ref_loss": r_loss, "g_worst": g_worst,
                    "p_max": p_max, "counts": counts,
                    "limits": [max(8, int(1e-3 * n)) for *_, n in mine],
                    "numel": [n for *_, n in mine],
                    "lr": ocfg.lr, "seconds": time.perf_counter() - t_run})
        del params, grads, mine
        torch.cuda.empty_cache()
    return out


def _single_rank_step(cfg, ep, mesh, batch, ocfg):
    """(loss, gradients, updated params) of one single-rank train step on
    the card from seed 3's params; on the MoE FFN's baseline branch at
    tp > 1 its load-balance loss is the mean over the tp slices of the
    sequence, as the reference's mesh step takes it."""
    from repro_torch.models import moe
    from repro_torch.models.model import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import loss_and_grads
    params = init_params(cfg, seed=3, device=mesh.device)
    whole = moe.load_balance_loss
    if cfg.moe is not None and not ep and mesh.shape["model"] > 1:
        moe.load_balance_loss = _sliced_aux(mesh.shape["model"],
                                            batch["labels"].shape[0])
    try:
        loss, _, grads = loss_and_grads(cfg, params, batch)
    finally:
        moe.load_balance_loss = whole
    opt.apply(ocfg, params, grads, opt.init(params))
    return float(loss), grads, params


def _check_train_mesh_run(run, ranks, smi, results):
    """Per rank: finite losses, alike on every rank; launches equal to
    what the layer count predicts times the steps; FSDP bytes; every
    leaf and moment alike on the ranks holding the same slice."""
    steps = TRAIN_MESH_STEPS
    name, path = run[0], run[-1]
    for r in ranks:
        coll = 100 * r["coll_s"] / (sum(r["ms"]) / 1e3)
        ms = sorted(r["ms"])[len(r["ms"]) // 2]
        log(f"  train_mesh {name} rank {r['rank']} ({smi}; {r['layers']} "
            f"layers, {r['batch_rows']} rows a rank): losses "
            f"{[round(x, 4) for x in r['losses']]}, median {ms:.1f} ms a "
            f"step, collectives {r['coll_n']} calls {r['coll_s']:.2f} s "
            f"({coll:.1f}% of the timed steps), peak "
            f"max_memory_allocated {r['peak_gb']:.2f} GB, params + moments "
            f"{r['rank_bytes'] / 1e9:.3f} GB of the whole tree's "
            f"{r['whole_bytes'] / 1e9:.3f} GB "
            f"({100 * r['rank_bytes'] / r['whole_bytes']:.1f}%); of the "
            f"FSDP-sharded params {r['fsdp_bytes'] / 1e9:.3f} GB where the "
            f"tp split alone would leave {r['fsdp_unsplit_bytes'] / 1e9:.3f}"
            f" GB (1/{r['data']} of it expected); run {r['run_s']:.1f} s "
            f"(draw {r['draw_s']:.1f}, warm-up step {r['warm_s']:.1f})")
        log("  train_mesh run: " + json.dumps(
            {k: v for k, v in r.items() if k != "digests"}))
        if not all(map(math.isfinite, r["losses"])):
            raise AssertionError(f"train_mesh {name}: non-finite loss")
        if r["fsdp_bytes"] * r["data"] != r["fsdp_unsplit_bytes"]:
            raise AssertionError(f"train_mesh {name} rank {r['rank']}: "
                                 f"{r['fsdp_bytes']} bytes of FSDP-sharded "
                                 f"params, not 1/{r['data']} of "
                                 f"{r['fsdp_unsplit_bytes']}")
        if r["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"train_mesh {name}: ranks disagree on "
                                 "the loss")
        want = {k: v * steps for k, v in r["predicted"].items()}
        bad = {k: (r["counts"].get(k, 0), v) for k, v in want.items()
               if r["counts"].get(k, 0) != v}
        if bad:
            raise AssertionError(f"train_mesh {name} rank {r['rank']}: "
                                 f"launches (got, predicted) {bad}")
        # each attention call on the rank's rows: under "auto" its
        # s/tp query rows at offset rank * s/tp against all s keys
        s, tp = r["seq"], r["tp"]
        rows = (s // tp, s, r["tp_rank"] * s // tp) if r["attn"] == "auto" \
            else (s, s, 0)
        if r["n_attention_calls"] and r["attention_calls"] != [rows]:
            raise AssertionError(f"train_mesh {name} rank {r['rank']}: "
                                 f"attention calls (q rows, keys, offset) "
                                 f"{r['attention_calls']}, not {[rows]}")
        log(f"  train_mesh {name} rank {r['rank']}: "
            f"{r['n_attention_calls']} flash-attention calls, each (q rows, "
            f"keys, q_offset) in {r['attention_calls']}")
        for k in PATHS[path]:
            if r["counts"].get(k, 0) <= 0:
                raise AssertionError(f"{k} was never launched on the {path} "
                                     f"path ({name} rank {r['rank']})")
        for k, n in r["counts"].items():
            if n and k in KERNELS:
                res = results.setdefault(k, {"name": k, **KERNELS[k]})
                res.setdefault("launches_by_path", {})[
                    f"{path} rank {r['rank']} {name}"] = n
                res["launches"] = sum(res["launches_by_path"].values())
    held = {}
    for r in ranks:
        for i, (starts, dig) in enumerate(r["digests"]):
            held.setdefault((i, starts), set()).add(dig)
    if any(len(d) != 1 for d in held.values()):
        raise AssertionError(f"train_mesh {name}: ranks holding the same "
                             "slice of a leaf hold different bits")
    shared = sum(len(r["digests"]) for r in ranks) - len(held)
    log(f"  train_mesh {name}: every leaf and moment bit for bit alike on "
        f"the ranks holding the same slice ({len(held)} (leaf, slice) "
        f"pairs over {len(ranks)} ranks, {shared} held by more than one)")


def phase_train_mesh(ctx):
    """Training under a (data, tp) mesh with FSDP: two ranks (spawned
    processes) on the one card over gloo, K5a-c on each rank's heads,
    K4 / K4b on each data rank's rows."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    smi, results = ctx["smi"], ctx["results"]
    log(f"  train_mesh phase on {smi}: 2 processes time-sharing one card "
        "over a host-staged gloo reduction: these runs check correctness "
        "and count; every time below is that, not data-parallel speed")
    log("  train_mesh: published widths; depth cut so that the phase keeps "
        "near 180 s: " + ", ".join(
            f"{r[0]} {r[2]} of {get_config(r[1]).num_layers} layers"
            for r in TRAIN_MESH_RUNS))
    for k in [k for k in ctx if k not in ("card", "smi", "results")]:
        del ctx[k]
    gc.collect()
    torch.cuda.empty_cache()
    for shape in ((2, 1), (1, 2)):
        t0 = time.perf_counter()
        runs = [r for r in TRAIN_MESH_RUNS if r[3] == shape]
        parity = [r for r in TRAIN_MESH_PARITY if r[2] == shape]
        out = spawn(train_mesh_rank, shape[1], (runs, parity),
                    data=shape[0], device="cuda", backend="gloo",
                    timeout=300, deadline=900)
        log(f"  train_mesh bf16 and f32 runs at (data {shape[0]}, tp "
            f"{shape[1]}) done in {time.perf_counter() - t0:.1f} s (spawn "
            "to results)")
        for i, run in enumerate(runs):
            _check_train_mesh_run(run, [o[0][i] for o in out], smi, results)
        done = {run[0]: [o[0][i] for o in out] for i, run in enumerate(runs)}
        if "qwen3 auto 1x2" in done:
            auto, none = done["qwen3 auto 1x2"], done["qwen3 1x2"]
            med = lambda r: sorted(r["ms"])[len(r["ms"]) // 2]
            for a, n in zip(auto, none):
                log(f"  train_mesh qwen3 1x2 auto vs none rank {a['rank']} "
                    f"({smi}): median {med(a):.1f} vs {med(n):.1f} ms a "
                    f"step, peak max_memory_allocated {a['peak_gb']:.2f} vs "
                    f"{n['peak_gb']:.2f} GB, collectives {a['coll_n']} vs "
                    f"{n['coll_n']} calls, {a['coll_s']:.2f} vs "
                    f"{n['coll_s']:.2f} s")
        for i, run in enumerate(parity):
            ranks = [o[1][i] for o in out]
            r, lr = ranks[0], ranks[0]["lr"]
            g_worst = max(x["g_worst"] for x in ranks)
            p_max = max(x["p_max"] for x in ranks)
            beyond = [sum(c) for c in zip(*(x["counts"] for x in ranks))]
            over = [(n, lim, numel) for n, lim, numel in zip(
                beyond, r["limits"], r["numel"]) if n > lim]
            ok = (abs(r["loss"] - r["ref_loss"]) <= 1e-5 * abs(r["ref_loss"])
                  and g_worst <= 1e-4 and p_max <= 2 * lr and not over
                  and all(x["loss"] == r["loss"] for x in ranks))
            log(f"  train_mesh parity {run[0]} f32 B{run[5]} S64 ({smi}): "
                f"loss "
                f"mesh {r['loss']:.6f} single rank {r['ref_loss']:.6f} "
                f"(limit 1e-5 relative); worst gradient diff / leaf max "
                f"{g_worst:.3e} (limit 1e-4); updated params max |diff| "
                f"{p_max:.3e} (limit {2 * lr:.1e}), {sum(beyond)} elements "
                f"beyond 1e-6, leaves over max(8, 1e-3 numel): {over}; "
                f"{max(x['seconds'] for x in ranks):.1f} s "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"train_mesh parity {run[0]}: out of "
                                     "bounds")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(smi)
    log(f"device: {card} x{torch.cuda.device_count()} torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    ctx = {"card": card, "smi": smi, "results": {}}
    t = time.perf_counter()
    built = _build.build()
    log(f"build: {built['built']} sources in {built['seconds']:.1f} s "
        f"({time.perf_counter() - t:.1f} s with setup)")
    for source in dict.fromkeys(_build.SOURCES.values()):
        for line in _build.compiler_log(source):
            log(f"  {source}: {line}")
    # every bf16 flash kernel runs on the tensor cores, or the run fails
    tc = tensor_core_counts()
    for source, fns in tc.items():
        for fn, n in fns.items():
            log(f"  {source}: {fn}: tensor-core instructions in SASS "
                f"(cuobjdump -sass): HGMMA {n['HGMMA']}, HMMA {n['HMMA']}")
    tc_rows = check_tensor_cores(tc)
    ssd_sass, ssd_ptxas = check_ssd_build(tc)
    for phase, fn in (("kernels", lambda: phase_kernels(ctx["results"])),
                      ("anneal", lambda: phase_anneal(ctx)),
                      ("serve", lambda: phase_serve(ctx)),
                      ("stream", lambda: phase_stream(ctx)),
                      ("ssm", lambda: phase_ssm(ctx)),
                      ("hybrid", lambda: phase_hybrid(ctx)),
                      ("moe", lambda: phase_moe(ctx)),
                      ("int8", lambda: phase_int8(ctx)),
                      ("train", lambda: phase_train(ctx)),
                      ("parity", lambda: phase_parity(ctx)),
                      ("mesh", lambda: phase_mesh(ctx)),
                      ("train_mesh", lambda: phase_train_mesh(ctx))):
        if phase not in phases:
            continue
        t = time.perf_counter()
        log(f"phase {phase}:")
        fn()
        log(f"phase {phase}: done in {time.perf_counter() - t:.1f} s")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    kernels = []
    for name in KERNELS:
        r = {"name": name, **KERNELS[name], "launches": None,
             "max_abs_err": None, "ms": None, "plain_ms": None,
             "bound_ms": None, "bound_by": None, "library_ms": None,
             **ctx["results"].get(name, {})}
        r["kernel_ms"] = r["ms"]
        if name in tc_rows:
            r["sass_tensor_core_instructions"] = tc_rows[name]
            source, family, _ = TC_FAMILIES[name]
            r["ptxas"] = [ln for ln in _build.compiler_log(source)
                          if ln.startswith(family)]
        if name == "ssd_scan":
            r["sass_tensor_core_instructions"] = ssd_sass
            r["ptxas"] = ssd_ptxas
        if name in NO_LIBRARY:
            r["library_none_because"] = NO_LIBRARY[name]
        kernels.append(r)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
