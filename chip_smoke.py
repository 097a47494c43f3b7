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
           issues HGMMA and every bf16 split-KV decode instance (dense and
           paged) HMMA, at hd 64, 80 and 128 (float32 stays on the scalar
           blocks, and no scalar decode instance takes bf16 q and K/V),
           and every SSD scan kernel function (C·Bᵀ and scan, f32 and
           bf16) issues HMMA (3xTF32 mma.sync) with 0 bytes spilled
  kernels  each kernel vs its plain version on the card, bf16 and f32,
           at Qwen2.5-7B shapes and at head_dim 80 (h2o-danube's 32 q /
           8 kv heads); the bf16 paged and dense decode (split-KV) also
           on 2048-slot rings split many ways (lengths 1 to 2048, a
           wrapped ring under a window of 1024, group 12, hd 80, the
           timed B16 x 2048), each bitwise equal across two launches and
           its split plan printed; decode times also as device time from
           CUDA-graph replays, beside SDPA's; the flash forward (K2) and
           the training forward
           (K5a) over S 16/100/128/2048, GQA groups 1/2/4/7/12, hd
           64/80/128, windows 0/32/64 and B up to 4 (the train shape),
           each bitwise equal across two launches; CUDA-event times
           (plain, kernel, kernel, plain) with achieved TFLOP/s at the
           serve path's shape and at one long shape; the training
           kernels (forward + lse, dq, dk/dv) over causal and windowed
           cases, GQA groups 1/2/4/7/12, S 16/100/128/300/520/1000/2048
           (ragged tiles, both dq block sizes), hd 64/80/128, timed
           at the train shape (B4 S2048 H16 KV8 hd128 bf16) and at
           S=128, and dq/dk/dv checked bitwise repeatable; the SSD scan
           at the Mamba2-780M widths (nh 48, hd 64, ds 128), B 1/4 x S
           16/100/256/2048, and at the edges of its decomposition (S 1,
           63, 64, 65; B 3; nh 7; hd 64 with ds 64, hd 32, hd 48 with ds
           80; rows of no whole 16-byte pieces, hd 20 with ds 36 and hd
           33 with ds 37), each with and without an initial state and bitwise
           equal across two launches, timed at the serve shapes (B1 S96;
           B1 S32 from a state) and at B4 S2048, eager and as device
           time from CUDA-graph replays
  serve    Qwen2.5-7B at its published config (28 layers, bf16, random
           seeded weights): latency-model fit, then run_policy under
           fcfs, slo-reanneal, slo-preempt + chunked:32, and a multi-turn
           fcfs run with prefix hits, on the paged engine; then the same
           three policy runs on the dense engine (paged=False); then
           h2o-danube-1.8b (24 layers, 32 q / 8 kv heads of head_dim 80,
           bf16, random seeded weights) under fcfs on the paged engine
  ssm      Mamba2-780M at its published config (48 layers, d 1536, bf16,
           random seeded weights) on the dense engine: latency-model fit,
           then fcfs, slo-reanneal, slo-preempt + chunked:32; the SSD scan
           launches once per layer per prefill pass; then one prefill of
           a 2048-token prompt at full depth (B1), timed, with the SSD
           scan's launches and share of it (launches x device time)
  int8     the same model: one 128-token prompt and 32 greedy decode
           steps through an int8 paged cache and an int8 dense cache,
           each against the same run on a bf16 cache
  train    Qwen3-1.7B at its published config (28 layers, bf16, random
           seeded weights): AdamW lr 3e-4, B=4, S=2048, per-layer remat;
           one warm-up step (attention-weight gradients checked finite
           and nonzero), then timed steps: loss, ms, tokens/s, peak memory
  parity   Qwen2.5-7B at full width, 2 layers, float32, TF32 off: the
           paged and the dense engine on cuda (kernels) and on cpu
           (plain versions) must emit identical tokens; int8 paged and
           dense decode logits, cuda vs cpu, are reported and bounded;
           one train step of Qwen3-1.7B at 2 layers in float32, cuda vs
           cpu: loss, every gradient and the updated params, bounded;
           Mamba2-780M at 2 layers in float32: the dense engine's tokens
           under fcfs and slo-preempt + chunked:32, and the logits of one
           prefill and 4 decode steps, bounded
Each path (paged serve, dense serve, h2o-danube serve, Mamba2 serve,
int8, train) is driven with the
launch counts set to 0 just before it and read just after; every kernel
must launch on the path that runs it.  The line before the last is the
kernels JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "serve", "ssm", "int8", "train",
          "parity")
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
}
TRAIN_KERNELS = ("flash_attention_fwd_lse", "flash_attention_dq",
                 "flash_attention_dkv")
# the path each kernel must launch on (counts reset before, read after)
PATHS = {"serve_paged": ("decode_attention_paged", "flash_attention"),
         "serve_dense": ("flash_attention", "decode_attention"),
         "serve_hd80": ("decode_attention_paged", "flash_attention"),
         "serve_ssm": ("ssd_scan",),
         "int8": ("decode_attention_paged_q8", "decode_attention_q8"),
         "train": TRAIN_KERNELS}
# the int8 KV library yardstick: no single PyTorch call dequantizes int8
# K/V with per-row scales inside attention
NO_LIBRARY = {
    "decode_attention_paged": "no single PyTorch call pages through a "
                              "block table",
    "decode_attention_paged_q8": "no single PyTorch call pages through a "
                                 "block table over int8 K/V",
    "decode_attention_q8": "no single PyTorch call attends over int8 K/V "
                           "with per-row scales",
    "ssd_scan": "no single PyTorch call computes the SSD chunk scan"}


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
                   "ssd_scan"):
        sass = subprocess.run(
            [tool, "-sass", str(_build.library_path(source))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        counts[source] = {
            _build.kernel_label(fn.split(None, 1)[0]):
            {op: len(re.findall(rf"\b{op}\b", fn)) for op in ("HGMMA", "HMMA")}
            for fn in re.split(r"\bFunction : ", sass)[1:]}
    return counts


# the tensor-core function family behind each attention kernel's bf16
# instances, by (library, family, instruction); every head_dim must have
# instances and each must issue the instruction (wgmma for the flash
# kernels, mma.sync for the split-KV decode)
TC_FAMILIES = {
    "flash_attention": ("flash_attention", "flash_fwd_tc_kernel", "HGMMA"),
    "flash_attention_fwd_lse": ("flash_attention_bwd", "flash_fwd_tc_kernel",
                                "HGMMA"),
    "flash_attention_dq": ("flash_attention_bwd", "flash_dq_tc_kernel",
                           "HGMMA"),
    "flash_attention_dkv": ("flash_attention_bwd", "flash_dkv_tc_kernel",
                            "HGMMA"),
    "decode_attention": ("decode_attention", "decode_split_kernel", "HMMA"),
    "decode_attention_paged": ("decode_attention_paged",
                               "decode_split_kernel", "HMMA")}
# the scalar flash blocks, which only the float32 parity path may reach
SCALAR_FAMILIES = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")
# the scalar decode block keeps float32 and int8-KV instances only
SCALAR_DECODE_BF16 = "decode_kernel<__nv_bfloat16, __nv_bfloat16,"


def check_tensor_cores(tc):
    """Fail unless every bf16 instance of each TC_FAMILIES entry (hd 64,
    80 and 128) has its tensor-core instruction in its SASS, every scalar
    flash instance is float32 and no scalar decode instance takes bf16 q
    with bf16 K/V.  -> {kernel: {function: counts}} for the kernels
    JSON."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    per_kernel = {}
    for name, (source, family, op) in TC_FAMILIES.items():
        fns = {fn: n for fn, n in tc[source].items()
               if fn.startswith(family + "<")}
        hds = {int(fn[len(family) + 1:].split(",")[0].rstrip(">"))
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
                                     "bf16 q and bf16 K/V")
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
    return bound(nbytes, 4 * H * HD * sum(attended), dtype_name)


def decode_cost(args, window, dtype_name):
    q, k, _, bt, ln = args
    return decode_bound(q, ln, bt.shape[1] * PAGE, KV * HD * k.element_size(),
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
    q, _, _, _, _, bt, ln = args
    return decode_bound(q, ln, bt.shape[1] * PAGE, KV * (HD + 2),
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
    return decode_bound(q, nv, k.shape[1], KV * HD * k.element_size(),
                        nv.numel() * 4, window, dtype_name)


def dense_q8_cost(args, window, dtype_name):
    q, k, _, _, _, nv = args
    return decode_bound(q, nv, k.shape[1], KV * (HD + 2), nv.numel() * 4,
                        window, dtype_name)


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
        rep = H // KV
        ke = ks.repeat_interleave(rep, dim=1)
        ve = vs.repeat_interleave(rep, dim=1)
        return lambda: F.scaled_dot_product_attention(qs, ke, ve,
                                                      attn_mask=mask)


# the bf16 decode kernels on the split-KV tensor-core block
SPLIT_KERNELS = ("decode_attention_paged", "decode_attention")


def decode_split_plan(args, sms):
    """The (splits, split_len) the bf16 wrapper of a paged (q, k, v,
    block_tables, lengths) or dense (q, k, v, n_valid) decode call
    picks on a card of ``sms`` SMs."""
    from repro_torch.kernels.decode_attention_paged import split_plan
    q, k = args[0], args[1]
    if len(args) == 5:
        return split_plan(q.shape[0], k.shape[2], args[3].shape[1]
                          * k.shape[1], page=k.shape[1], sms=sms)
    return split_plan(q.shape[0], k.shape[2], k.shape[1], sms=sms)


def flash_inputs(b, s, dtype, window, gen):
    import torch
    kw = dict(device="cuda", dtype=dtype)
    q = torch.randn((b, s, H, HD), generator=gen, **kw)
    k = torch.randn((b, s, KV, HD), generator=gen, **kw)
    v = torch.randn((b, s, KV, HD), generator=gen, **kw)
    return (q, k, v), {"causal": True, "window": window}


def attn_flops(q, window, per_pair=4):
    """``per_pair`` flops per q head x hd x attended (q, key) pair of
    causal attention over q [B,S,H,hd] (4 for a forward: QKᵀ and PV)."""
    b, s, h, hd = q.shape
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s))
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


def flash_train_cost(name, q, k, window, dtype_name):
    """Bound of one training-kernel call: each input read once and each
    output written once (q-sized out/dout/dq, k-sized dk/dv, f32
    [B,H,S] lse and delta); TRAIN_PER_PAIR flops per q head x hd x
    attended pair."""
    b, s, h, hd = q.shape
    qb, kb, rows = q.numel() * q.element_size(), \
        k.numel() * k.element_size(), b * h * s * 4
    nbytes = {"flash_attention_fwd_lse": 2 * qb + 2 * kb + rows,
              "flash_attention_dq": 3 * qb + 2 * kb + 2 * rows,
              "flash_attention_dkv": 2 * qb + 4 * kb + 2 * rows}[name]
    return bound(nbytes, attn_flops(q, window, TRAIN_PER_PAIR[name]),
                 dtype_name)


# K2 and K5a cases (label, b, s, h, kv, hd, window): both q-tile sizes of
# the bf16 block (64 rows where 128-row tiles would not fill the SMs, else
# 128) with ragged last tiles; GQA groups 1/2/4/7/12 (starcoder2's 24
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
    shape the train phase gives them (B4 S2048 H16 KV8 hd128); then
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
    shapes = (("train", "B4 S2048 H16 KV8 hd128 causal bf16", 2048, 3),
              ("S128", "B4 S128 H16 KV8 hd128 causal bf16", 128, 50))
    for key, shape, s, iters in shapes:
        q, k, v, do = flash_train_inputs(4, s, 16, 8, 128, bf, gen)
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
                results[name]["S128"] = r
            log(f"  {name}: kernel {k_ms:.4f} ms "
                f"({r['achieved_tflops']:.1f} TFLOP/s), plain {p_ms:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}), library "
                f"{r['library_ms']:.4f} ms at {shape}"
                + (f"; delta+dq+dkv {pair:.4f} ms" if "pair_ms" in r
                   else ""))


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
    for key, b, s, with_state, iters in (("serve", 1, 96, False, 50),
                                         ("chunk", 1, 32, True, 50),
                                         ("long", 4, 2048, False, 5)):
        x, d, A, B, C, st = ssd_inputs(b, s, f32, with_state, gen)

        def kernel():
            return ss.ssd_scan_cuda(x, d, A, B, C, init_state=st)
        k_ms, p_ms = alternate(
            lambda: ss.ssd_scan_plain(x, d, A, B, C, chunk=256,
                                      init_state=st), kernel, iters)
        dev_ms = graph_ms(kernel, iters)
        (b_ms, b_by), (tc_ms, tc_by), flops = ssd_cost(x, B, st, "float32")
        row = {"shape": f"B{b} S{s} nh48 hd64 ds128 f32"
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
    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{r['library_ms']} ms at {r['shape']}; long: "
            f"{json.dumps(r['long'])}")
    check_train_kernels(results, fwd_worst)
    check_ssd_kernel(results)


def _serve_run(cfg, params, model, pairs, policy, discipline, paged,
               profiler=None):
    import torch
    from repro_torch.core.policies import make
    from repro_torch.engine.engine import Engine
    from repro_torch.launch.serve import _to_rts
    rts = _to_rts(pairs)
    eng = Engine(cfg, params, max_slots=4, max_seq_len=256, paged=paged,
                 profiler=profiler, device="cuda")
    pol = make(policy, model=model, max_batch=4)
    out = eng.run_policy(rts, pol, discipline=discipline, model=model)
    torch.cuda.synchronize()
    for rt in rts:
        got = out[rt.req_id]["tokens"]
        if len(got) != rt.max_new_tokens:
            raise AssertionError(f"request {rt.req_id}: {len(got)} of "
                                 f"{rt.max_new_tokens} tokens")
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
        if n:
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


def long_prefill(cfg, params, results, s=2048, runs=3):
    """One prefill of an ``s``-token prompt at full depth (B1, into a
    dense cache, the LM head on the last position, as the engine
    prefills): the host clock around each synchronized pass, median of
    ``runs`` after one warm-up; the SSD scan's launches in one pass, its
    device time at that shape (float32 x, B, C as the model hands it,
    CUDA-graph replays) and its share of the pass (launches x device
    time over the pass)."""
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
    if k4 != cfg.num_layers or set(counts) != {"ssd_scan"}:
        raise AssertionError(f"long prefill: {k4} ssd_scan launches per "
                             f"pass, counts {counts}")
    nh, hd, ds = (cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim,
                  cfg.ssm.d_state)
    x, d, A, B, C, _ = ssd_inputs(1, s, torch.float32, False, gen, nh=nh,
                                  hd=hd, ds=ds)
    dev = graph_ms(lambda: ss.ssd_scan_cuda(x, d, A, B, C), 10)
    ms = statistics.median(times)
    out = {"prompt": s, "batch": 1, "layers": cfg.num_layers,
           "prefill_ms": ms, "prefill_ms_runs": times,
           "ssd_scan_launches": k4, "ssd_scan_device_ms": dev,
           "ssd_scan_share": k4 * dev / ms}
    results.setdefault("ssd_scan", {"name": "ssd_scan",
                                    **KERNELS["ssd_scan"]})["prefill"] = out
    log(f"  ssm prefill B1 S{s} x {cfg.num_layers} layers: {ms:.2f} ms "
        f"(median of {runs}: {', '.join(f'{t:.2f}' for t in times)}); "
        f"ssd_scan {k4} launches x {dev:.4f} ms device = "
        f"{k4 * dev:.2f} ms, {100 * out['ssd_scan_share']:.1f}% of it")
    return out


def _decode_run(cfg, params, prompt, steps, quantized, layout,
                tokens=None):
    """Prefill ``prompt`` then ``steps`` decode steps through a paged or
    a dense cache (int8 when ``quantized``).  Decode inputs are
    ``tokens`` when given (teacher forcing), else greedy.  Returns
    (logits [steps+1, V] float32 on the CPU, greedy tokens)."""
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
        lg, cache = step(params, cfg, tokens=torch.tensor(
            [[nxt]], dtype=torch.int32, device=dev), cache=cache)
        rows.append(lg[0, -1].float())
    return torch.stack(rows).cpu(), greedy


def phase_int8(ctx):
    """int8 KV at full width: K3 (paged) and K7 (dense) on the path, each
    held against the same run on a bf16 cache fed the same tokens."""
    import torch
    cfg, params = full_model(ctx)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen,
                           device="cuda", dtype=torch.int32)
    steps = 32
    layouts = ("paged", "dense")
    with torch.no_grad():
        ref = {layout: _decode_run(cfg, params, prompt, steps, False, layout)
               for layout in layouts}
        q8 = count_path(ctx["results"], "int8", lambda: {
            layout: _decode_run(cfg, params, prompt, steps, True, layout,
                                tokens=ref[layout][1])
            for layout in layouts})
    report = {}
    for layout in ("paged", "dense"):
        want, got = ref[layout][0], q8[layout][0]
        if not torch.isfinite(got).all():
            raise AssertionError(f"int8 {layout}: non-finite logits")
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        report[layout] = {"max_abs_logit_diff": diff,
                          "max_abs_logit": scale, "top1_agreement": agree}
        log(f"  int8 {layout:<5} {cfg.name} 128-token prompt + {steps} "
            f"decode steps vs bf16 cache: max |logit diff|={diff:.4f} "
            f"(max |logit| {scale:.3f}), top-1 agreement={agree:.3f}")
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


def _ssm_parity():
    """Mamba2-780M at full width, 2 layers, float32, TF32 off, on cuda
    (the SSD scan kernel) and on cpu (its plain version): the dense
    engine's greedy tokens per request must be identical under fcfs and
    slo-preempt + chunked:32 (the paper's table as latency model on both,
    so the two devices plan alike), and the logits of one prefill and 4
    decode steps (cuda's greedy tokens fed to both) must agree within
    1e-4 of max |cpu logit|: f32 sums in other orders (the kernel's own
    bound against plain is 5e-5 of max |plain|; the matmuls around it and
    the second layer add their own order)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.latency_model import PAPER_TABLE2
    from repro_torch.core.policies import make
    from repro_torch.data.synthetic import sample_serve_workload
    from repro_torch.engine.engine import Engine
    from repro_torch.launch.serve import _to_rts
    from repro_torch.models.model import init_params
    cfg = dataclasses.replace(get_config("mamba2-780m"), num_layers=2,
                              layer_pattern=(), dtype="float32")
    p_gpu = init_params(cfg, seed=1, device="cuda")
    p_cpu = _map(p_gpu, lambda t: t.cpu())
    for policy, disc in (("fcfs", "stall"), ("slo-preempt", "chunked:32")):
        tokens = {}
        for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            rts = _to_rts(sample_serve_workload(4, cfg.vocab_size, seed=2))
            for rt in rts:
                rt.max_new_tokens = 8
            eng = Engine(cfg, params, max_slots=4, max_seq_len=256,
                         device=dev)
            out = eng.run_policy(rts, make(policy, model=PAPER_TABLE2,
                                           max_batch=4), discipline=disc)
            tokens[dev] = {k: v["tokens"] for k, v in out.items()}
        same = tokens["cuda"] == tokens["cpu"]
        log(f"  parity {cfg.name} x2 layers f32 dense engine {policy} "
            f"{disc}: tokens identical={same} "
            f"({sum(len(v) for v in tokens['cuda'].values())} tokens)")
        if not same:
            raise AssertionError(f"ssm {policy} {disc}: cuda vs cpu tokens "
                                 f"differ: {tokens}")
    _, prompt = sample_serve_workload(1, cfg.vocab_size, seed=3)[0]
    prompt = torch.from_numpy(prompt[None]).to(torch.int32)
    with torch.no_grad():
        g, toks = _decode_run(cfg, p_gpu, prompt.cuda(), 4, False, "dense")
        c, _ = _decode_run(cfg, p_cpu, prompt, 4, False, "dense",
                           tokens=toks)
    diffs = (g - c).abs().amax(-1)
    scale = float(c.abs().max())
    limit = 1e-4 * max(scale, 1.0)
    log(f"  parity {cfg.name} x2 layers f32: {prompt.shape[1]}-token "
        f"prefill + 4 decode steps, max |logit diff| cuda vs cpu per step "
        f"{[f'{float(d):.3e}' for d in diffs]} (max |logit| {scale:.3f}, "
        f"limit {limit:.3e})")
    if not float(diffs.max()) <= limit:
        raise AssertionError(f"ssm logits: cuda vs cpu differ by "
                             f"{float(diffs.max())} > {limit}")


def _train_parity():
    """One train step of Qwen3-1.7B at full width, 2 layers, float32, TF32
    off, on cuda (kernels) and on cpu (plain versions) from the same
    params and batch.  Bounds, stated before the first measurement:
    loss within 1e-5 of its value (f32 matmuls summed in other orders);
    each gradient within 1e-4 of its leaf's max |cpu gradient| (the
    attention kernels' own f32 bound is 5e-5, downstream sums add their
    own order); updated params within 1e-6 in every leaf but at most
    max(8, 1e-3 numel) of its elements, and within 2 lr everywhere: the
    first AdamW step moves an element by lr·g/(|g|+eps), a sign for all
    but the smallest gradients, so an element whose gradient is within
    rounding of 0 may move the other way.  The count is per leaf, so a
    leaf updated wrongly as a whole fails, a norm scale's included."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import loss_and_grads
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=2,
                              layer_pattern=(), dtype="float32")
    p_gpu = init_params(cfg, seed=3, device="cuda")
    p_cpu = _map(p_gpu, lambda t: t.cpu())
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                         dtype=torch.int32)
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=1)
    out = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        b = {"tokens": toks.to(dev), "labels": toks.to(dev)}
        loss, _, grads = loss_and_grads(cfg, params, b)
        opt.apply(ocfg, params, grads, opt.init(params))
        out[dev] = (float(loss), _map(grads, lambda t: t.cpu()),
                    _map(params, lambda t: t.cpu()))
    (lg, gg, pg), (lc, gc, pc) = out["cuda"], out["cpu"]
    g_worst = max(float((a - c).abs().max()) / max(float(c.abs().max()),
                                                   1e-30)
                  for a, c in zip(opt.leaves(gg), opt.leaves(gc)))
    lr = ocfg.lr
    p_max = max(float((a - c).abs().max())
                for a, c in zip(opt.leaves(pg), opt.leaves(pc)))
    # (elements beyond 1e-6, allowed, numel) per leaf
    counts = [(int(((a - c).abs() > 1e-6).sum()),
               max(8, int(1e-3 * c.numel())), c.numel())
              for a, c in zip(opt.leaves(pg), opt.leaves(pc))]
    n, lim, numel = max(counts, key=lambda t: t[0] / t[1])
    log(f"  parity {cfg.name} x2 layers f32 train step B2 S64: loss cuda "
        f"{lg:.6f} cpu {lc:.6f} (|diff| {abs(lg - lc):.3e}, limit "
        f"{1e-5 * abs(lc):.3e}); worst gradient diff / leaf max "
        f"{g_worst:.3e} (limit 1e-4); updated params max |diff| "
        f"{p_max:.3e} (limit {2 * lr:.1e}), "
        f"{sum(c[0] for c in counts)} elements beyond 1e-6 over "
        f"{len(counts)} leaves; nearest its limit: {n} of {numel} "
        f"(limit {lim})")
    if not (abs(lg - lc) <= 1e-5 * abs(lc) and g_worst <= 1e-4
            and p_max <= 2 * lr and all(c[0] <= c[1] for c in counts)):
        raise AssertionError("train step: cuda vs cpu out of bounds")


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
    ctx = {"card": card, "results": {}}
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
                      ("serve", lambda: phase_serve(ctx)),
                      ("ssm", lambda: phase_ssm(ctx)),
                      ("int8", lambda: phase_int8(ctx)),
                      ("train", lambda: phase_train(ctx)),
                      ("parity", lambda: phase_parity(ctx))):
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
                          if ln.startswith(family + "<")]
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
