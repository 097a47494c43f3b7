#!/usr/bin/env python3
"""Where the SSD chunk scan's time goes (``ssd_scan``, K4), on one NVIDIA
GPU: builds copies of ``src/repro_torch/kernels/csrc/ssd_scan.cu`` with
another column plan, or patched to leave one piece of work out, and
times them beside the kernel as it is.

    python3 tools/ssd_variants.py [--bwd] [--out variants.json]

Variants (the tool checks no result: only their times mean anything):
  kernel       the source as it is (32 columns of head_dim a scan block)
  cols16       16 columns a block (-DSSD_SCAN_COLS=16: 192 blocks at
               B1 x 48 heads, a full wave on 132 SMs)
  cols64       64 columns a block (-DSSD_SCAN_COLS=64: one block a head)
and patched copies of the kernel:
  one_pass     one TF32 product (hi·hi) instead of three (~11 bits)
  cvt_split    the TF32 split by two cvt.rna.tf32.f32 per operand
               instead of the integer operations
  masked_copy  every copy through the masked path (the kernel takes an
               unmasked one for whole rows)
  three_stages copies two chunks ahead through a third stage (140 KB of
               shared memory: one block per SM)
  no_bc_copy   B and C copied in for the first chunk only (wrong result)
  no_copy      nothing copied in after the first chunk (x, B, C, C·Bᵀ;
               wrong result)
A patch is an exact piece of the source or of the header it includes
(``csrc/ssd_tc.cuh``); the tool stops if it no longer applies.  Each
library is built with the repo's nvcc flags under ``build/ssd_variants/``
(one nvcc each, all started together) and called through the same C
entry point as the wrapper, on ``chip_smoke.py``'s inputs
(``ssd_inputs``: the Mamba2-780M widths, nh 48, hd 64, ds 128, float32
x, B and C): B1 S96, B1 S32 from a state, B1 S2048 and B4 S2048, as
device time from CUDA-graph replays (``tools/decode_ab.py``'s
``device_ms``).

``--bwd`` times the backward's plans instead (``csrc/ssd_scan_bwd.cu``,
K4b) at the train shapes of Mamba2-780M and Zamba2-1.2B (B4 S2048, hd 64;
nh 48 / ds 128 and nh 64 / ds 64): column slices of 32 (the build) or 16
(-DSSD_BWD_COLS=16) by clusters of 4, 2 or 1 heads, each call with the
wrapper's sums of the partials; and patched copies of the build's plan:
  bwd_no_chunks    C·Bᵀ and the states only (no reverse launch)
  bwd_no_reduce    no cluster sums of the dB / dC partials (the two
                   cluster barriers a chunk kept; wrong result)
  bwd_no_cluster   neither the sums nor the cluster barriers
  bwd_one_pass     one TF32 product (hi·hi) instead of three
Prints the card's name and power limit and one line per variant and
shape; imports nothing of JAX."""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc")
SRC, HEADER, BWD = (os.path.join(CSRC, f) for f in (
    "ssd_scan.cu", "ssd_tc.cuh", "ssd_scan_bwd.cu"))
OUT = os.path.join(HERE, "build", "ssd_variants")
# (label, batch, seq, from a state, calls)
SHAPES = (("B1 S96", 1, 96, False, 50), ("B1 S32 +state", 1, 32, True, 50),
          ("B1 S2048", 1, 2048, False, 5), ("B4 S2048", 4, 2048, False, 5))

MMA3 = """  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);"""
SPLIT = """  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) + 0x1000u;"""
CVT_SPLIT = """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(rest));"""
FAST_COPY = "  if (vec && nrows == kQ && cols == kWidth) {"
STAGE_NEXT = """    if (c + 1 < nc) {
      stage(c + 1, (c + 1) & 1);
      stage_cb(c + 1, (c + 1) & 1);
    }"""
STAGE_BC = """    stage_rows<T, DSP, BP, kThr>(sB(st), Bm + row * DS, DS, nrows, DS,
                                 vec_ok, tid);
    stage_rows<T, DSP, BP, kThr>(sC(st), Cm + row * DS, DS, nrows, DS,
                                 vec_ok, tid);"""
THREE_STAGES = [
    ("  static constexpr size_t kBytes = 2 * kStage + kPart;",
     "  static constexpr size_t kBytes = 3 * kStage + kPart;"),
    ("  float* sPart = reinterpret_cast<float*>(smem + 2 * L::kStage);",
     "  float* sPart = reinterpret_cast<float*>(smem + 3 * L::kStage);"),
    ("""  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      stage(c + 1, (c + 1) & 1);
      stage_cb(c + 1, (c + 1) & 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int sg = c & 1;""", """  cp_async_commit();
  if (nc > 1) {
    stage(1, 1);
    stage_cb(1, 1);
  }
  cp_async_commit();
  for (int c = 0; c < nc; ++c) {
    if (c + 2 < nc) {
      stage(c + 2, (c + 2) % 3);
      stage_cb(c + 2, (c + 2) % 3);
    }
    cp_async_commit();
    cp_async_wait<2>();
    __syncthreads();
    const int sg = c % 3;"""),
    ("__global__ void __launch_bounds__(kScanThreads, 2)",
     "__global__ void __launch_bounds__(kScanThreads, 1)"),
]
# name -> (columns a scan block, patches)
VARIANTS = {
    "kernel": (32, []),
    "cols16": (16, []),
    "cols64": (64, []),
    "one_pass": (32, [(MMA3, "  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);")]),
    "cvt_split": (32, [(SPLIT, CVT_SPLIT)]),
    "masked_copy": (32, [(FAST_COPY, "  if (false) {")]),
    "three_stages": (32, THREE_STAGES),
    "no_bc_copy": (32, [(STAGE_BC,
                         "    if (c == 0) {\n" + STAGE_BC + "\n    }")]),
    "no_copy": (32, [(STAGE_NEXT, "")]),
}


REDUCE = "      for (int e = tid; e < (rhi - rlo) * V; e += kBwdThreads) {"
ARRIVE = ('  asm volatile("barrier.cluster.arrive.release.aligned;\\n" '
          '::: "memory");')
WAIT = ('  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" '
        '::: "memory");')
CHUNKS = "  return cudaLaunchKernelEx(&cfg, ssd_bwd_chunk_kernel<DSP>,"
# backward variants: name -> (columns a block, heads a cluster, patches)
BWD_VARIANTS = {
    "cols32_group4": (32, 4, []), "cols32_group2": (32, 2, []),
    "cols32_group1": (32, 1, []), "cols16_group2": (16, 2, []),
    "cols16_group1": (16, 1, []),
    "bwd_no_chunks": (32, 4, [(CHUNKS, "  if (cfg.numAttrs) return "
                                       "cudaSuccess;\n" + CHUNKS)]),
    "bwd_no_reduce": (32, 4, [(REDUCE, REDUCE.replace("(rhi - rlo) * V",
                                                      "0"))]),
    "bwd_no_cluster": (32, 4, [(REDUCE, REDUCE.replace("(rhi - rlo) * V",
                                                       "0")),
                               (ARRIVE, ""), (WAIT, "")]),
    "bwd_one_pass": (32, 4, [(MMA3, "  mma_tf32(d, a.hi, b.hi[0], "
                                    "b.hi[1]);")]),
}
# (label, nh, ds) at B4 S2048, hd 64
BWD_SHAPES = (("mamba2 B4 S2048", 48, 128), ("zamba2 B4 S2048", 64, 64))


def build(jobs):
    """One nvcc per job (name, source, define, patches), all started
    together; each into a directory of its own with the header beside
    it, a patch applied to whichever of the two holds it."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build
    procs = []
    for name, path, define, patches in jobs:
        texts = {path: open(path).read(), HEADER: open(HEADER).read()}
        for old, new in patches:
            where = [f for f, t in texts.items() if t.count(old) == 1]
            if len(where) != 1 or sum(t.count(old)
                                      for t in texts.values()) != 1:
                raise SystemExit(f"{name}: the patch no longer applies")
            texts[where[0]] = texts[where[0]].replace(old, new)
        out = os.path.join(OUT, name)
        os.makedirs(out, exist_ok=True)
        for f, text in texts.items():
            with open(os.path.join(out, os.path.basename(f)), "w") as fh:
                fh.write(text)
        procs.append((name, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, define, "-o",
             os.path.join(OUT, f"{name}.so"),
             os.path.join(out, os.path.basename(path))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, proc in procs:   # every compiler is reaped before a failure
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}: nvcc failed\n{log}")
    if failed:
        raise SystemExit("\n".join(failed))
    return _build.SIGNATURES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bwd", action="store_true",
                    help="time the backward's plans (K4b)")
    ap.add_argument("--out", default=None, help="write the times here")
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, HERE)
    if not torch.cuda.is_available():
        print("ssd_variants: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    times = bwd_times() if args.bwd else fwd_times()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "device_ms": times}, f, indent=1)
    print(json.dumps(times), flush=True)
    return 0


def fwd_times():
    import torch
    from chip_smoke import ssd_inputs
    from decode_ab import device_ms
    argtypes = build([(name, SRC, f"-DSSD_SCAN_COLS={cols}", patches)
                      for name, (cols, patches) in VARIANTS.items()]
                     )["ssd_scan"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    times = {}
    for label, b, s, with_state, calls in SHAPES:
        x, dt, A, B, C, st = ssd_inputs(b, s, torch.float32, with_state, gen)
        nh, hd, ds = x.shape[2], x.shape[3], B.shape[2]
        y = torch.empty_like(x)
        fin = torch.empty((b, nh, hd, ds), device="cuda")
        cb = torch.empty((b, -(-s // 32), 32, 32), device="cuda")
        for name, (cols, _) in VARIANTS.items():
            fn = ctypes.CDLL(os.path.join(OUT, f"{name}.so")).ssd_scan
            fn.argtypes, fn.restype = argtypes, ctypes.c_int

            def call():
                err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                         B.data_ptr(), C.data_ptr(),
                         0 if st is None else st.data_ptr(), y.data_ptr(),
                         fin.data_ptr(), cb.data_ptr(), b, s, nh, hd, ds,
                         0, -(-hd // cols),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            times.setdefault(name, {})[label] = device_ms(call, calls)
            print(f"{name:<11} {label:<13} {times[name][label]:.4f} ms "
                  "device", flush=True)
    return times


def bwd_times():
    """Each backward plan at each shape: the three launches through the
    C entry point and the wrapper's sums of the partials, device ms."""
    import torch
    from chip_smoke import ssd_inputs
    from decode_ab import device_ms
    libs = {}   # one library per (columns, patches)
    for name, (cols, _, patches) in BWD_VARIANTS.items():
        libs.setdefault(f"bwd_cols{cols}" if not patches else name,
                        (cols, patches))
    argtypes = build([(lib, BWD, f"-DSSD_BWD_COLS={cols}", patches)
                      for lib, (cols, patches) in libs.items()]
                     )["ssd_scan_bwd"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    times = {}
    f32 = dict(dtype=torch.float32, device="cuda")
    for label, nh, ds in BWD_SHAPES:
        b, s, hd = 4, 2048, 64
        x, dt, A, B, C, _ = ssd_inputs(b, s, torch.float32, False, gen,
                                       nh=nh, hd=hd, ds=ds)
        dy = torch.randn(x.shape, device="cuda", generator=gen)
        nc = -(-s // 32)
        cb = torch.empty((b, nc, 32, 32), **f32)
        states = torch.empty((b, nc, nh, hd, ds), **f32)
        dx = torch.empty_like(x)
        for name, (cols, group, patches) in BWD_VARIANTS.items():
            slices = -(-hd // cols)
            lib = name if patches else f"bwd_cols{cols}"
            fn = ctypes.CDLL(os.path.join(OUT, f"{lib}.so")).ssd_scan_bwd
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            ddt = torch.empty((slices, b, s, nh), **f32)
            dA = torch.empty((slices, b, nh), **f32)
            dB = torch.empty((b, s, nh // group, ds), **f32)
            dC = torch.empty_like(dB)

            def call():
                err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                         B.data_ptr(), C.data_ptr(), 0, dy.data_ptr(), 0,
                         cb.data_ptr(), states.data_ptr(), dx.data_ptr(),
                         ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                         dC.data_ptr(), 0, b, s, nh, hd, ds, slices, group,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
                return ddt.sum(0), dA.sum((0, 1)), dB.sum(2), dC.sum(2)
            times.setdefault(name, {})[label] = device_ms(call, 5)
            print(f"{name:<14} {label:<16} {times[name][label]:.4f} ms "
                  "device", flush=True)
    return times


if __name__ == "__main__":
    sys.exit(main())
