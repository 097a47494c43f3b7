#!/usr/bin/env python3
"""Where the SSD chunk scan's time goes (``ssd_scan``, K4), on one NVIDIA
GPU: builds copies of ``src/repro_torch/kernels/csrc/ssd_scan.cu`` with
another column plan, or patched to leave one piece of work out, and
times them beside the kernel as it is.

    python3 tools/ssd_variants.py [--out variants.json]

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
A patch is an exact piece of the source; the tool stops if it no longer
applies.  Each library is built with the repo's nvcc flags under
``build/ssd_variants/`` (one nvcc each, all started together) and called
through the same C entry point as the wrapper, on ``chip_smoke.py``'s
inputs (``ssd_inputs``: the Mamba2-780M widths, nh 48, hd 64, ds 128,
float32 x, B and C): B1 S96, B1 S32 from a state, B1 S2048 and B4
S2048, as device time from CUDA-graph replays (``tools/decode_ab.py``'s
``device_ms``).  Prints the card's name and power limit and one line per
variant and shape; imports nothing of JAX."""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc",
                   "ssd_scan.cu")
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


def build(names):
    """One nvcc per variant, all started together."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build
    os.makedirs(OUT, exist_ok=True)
    src = open(SRC).read()
    procs = []
    for name in names:
        cols, patches = VARIANTS[name]
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the patch no longer applies")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs.append((name, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, f"-DSSD_SCAN_COLS={cols}",
             "-o",
             os.path.join(OUT, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
    return _build.SIGNATURES["ssd_scan"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the times here")
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, HERE)
    from chip_smoke import ssd_inputs
    from decode_ab import device_ms
    if not torch.cuda.is_available():
        print("ssd_variants: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    argtypes = build(list(VARIANTS))
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
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "device_ms": times}, f, indent=1)
    print(json.dumps(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
