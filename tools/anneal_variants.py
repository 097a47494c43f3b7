#!/usr/bin/env python3
"""Where the batched-annealer kernel's time goes (``anneal``,
``src/repro_torch/kernels/csrc/anneal.cu``), on one NVIDIA GPU: builds
copies of the source patched to leave one piece of a proposal's work
out, times them beside the kernel as it is, and measures the latencies
a proposal's dependent chain is made of.

    python3 tools/anneal_variants.py [--out variants.json]

Every variant, the kernel included, is built with the line-7 early exit
taken out, so each chain runs all 6300 proposals (63 levels x 100) and
the times compare.  Variants (only their times mean anything; most give
wrong schedules):
  kernel        the source as it is
  draws_reg     the four uniforms from a hash of the proposal index in
                registers instead of the staged draw tiles
  no_rows       the three candidate rows not rebuilt (their counts, sums
                and durations zero, the slack rows left as they were)
  no_scan       the waits without the warp scan (each lane's own prefix)
  no_sums       the three N-long sums without their butterflies (lane
                0's partials broadcast)
  no_metropolis an accepted move without expf and its division (accept
                when f_new > f or u3 < 0.5)
  ptxas_o1      the source as it is, ptxas at -O1 (less unrolling and
                scheduling: a smaller loop body)
  div_call      the division's long-division fallback out of line (a
                call) instead of inlined at each division
  block_plan    the block plan (at least 96 threads, a thread a
                position) at N 8 too (kWarpMaxN 0)
  warp_plan     a warp per chain to N 256 (kWarpMaxN 256),
                each lane over ceil(N / 32) positions (the kernel's plan
                stops the warp at N 32)
  profile       the kernel with clock64 read by thread 0 at each phase
                boundary of a proposal (PROFILE_SLOTS), the cycles of
                each phase summed
A patch is an exact piece of the source; the tool stops if it no longer
applies.  Each library is built with the repo's nvcc flags under
``build/anneal_variants/`` (one nvcc each, all started together) and
called through the C entry point ``anneal`` on ``chip_smoke.py``'s
inputs (``_anneal_case``: the paper's request mix, contended SLOs, seed
7) at N 8, 64 and 256, 8 chains, max_batch 8, incremental, CUDA events
around 10 calls after 3.

The latencies (``lat.cu``, one warp timing 4096 dependent steps with
clock64): a 32-bit shuffle, a float64 shuffle step of a scan (two
shuffles and an add), a shared-memory load (a pointer chase), a float64
add, __syncwarp, and __syncthreads among 128 threads.  From them the
tool states a valid proposal's dependent chain at N 64 (the counts
of each step along it are listed in ``CHAIN``) beside the time it
measured.  Prints the card's name and power limit and one line per
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
                   "anneal.cu")
OUT = os.path.join(HERE, "build", "anneal_variants")
SHAPES = (8, 64, 256)
CHAINS, MB, ITERS = 8, 8, 100

NO_EXIT = ("  while (T >= T_thres && bmet < nv && k + iters <= n_prop) {",
           "  while (T >= T_thres && k + iters <= n_prop) {")
DRAW = """      const float4 u = tile[((k / kTile) & 1) * kTile + (k & (kTile - 1))];"""
DRAW_REG = """      const unsigned hk = (k + 1) * 2654435761u;
      const float4 u = make_float4((hk >> 8) * 0x1p-24f,
                                   ((hk * 747796405u) >> 8) * 0x1p-24f,
                                   ((hk * 2891336453u) >> 8) * 0x1p-24f,
                                   ((hk * 1181783497u) >> 8) * 0x1p-24f);"""
ROWS = """        if (kWarp) {
          rows_warp(rq, perm_c, c, mb, pair, csl, meta_i, meta_f);
        } else if (t < 96) {             // warp r builds row r"""
NO_ROWS = """        if (t == 0) {
          for (int r = 0; r < 3; ++r) {
            meta_i[r] = 0; meta_f[r] = 0.f; meta_f[3 + r] = 0.f;
          }
        } else if (false) {"""
SCAN = """  double run = scan_sum<kWarp, true>(sb, a, x);"""
NO_SCAN = """  double run = 0.0;
  a = warp_sum(a);"""
SUMS = [(SCAN, """  double run = scan_sum<kWarp, false>(sb, a, x);
  a = __shfl_sync(~0u, a, 0);"""),
        ("""  sum2<kWarp>(b, cc, x);
  const float total""", """  b = __shfl_sync(~0u, b, 0);
  cc = __shfl_sync(~0u, cc, 0);
  const float total""")]
METROPOLIS = """      bool accept = f_new > f;
      if (!accept) {
        const float p_acc = expf(div_rn(__fsub_rn(f_new, f), scale));
        accept = u.w < p_acc;
      }"""
# the profile build: lane 0 of each chain reads clock64 at the phase
# boundaries of a proposal and adds each phase's cycles into a slot
# (``PROFILE_SLOTS``); the sums come back through ``anneal_prof``
PROF_DEFS = """namespace {

__shared__ long long prof_acc[16];
__shared__ long long prof_last;
__device__ unsigned long long g_prof[16];
__device__ __forceinline__ void prof(int slot) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    prof_acc[slot] += now - prof_last;
    prof_last = now;
  }
}
__device__ __forceinline__ void prof_count(int slot) {
  if (threadIdx.x == 0) prof_acc[slot] += 1;
}"""
PROFILE = [
    ("namespace {", PROF_DEFS),
    ("  float T = T0;", """  float T = T0;
  if (threadIdx.x == 0) {
    for (int q = 0; q < 16; ++q) prof_acc[q] = 0;
  }"""),
    (DRAW, DRAW.replace("      const float4", """      if (threadIdx.x == 0) prof_last = clock64();
      const float4""")),
    ("      if (!ok) continue;", """      if (!ok) { prof(10); continue; }
      prof(0);
      prof_count(11);"""),
    ("        score_inc<kWarp>(s, c, csl, mb, lo, hi, x, f_new, met_new);",
     """        prof(1);
        score_inc<kWarp>(s, c, csl, mb, lo, hi, x, f_new, met_new);"""),
    (SCAN, "  prof(2);\n" + SCAN + "\n  prof(3);"),
    ("  sum2<kWarp>(b, cc, x);\n  const float total", """  prof(4);
  sum2<kWarp>(b, cc, x);
  prof(5);
  const float total"""),
    ("  g = div_rn(static_cast<float>(cc), fmaxf(total, 1e-12f));",
     "  g = div_rn(static_cast<float>(cc), fmaxf(total, 1e-12f));\n  prof(6);"),
    ("      if (!accept) continue;", """      prof(7);
      if (!accept) continue;
      prof_count(12);"""),
    ("      f = f_new;\n      met = met_new;", """      prof(8);
      f = f_new;
      met = met_new;"""),
    ("        bmet = met;\n      }\n    }\n    T = __fmul_rn(T, tau);",
     """        bmet = met;
        prof_count(13);
      }
      prof(9);
    }
    T = __fmul_rn(T, tau);"""),
    ("  if (t == 0) out_g[chain] = bf;", """  if (t == 0) out_g[chain] = bf;
  if (t == 0)
    for (int q = 0; q < 16; ++q)
      atomicAdd(&g_prof[q], static_cast<unsigned long long>(prof_acc[q]));"""),
    ("// Bytes of global workspace an anneal needs", """extern "C" int anneal_prof(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[16] = {};
    return static_cast<int>(cudaMemcpyToSymbol(g_prof, z, sizeof(z)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)));
}

// Bytes of global workspace an anneal needs"""),
]
PROFILE_SLOTS = ("decode", "rows", "pass1", "scan", "pass2", "sums", "g_div",
                 "metropolis", "commit", "best_copy", "invalid_total",
                 "valid_n", "accepted_n", "new_best_n")
# name -> (extra nvcc flags, patches)
VARIANTS = {
    "kernel": ([], []),
    "draws_reg": ([], [(DRAW, DRAW_REG)]),
    "no_rows": ([], [(ROWS, NO_ROWS)]),
    "no_scan": ([], [(SCAN, NO_SCAN)]),
    "no_sums": ([], SUMS),
    "no_metropolis": ([], [(METROPOLIS, "      bool accept = f_new > f || "
                                        "u.w < 0.5f;")]),
    "ptxas_o1": (["-Xptxas=-O1"], []),
    "div_call": ([], [("__device__ __forceinline__ float div_slow(",
                       "__device__ __noinline__ float div_slow(")]),
    "block_plan": ([], [("kWarpMaxN = 32;", "kWarpMaxN = 0;")]),
    "warp_plan": ([], [("kWarpMaxN = 32;", "kWarpMaxN = 256;")]),
    "profile": ([], PROFILE),
}

LAT_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
constexpr int kSteps = 4096;
// out[0..5]: clock cycles a step of: 32-bit shuffle, float64 scan step,
// shared-memory load, float64 add, __syncwarp, __syncthreads (128 threads)
__global__ void lat(long long* out, const int* seed) {
  __shared__ int chase[1024];
  const int t = threadIdx.x, lane = t & 31;
  for (int i = t; i < 1024; i += blockDim.x) chase[i] = (i + 33) & 1023;
  __syncthreads();
  int v = seed[t];
  double d = seed[t] * 0.5, e = seed[0] * 1e-9;
  long long c0, c1;
  if (t < 32) {
    c0 = clock64();
    for (int i = 0; i < kSteps; ++i) v = __shfl_sync(~0u, v, (lane + v) & 31);
    c1 = clock64();
    if (t == 0) out[0] = (c1 - c0) / kSteps;
    c0 = clock64();
    for (int i = 0; i < kSteps; ++i) {
      const double y = __shfl_up_sync(~0u, d, 1);
      if (lane >= 1) d = __dadd_rn(d, y);
    }
    c1 = clock64();
    if (t == 0) out[1] = (c1 - c0) / kSteps;
    int p = v & 1023;
    c0 = clock64();
    for (int i = 0; i < kSteps; ++i) p = chase[p];
    c1 = clock64();
    if (t == 0) out[2] = (c1 - c0) / kSteps;
    c0 = clock64();
    for (int i = 0; i < kSteps; ++i) d = __dadd_rn(d, e);
    c1 = clock64();
    if (t == 0) out[3] = (c1 - c0) / kSteps;
    c0 = clock64();
    for (int i = 0; i < kSteps; ++i) { __syncwarp(); v += lane; }
    c1 = clock64();
    if (t == 0) out[4] = (c1 - c0) / kSteps;
    v += p;
  }
  __syncthreads();
  c0 = clock64();
  for (int i = 0; i < kSteps; ++i) { __syncthreads(); v += t; }
  c1 = clock64();
  if (t == 0) out[5] = (c1 - c0) / kSteps;
  if (v == 12345 && d == 0.5) out[6] = v;
}
extern "C" int lat_run(long long* out, const int* seed) {
  lat<<<1, 128>>>(out, seed);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""
LAT_NAMES = ("shfl", "dshfl_scan_step", "lds", "dadd", "syncwarp",
             "syncthreads_128")
# a valid, accepted incremental proposal's dependent chain at N 64,
# max_batch 8 (the block plan: 96 threads, a position each), in those
# steps: the draw tile; the move's two dependent reads (st, then the
# sizes); a row: perm, the request row, the exec slot, the member reads
# (pipelined: one), the counts to every warp (write, barrier, read);
# pass 1 (one read); the scan (5 steps, its exchange: barrier, read);
# pass 2 (st, then the start's stats); the sums' butterfly (5 float64
# steps ~ scan steps, its exchange); the commit's barrier.  ALU work
# between the steps is left out.
CHAIN = {"lds": 1 + 2 + 4 + 1 + 1 + 1 + 2 + 1, "dshfl_scan_step": 5 + 5,
         "dadd": 2 + 2, "syncthreads_128": 1 + 1 + 1 + 1}


def build(names):
    """One nvcc per variant, and the latency probe, all started
    together."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import _build
    os.makedirs(OUT, exist_ok=True)
    src = open(SRC).read()
    texts = {}
    for name in names:                   # every patch first, then nvcc
        text = src
        for old, new in [NO_EXIT] + VARIANTS[name][1]:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the patch no longer applies")
            text = text.replace(old, new)
        texts[name] = text
    procs = []
    for name in names:
        flags = VARIANTS[name][0]
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(texts[name])
        procs.append((name, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
             os.path.join(OUT, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    cu = os.path.join(OUT, "lat.cu")
    with open(cu, "w") as f:
        f.write(LAT_CU)
    procs.append(("lat", subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(OUT, "lat.so"),
         cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = {}
    for name, proc in procs:
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{logs[name]}")
    return _build.SIGNATURES["anneal"], logs


def latencies():
    import torch
    lib = ctypes.CDLL(os.path.join(OUT, "lat.so"))
    lib.lat_run.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    out = torch.zeros(8, dtype=torch.int64, device="cuda")
    seed = torch.arange(128, dtype=torch.int32, device="cuda")
    if lib.lat_run(out.data_ptr(), seed.data_ptr()):
        raise RuntimeError("lat: launch failed")
    return dict(zip(LAT_NAMES, out.tolist()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the times here")
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    from chip_smoke import _anneal_case
    from decode_ab import eager_ms
    if not torch.cuda.is_available():
        print("anneal_variants: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core import annealing_torch as at
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    argtypes, logs = build(list(VARIANTS))
    for name in VARIANTS:
        regs = [ln.strip() for ln in logs[name].splitlines()
                if "registers" in ln or "stack frame" in ln]
        print(f"{name}: {' | '.join(regs)}", flush=True)
    lat = latencies()
    print("latencies (clock cycles a step): " + json.dumps(lat), flush=True)
    chain = sum(n * lat[k] for k, n in CHAIN.items())
    print(f"dependent chain of a valid proposal, block plan, N 64 "
          f"max_batch 8: {json.dumps(CHAIN)} -> {chain} cycles", flush=True)
    cfg = at.TorchSAConfig(iters=ITERS, num_chains=CHAINS)
    props = at.n_proposals(cfg)
    times, profiles = {}, {}
    for n in SHAPES:
        _, reqc, nv, draws = _anneal_case([n], n, "contended", cfg, seed=7)
        perm = torch.empty((1, CHAINS, n), dtype=torch.int32, device="cuda")
        bnd = torch.empty((1, CHAINS, n), dtype=torch.bool, device="cuda")
        g = torch.empty((1, CHAINS), device="cuda")
        for name in VARIANTS:
            fn = ctypes.CDLL(os.path.join(OUT, f"{name}.so")).anneal
            fn.argtypes, fn.restype = argtypes, ctypes.c_int

            def call():
                err = fn(reqc.data_ptr(), nv.data_ptr(), draws.data_ptr(),
                         perm.data_ptr(), bnd.data_ptr(), g.data_ptr(), 0,
                         1, CHAINS, n, draws.shape[2], MB, ITERS, 1,
                         cfg.T0, cfg.T_thres, cfg.tau,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            if name == "profile":
                pf = ctypes.CDLL(os.path.join(OUT, f"{name}.so")).anneal_prof
                pf.argtypes, pf.restype = [ctypes.c_void_p, ctypes.c_int], \
                    ctypes.c_int
                buf = (ctypes.c_ulonglong * 16)()
                pf(buf, 1)
                call()
                torch.cuda.synchronize()
                pf(buf, 0)
                per = {k: buf[q] / (CHAINS * props)
                       for q, k in enumerate(PROFILE_SLOTS)}
                profiles[f"N{n}"] = per
                print(f"profile N{n} (clock cycles a proposal, lane 0, "
                      f"averaged over all {props} proposals; *_n: share of "
                      f"proposals): " + json.dumps(
                          {k: round(v, 3) for k, v in per.items()}),
                      flush=True)
            ms = eager_ms(call, 10)
            times.setdefault(name, {})[f"N{n}"] = ms * 1e3 / props
            print(f"{name:<14} N{n:<4} {ms:.4f} ms, "
                  f"{ms * 1e3 / props:.4f} us a proposal", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "latency_cycles": lat, "chain": CHAIN,
                       "chain_cycles": chain, "us_per_proposal": times,
                       "profile_cycles": profiles}, f, indent=1)
    print(json.dumps({"latency_cycles": lat, "chain_cycles": chain,
                      "us_per_proposal": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
