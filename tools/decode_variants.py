#!/usr/bin/env python3
"""Where the split-KV decode's time goes (the bf16-q decode kernels K1,
K3, K6, K7 of ``csrc/decode_attention_split_sm90.cuh``), on one NVIDIA
GPU: builds copies of the kernel sources with the block patched to
leave one piece of work out, or to run another plan, and times them
beside the block as it is.

    python3 tools/decode_variants.py [--out variants.json]

Variants (the tool checks no result: only their times mean anything):
  kernel      the sources as they are
  no_convert  int8: the tile's int8 -> bf16 conversion left out (the
              ldmatrix reads a stale bf16 tile; wrong result)
  no_scale    int8: the scales' global loads left out (scale 1)
  no_load     no K/V tile copied after the first kStages - 1 (the ring
              keeps stale tiles; wrong result): the time without memory
  stages4     a four-stage K/V ring (three tiles in flight)
  identity_table  paged: the page of a slot computed (b * pages + slot /
              page + 1, the inputs' own table) instead of read from the
              block table: the cost of the table reads
  two_blocks  int8: ptxas not held to three blocks an SM (the plan
              still splits for three)
  fragments   int8: the B fragments built from the int8 ring in
              registers instead of a bf16 tile (the K row's bytes as the
              k of each step, Q permuted to match; V's bytes of four rows
              paired by byte permutes; the diff
              tools/decode_q8_fragments.diff)
A patch is an exact piece of the header (the fragments variant's are
the hunks of its diff); a variant whose patch no longer applies, or
that fails to build, is reported and left out.  Each variant's
``decode_attention.cu`` and ``decode_attention_paged.cu`` are built with
the repo's nvcc flags
under ``build/decode_variants/<variant>/`` (one nvcc each, all started
together) and called through the port's own wrappers, on
``chip_smoke.py``'s inputs (Qwen2.5-7B heads, B4 H28 KV4 hd128): the
serve shape (lengths 40/90/150/220, a 256-slot ring) and B16 x 2048,
bf16 q over bf16 K/V (K1 paged, K6 dense) and over int8 K/V (K3, K7),
as device time from CUDA-graph replays (``tools/decode_ab.py``'s
``device_ms``).  Prints the card's name and power limit and one line per
variant, kernel and shape; imports nothing of JAX."""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc")
HEADER = "decode_attention_split_sm90.cuh"
SOURCES = ("decode_attention", "decode_attention_paged")
OUT = os.path.join(HERE, "build", "decode_variants")

CONVERT = """      *reinterpret_cast<uint4*>(sConv + r * kPitch + c * 8) =
          make_uint4(lo4.x, lo4.y, hi4.x, hi4.y);"""
SCALE = """    if (lo + t * kKeys + r >= hi) return 0.f;
    return __bfloat162float((lane < 16 ? k_scale : v_scale)[row_at(t, r)]);"""
LOAD = """      load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
      if constexpr (kInt8) sc = """
TABLE = "      int page = __ldg(bt + slot / page_size);"


def diff_patches(path):
    """The hunks of a unified diff as (old, new) exact replacements."""
    hunks = []
    with open(path) as f:
        for ln in f:
            if ln.startswith("@@"):
                hunks.append([])
            elif hunks and ln[:1] in (" ", "-", "+"):
                hunks[-1].append(ln)
    return [("".join(ln[1:] for ln in h if ln[0] in " -"),
             "".join(ln[1:] for ln in h if ln[0] in " +")) for h in hunks]


FRAGMENTS = os.path.join(HERE, "tools", "decode_q8_fragments.diff")
# name -> patches of the header
VARIANTS = {
    "kernel": [],
    "no_convert": [(CONVERT, "")],
    "no_scale": [(SCALE, "    return lo + t * kKeys + r >= hi ? 0.f : 1.f;")],
    "no_load": [(LOAD, "      if constexpr (kInt8) sc = ")],
    "stages4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "identity_table": [(TABLE, "      int page = b * pages_per_seq + "
                               "slot / page_size + 1;")],
    "two_blocks": [("constexpr int kMinBlocks = kQ8<KT> ? 3 : 1;",
                    "constexpr int kMinBlocks = 1;")],
    "fragments": diff_patches(FRAGMENTS),
}


def build(names):
    """One nvcc per (variant, source), all started together; -> the
    variants that built.  Each library keeps its own function-local
    statics (-fno-gnu-unique), so that the variants loaded side by side
    each set their own kernels' shared-memory attribute."""
    from repro_torch.kernels import _build
    header = open(os.path.join(CSRC, HEADER)).read()
    procs = []
    for name in names:
        text = header
        patches = VARIANTS[name]
        if any(text.count(old) != 1 for old, _ in patches):
            print(f"{name}: a patch no longer applies, left out", flush=True)
            continue
        for old, new in patches:
            text = text.replace(old, new)
        d = os.path.join(OUT, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        with open(os.path.join(d, HEADER), "w") as f:
            f.write(text)
        for src in SOURCES:
            procs.append((name, subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-Xcompiler",
                 "-fno-gnu-unique", "-o",
                 os.path.join(d, f"lib{src}.so"),
                 os.path.join(d, f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = dict.fromkeys(name for name, _ in procs)
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed, left out\n{log[-3000:]}", flush=True)
            built.pop(name, None)
        elif name in built:
            print(f"{name}: " + " | ".join(
                ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln)[:1500], flush=True)
    return list(built)


def use(name):
    """Point the port's wrappers at the variant's libraries."""
    from repro_torch.kernels import _build
    for kernel, src in _build.SOURCES.items():
        if src in SOURCES:
            lib = ctypes.CDLL(os.path.join(OUT, name, f"lib{src}.so"))
            fn = getattr(lib, kernel)
            fn.argtypes, fn.restype = _build.SIGNATURES[kernel], ctypes.c_int
            _build._FNS[kernel] = fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write the times here")
    args = ap.parse_args(argv)
    import torch
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from chip_smoke import (dense_inputs, dense_q8_inputs, decode_inputs,
                            decode_q8_inputs)
    from decode_ab import device_ms
    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import decode_attention_paged as dap
    from repro_torch.kernels import decode_attention_q8 as dq8
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    names = build(list(VARIANTS))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    bf = torch.bfloat16
    cases = []
    for shape, b, lengths, L in (("serve", 4, [40, 90, 150, 220], 256),
                                 ("B16x2048", 16, [2048] * 16, 2048)):
        nb = 65 if b == 4 else None
        cases += [
            ("decode_attention_paged", shape, dap.decode_attention_paged_cuda,
             decode_inputs(b, lengths, L // 16, bf, 0, gen, n_blocks=nb)),
            ("decode_attention_paged_q8", shape,
             dap.decode_attention_paged_q8_cuda,
             decode_q8_inputs(b, lengths, L // 16, bf, 0, gen, n_blocks=nb)),
            ("decode_attention", shape, da.decode_attention_cuda,
             dense_inputs(b, lengths, L, bf, gen)),
            ("decode_attention_q8", shape, dq8.decode_attention_q8_cuda,
             dense_q8_inputs(b, lengths, L, bf, gen))]
    times = {}
    for name in names:
        use(name)
        for kernel, shape, fn, (a, kw) in cases:
            ms = device_ms(lambda: fn(*a, **kw), 50 if shape == "serve"
                           else 20)
            times.setdefault(name, {})[f"{kernel} {shape}"] = ms
            print(f"{name:<10} {kernel:<26} {shape:<9} {ms:.4f} ms device",
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "device_ms": times}, f, indent=1)
    print(json.dumps(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
