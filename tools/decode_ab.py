#!/usr/bin/env python3
"""A/B device times of the bf16 decode kernels between two checkouts of
this repository, on one NVIDIA GPU.

    git archive <commit> | tar -x -C build/other
    python3 tools/decode_ab.py build/other [--out ab.json]

Times the paged decode (``decode_attention_paged``, K1) and the dense
decode (``decode_attention``, K6) of each checkout at the serve shape
(Qwen2.5-7B heads: B4 H28 KV4 hd128, lengths 40/90/150/220 over a
256-slot ring of 16-slot pages) and at B16 x 2048, through the port's
own wrappers, each checkout building its kernels in its own ``build/``.
Runs in turns: the other checkout, this one, this one, the other, each
in a process of its own.  Every run gives two times per kernel and
shape: ``eager_ms``, CUDA events around back-to-back calls (the host's
dispatch lands on the clock when it is slower than the card), and
``device_ms``, CUDA events around replays of a CUDA graph of captured
calls.  Prints the card's name and power limit, one JSON line per run
and, last, the means per checkout.  Imports nothing of JAX."""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS, REPLAYS = 50, 5


def _inputs(paged: bool, b: int, lengths, L: int):
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    kw = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn((b, 28, 128), generator=gen, **kw)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if not paged:
        k = torch.randn((b, L, 4, 128), generator=gen, **kw)
        v = torch.randn((b, L, 4, 128), generator=gen, **kw)
        return q, k, v, ln
    pages = L // 16
    n_blocks = 1 + b * pages
    k = torch.randn((n_blocks, 16, 4, 128), generator=gen, **kw)
    v = torch.randn((n_blocks, 16, 4, 128), generator=gen, **kw)
    bt = (torch.randperm(n_blocks - 1, generator=gen, device="cuda")
          [:b * pages] + 1).reshape(b, pages).to(torch.int32).contiguous()
    return q, k, v, bt, ln


def _eager_ms(fn) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS


def _device_ms(fn) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (CALLS * REPLAYS)


def worker(tree: str) -> dict:
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import decode_attention_paged as dap
    _build.build(["decode_attention", "decode_attention_paged"])
    out = {"tree": tree}
    for name, paged, fn in (("decode_attention_paged", True,
                             dap.decode_attention_paged_cuda),
                            ("decode_attention", False,
                             da.decode_attention_cuda)):
        for shape, b, lengths, L in (("serve", 4, [40, 90, 150, 220], 256),
                                     ("B16x2048", 16, [2048] * 16, 2048)):
            args = _inputs(paged, b, lengths, L)
            out[f"{name} {shape}"] = {
                "eager_ms": _eager_ms(lambda: fn(*args)),
                "device_ms": _device_ms(lambda: fn(*args))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--worker", action="store_true",
                    help="time the checkout given as `other` and exit")
    ap.add_argument("--out", default=None, help="write the runs here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device is available", file=sys.stderr)
        return 2
    if args.worker:
        print(json.dumps(worker(os.path.abspath(args.other))), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    other = os.path.abspath(args.other)
    runs = []
    for tree in (other, HERE, HERE, other):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, "--worker"],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    means = {}
    for tree, label in ((other, "other"), (HERE, "this")):
        mine = [r for r in runs if r["tree"] == tree]
        means[label] = {key: {t: sum(r[key][t] for r in mine) / len(mine)
                              for t in ("eager_ms", "device_ms")}
                        for key in mine[0] if key != "tree"}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": runs, "means": means}, f,
                      indent=1)
    print(json.dumps(means), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
