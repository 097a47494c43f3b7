#!/usr/bin/env python3
"""A/B times of the port's kernels between two checkouts of this
repository, on one NVIDIA GPU: the bf16 decode kernels (default), the
int8 decode kernels (``--kernels q8``), the SSD chunk scan
(``--kernels ssd``), its backward (``--kernels ssd_bwd``) or the batched
annealer (``--kernels anneal``).

    git archive <commit> | tar -x -C build/other
    python3 tools/decode_ab.py build/other \
        [--kernels q8|ssd|ssd_bwd|anneal] [--out ab.json]

``decode``: the paged decode (``decode_attention_paged``, K1) and the
dense decode (``decode_attention``, K6) at the serve shape (Qwen2.5-7B
heads: B4 H28 KV4 hd128, lengths 40/90/150/220 over a 256-slot ring of
16-slot pages) and at B16 x 2048.  ``q8``: the same two shapes through
the int8 paged (``decode_attention_paged_q8``, K3) and dense
(``decode_attention_q8``, K7) decode, bf16 q, K/V quantized by each
checkout's own ``quantize_kv``.  ``ssd``: ``ssd_scan`` (K4) at the
three shapes ``chip_smoke.py`` times (Mamba2-780M widths, nh 48, hd 64,
ds 128, float32 x, B and C as the model hands them: B1 S96; B1 S32 from
a state; B4 S2048), and one full-depth Mamba2-780M prefill of a
2048-token prompt (B1, 48 layers, bf16 random weights from seed 0, into
a dense cache, the LM head on the last position).  ``ssd_bwd``: the
scan's backward (``ssd_scan_bwd_cuda``, K4b) at the train shapes of
Mamba2-780M (B4 S2048 nh 48 hd 64 ds 128) and Zamba2-1.2B (B4 S2048 nh 64
hd 64 ds 64), float32, no initial state or final-state cotangent, as
``SSDScanFn`` calls it in training.  ``anneal``: the
batched-annealer kernel (``anneal_chains_cuda``) at ``chip_smoke.py``'s
``ANNEAL_BENCH`` and ``ANNEAL_FLOOR`` shapes (N 64 / 128 / 256 x 8
chains, 4 instances x 64 x 2 chains, N 8 x 8 chains; max_batch 8,
contended SLOs, 100 proposals a level: 6300 a chain), incremental, and
N 64 on the full path too, with ms a call and us a proposal.  Through each
checkout's own wrappers, each building its kernels in its own
``build/``.  Runs in turns: the other checkout, this one, this one, the
other, each in a process of its own.  Every kernel time is given twice:
``eager_ms``, CUDA events around back-to-back calls (the host's
dispatch lands on the clock when it is slower than the card), and
``device_ms``, CUDA events around replays of a CUDA graph of captured
calls; the prefill as ``prefill_ms``, the host clock around a
synchronized prefill, median of three after a warm-up.  Prints the
card's name and power limit, one JSON line per run and, last, the
means per checkout.  Imports nothing of JAX."""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS, REPLAYS = 50, 5
# the SSD scan's shapes: (label, batch, seq, from a state, calls)
SSD_SHAPES = (("B1 S96", 1, 96, False, 50),
              ("B1 S32 +state", 1, 32, True, 50),
              ("B4 S2048", 4, 2048, False, 5))
# the SSD backward's shapes: (label, nh, ds) at B4 S2048, hd 64
SSD_BWD_SHAPES = (("mamba2 B4 S2048", 48, 128), ("zamba2 B4 S2048", 64, 64))
PROMPT = 2048


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


def eager_ms(fn, calls: int = CALLS) -> float:
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn, calls: int = CALLS) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * REPLAYS)


def _q8(args):
    """bf16 decode inputs -> q, then K and V each as int8 and bf16
    scales, then the index tensors."""
    from repro_torch.models.cache import quantize_kv
    q, k, v = args[:3]
    return (q, *quantize_kv(k), *quantize_kv(v)) + tuple(args[3:])


def _decode_worker(tree: str, q8: bool) -> dict:
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import decode_attention_paged as dap
    from repro_torch.kernels import decode_attention_q8 as dq8
    _build.build(["decode_attention", "decode_attention_paged"])
    out = {"tree": tree}
    kernels = ((("decode_attention_paged_q8", True,
                 dap.decode_attention_paged_q8_cuda),
                ("decode_attention_q8", False, dq8.decode_attention_q8_cuda))
               if q8 else
               (("decode_attention_paged", True,
                 dap.decode_attention_paged_cuda),
                ("decode_attention", False, da.decode_attention_cuda)))
    for name, paged, fn in kernels:
        for shape, b, lengths, L in (("serve", 4, [40, 90, 150, 220], 256),
                                     ("B16x2048", 16, [2048] * 16, 2048)):
            args = _inputs(paged, b, lengths, L)
            if q8:
                args = _q8(args)
            out[f"{name} {shape}"] = {
                "eager_ms": eager_ms(lambda: fn(*args)),
                "device_ms": device_ms(lambda: fn(*args))}
    return out


def decode_worker(tree: str) -> dict:
    return _decode_worker(tree, q8=False)


def q8_worker(tree: str) -> dict:
    return _decode_worker(tree, q8=True)


def _ssd_inputs(b, s, with_state, **widths):
    """``chip_smoke.py``'s SSD inputs in float32, from seed 11 (the
    Mamba2-780M widths unless ``nh``, ``hd``, ``ds`` say otherwise)."""
    import torch
    sys.path.insert(0, HERE)
    from chip_smoke import ssd_inputs
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    return ssd_inputs(b, s, torch.float32, with_state, gen, **widths)


def _prefill_ms(runs=3):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.cache import init_cache
    from repro_torch.models.model import forward_full, init_params
    cfg = get_config("mamba2-780m")
    params = init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen,
                           device="cuda")

    def prefill():
        cache = init_cache(cfg, 1, PROMPT, device="cuda")
        with torch.inference_mode():
            forward_full(params, cfg, tokens=tokens, cache=cache,
                         last_only=True)
        torch.cuda.synchronize()

    prefill()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        prefill()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def ssd_worker(tree: str) -> dict:
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ss
    _build.build(["ssd_scan"])
    out = {"tree": tree}
    for label, b, s, with_state, calls in SSD_SHAPES:
        x, dt, A, B, C, st = _ssd_inputs(b, s, with_state)

        def fn():
            return ss.ssd_scan_cuda(x, dt, A, B, C, init_state=st)
        out[f"ssd_scan {label}"] = {"eager_ms": eager_ms(fn, calls),
                                    "device_ms": device_ms(fn, calls)}
    out[f"prefill B1 S{PROMPT}"] = {"prefill_ms": _prefill_ms()}
    return out


def ssd_bwd_worker(tree: str) -> dict:
    import torch
    sys.path.insert(0, os.path.join(tree, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ss
    _build.build(["ssd_scan_bwd"])
    out = {"tree": tree}
    for label, nh, ds in SSD_BWD_SHAPES:
        x, dt, A, B, C, _ = _ssd_inputs(4, 2048, False, nh=nh, hd=64, ds=ds)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(12)
        dy = torch.randn(x.shape, device="cuda", generator=gen)

        def fn():
            return ss.ssd_scan_bwd_cuda(x, dt, A, B, C, dy)
        out[f"ssd_scan_bwd {label}"] = {"eager_ms": eager_ms(fn, 5),
                                        "device_ms": device_ms(fn, 5)}
    return out


def anneal_worker(tree: str) -> dict:
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, HERE)
    from chip_smoke import ANNEAL_BENCH, ANNEAL_FLOOR, _anneal_case
    from repro_torch.core import annealing_torch as at
    from repro_torch.kernels import _build
    from repro_torch.kernels import anneal as ka
    _build.build(["anneal"])
    out = {"tree": tree}
    for label, n_inst, chains, n in ANNEAL_BENCH + (ANNEAL_FLOOR,):
        cfg = at.TorchSAConfig(iters=100, num_chains=chains)
        _, reqc, nv, draws = _anneal_case([n] * n_inst, n, "contended", cfg,
                                          seed=7)
        props = at.n_proposals(cfg)
        for inc in (True, False) if label == "N64 C8" else (True,):
            def fn():
                return ka.anneal_chains_cuda(reqc, nv, draws, 8, cfg.T0,
                                             cfg.T_thres, cfg.tau, cfg.iters,
                                             inc)
            ms = eager_ms(fn, 10)
            out[f"anneal {label} {'incremental' if inc else 'full'}"] = {
                "ms": ms, "us_per_proposal": ms * 1e3 / props}
    return out


WORKERS = {"decode": decode_worker, "q8": q8_worker, "ssd": ssd_worker,
           "ssd_bwd": ssd_bwd_worker, "anneal": anneal_worker}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--kernels", choices=sorted(WORKERS), default="decode",
                    help="which kernels to time")
    ap.add_argument("--worker", action="store_true",
                    help="time the checkout given as `other` and exit")
    ap.add_argument("--out", default=None, help="write the runs here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("decode_ab: no CUDA device is available", file=sys.stderr)
        return 2
    if args.worker:
        out = WORKERS[args.kernels](os.path.abspath(args.other))
        print(json.dumps(out), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    other = os.path.abspath(args.other)
    runs = []
    for tree in (other, HERE, HERE, other):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, "--worker",
             "--kernels", args.kernels],
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
                              for t in mine[0][key]}
                        for key in mine[0] if key != "tree"}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "runs": runs, "means": means}, f,
                      indent=1)
    print(json.dumps(means), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
