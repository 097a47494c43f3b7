#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one NVIDIA
GPU, and hold every CUDA kernel of its main path against its plain
PyTorch version.

    python3 chip_smoke.py                     # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases (any failure exits non-zero before the last line):
  device   card name and power limit (nvidia-smi), torch/CUDA versions
  build    nvcc builds every kernel source in src/repro_torch/kernels/csrc
  kernels  each kernel vs its plain version on the card, bf16 and f32,
           at Qwen2.5-7B shapes; CUDA-event times (plain, kernel, kernel,
           plain) at the serve path's shape and at one long shape
  serve    Qwen2.5-7B at its published config (28 layers, bf16, random
           seeded weights): latency-model fit, then run_policy under
           fcfs, slo-reanneal, slo-preempt + chunked:32, and a multi-turn
           fcfs run with prefix hits, on the paged engine; then the same
           three policy runs on the dense engine (paged=False)
  int8     the same model: one 128-token prompt and 32 greedy decode
           steps through an int8 paged cache and an int8 dense cache,
           each against the same run on a bf16 cache
  parity   Qwen2.5-7B at full width, 2 layers, float32, TF32 off: the
           paged and the dense engine on cuda (kernels) and on cpu
           (plain versions) must emit identical tokens; int8 paged and
           dense decode logits, cuda vs cpu, are reported and bounded
Each path (paged serve, dense serve, int8) is driven with the launch
counts set to 0 just before it and read just after; every kernel must
launch on the path that runs it.  The line before the last is the
kernels JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "serve", "int8", "parity")
PEAK_BYTES = 3.35e12                       # H100 SXM HBM3, bytes/s
PEAK_FLOPS = {"bfloat16": 989e12,          # dense tensor-core bf16
              "float32": 67e12}            # float32 outside tensor cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# Qwen2.5-7B attention shapes and the serve engine's page geometry
H, KV, HD, PAGE = 28, 4, 128, 16
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
}
# the path each kernel must launch on (counts reset before, read after)
PATHS = {"serve_paged": ("decode_attention_paged", "flash_attention"),
         "serve_dense": ("flash_attention", "decode_attention"),
         "int8": ("decode_attention_paged_q8", "decode_attention_q8")}
# the int8 KV library yardstick: no single PyTorch call dequantizes int8
# K/V with per-row scales inside attention
NO_LIBRARY = {
    "decode_attention_paged": "no single PyTorch call pages through a "
                              "block table",
    "decode_attention_paged_q8": "no single PyTorch call pages through a "
                                 "block table over int8 K/V",
    "decode_attention_q8": "no single PyTorch call attends over int8 K/V "
                           "with per-row scales"}


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


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
def decode_inputs(b, lengths, pages_per_seq, dtype, window, gen, n_blocks=None):
    import torch
    n_blocks = n_blocks or 1 + b * pages_per_seq
    kw = dict(device="cuda", dtype=dtype)
    q = torch.randn((b, H, HD), generator=gen, **kw)
    k = torch.randn((n_blocks, PAGE, KV, HD), generator=gen, **kw)
    v = torch.randn((n_blocks, PAGE, KV, HD), generator=gen, **kw)
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
                     n_blocks=None):
    """int8 pages quantized (by the port's quantize_kv) from float32
    pages; q in ``dtype``."""
    import torch
    from repro_torch.models.cache import quantize_kv
    (q, k, v, bt, ln), kw = decode_inputs(b, lengths, pages_per_seq,
                                          torch.float32, window, gen,
                                          n_blocks)
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return (q.to(dtype), kq, ks, vq, vs, bt, ln), kw


def decode_q8_cost(args, window, dtype_name):
    """int8 values + one bf16 scale per (token, kv head), for K and V."""
    q, _, _, _, _, bt, ln = args
    return decode_bound(q, ln, bt.shape[1] * PAGE, KV * (HD + 2),
                        (bt.numel() + ln.numel()) * 4, window, dtype_name)


def dense_inputs(b, n_valid, L, dtype, gen):
    import torch
    kw = dict(device="cuda", dtype=dtype)
    q = torch.randn((b, H, HD), generator=gen, **kw)
    k = torch.randn((b, L, KV, HD), generator=gen, **kw)
    v = torch.randn((b, L, KV, HD), generator=gen, **kw)
    nv = torch.tensor(n_valid, dtype=torch.int32, device="cuda")
    return (q, k, v, nv), {}


def dense_q8_inputs(b, n_valid, L, dtype, gen):
    import torch
    from repro_torch.models.cache import quantize_kv
    (q, k, v, nv), _ = dense_inputs(b, n_valid, L, torch.float32, gen)
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


def flash_inputs(b, s, dtype, window, gen):
    import torch
    kw = dict(device="cuda", dtype=dtype)
    q = torch.randn((b, s, H, HD), generator=gen, **kw)
    k = torch.randn((b, s, KV, HD), generator=gen, **kw)
    v = torch.randn((b, s, KV, HD), generator=gen, **kw)
    return (q, k, v), {"causal": True, "window": window}


def flash_cost(args, window, dtype_name):
    q, k, v = args
    b, s = q.shape[:2]
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s))
    nbytes = 2 * q.numel() * q.element_size() + \
        2 * k.numel() * k.element_size()
    return bound(nbytes, 4.0 * b * H * HD * pairs, dtype_name)


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
        rep = H // KV
        ke = k.repeat_interleave(rep, dim=1)
        ve = v.repeat_interleave(rep, dim=1)
        return lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                      is_causal=True)


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
        ]),
        "flash_attention": (fa.flash_attention_plain,
                            fa.flash_attention_cuda, [
            ("S16 causal", lambda dt: flash_inputs(1, 16, dt, 0, gen)),
            ("S128 causal", lambda dt: flash_inputs(1, 128, dt, 0, gen)),
            ("S128 window32", lambda dt: flash_inputs(1, 128, dt, 32, gen)),
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
        ]),
        "decode_attention": (da.decode_attention_plain,
                             da.decode_attention_cuda, [
            ("L256 n_valid 1/90/256",
             lambda dt: dense_inputs(3, [1, 90, 256], 256, dt, gen)),
            ("L64 n_valid 1/33/64",
             lambda dt: dense_inputs(3, [1, 33, 64], 64, dt, gen)),
        ]),
        "decode_attention_q8": (dq8.decode_attention_q8_plain,
                                dq8.decode_attention_q8_cuda, [
            ("L256 n_valid 1/90/256",
             lambda dt: dense_q8_inputs(3, [1, 90, 256], 256, dt, gen)),
            ("L64 n_valid 1/33/64",
             lambda dt: dense_q8_inputs(3, [1, 33, 64], 64, dt, gen)),
        ]),
    }
    for name, (plain, kernel, cases) in specs.items():
        worst = dict.fromkeys(dtypes, 0.0)
        for label, make in cases:
            for dn, dt in dtypes.items():
                args, kw = make(dt)
                got = kernel(*args, **kw)
                want = plain(*args, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                ok = bool((err <= TOL[dn] + TOL[dn]
                           * want.float().abs()).all())
                worst[dn] = max(worst[dn], float(err.max()))
                log(f"  {name:<24} {label:<30} {dn:<8} "
                    f"max_abs_err={float(err.max()):.3e} tol={TOL[dn]:g} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{name} {label} {dn} disagrees")
        results[name] = {"name": name, **KERNELS[name],
                         "max_abs_err": max(worst.values()),
                         "max_err": worst, "tol": TOL}

    def timed(plain, kernel, args, kw, cost, lib, iters, dn):
        k_ms, p_ms = alternate(lambda: plain(*args, **kw),
                               lambda: kernel(*args, **kw), iters)
        b_ms, b_by = cost(args, kw.get("window", 0), dn)
        lib_ms = time_ms(lib, iters) if lib else None
        return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": lib_ms}

    bf = torch.bfloat16
    # the serve path's shapes: 4 slots over a 256-token ring (65 pages,
    # as the engine sizes its pool), one whole-prompt bucket of 128
    a, kw = decode_inputs(4, [40, 90, 150, 220], 16, bf, 0, gen, n_blocks=65)
    results["decode_attention_paged"].update(
        shape="B4 H28 KV4 hd128 P16 L256 len[40,90,150,220] bf16",
        **timed(dap.decode_attention_paged_plain,
                dap.decode_attention_paged_cuda, a, kw, decode_cost, None,
                50, "bfloat16"))
    a, kw = flash_inputs(1, 128, bf, 0, gen)
    results["flash_attention"].update(
        shape="B1 S128 H28 KV4 hd128 causal bf16",
        **timed(fa.flash_attention_plain,
                fa.flash_attention_cuda, a, kw, flash_cost, sdpa_fn(a), 50,
                "bfloat16"))
    # one long shape each
    a, kw = decode_inputs(16, [2048] * 16, 128, bf, 0, gen)
    results["decode_attention_paged"]["long"] = dict(
        shape="B16 len2048 H28 KV4 hd128 P16 bf16",
        **timed(dap.decode_attention_paged_plain,
                dap.decode_attention_paged_cuda, a, kw, decode_cost, None,
                10, "bfloat16"))
    a, kw = flash_inputs(1, 2048, bf, 0, gen)
    results["flash_attention"]["long"] = dict(
        shape="B1 S2048 H28 KV4 hd128 causal bf16",
        **timed(fa.flash_attention_plain,
                fa.flash_attention_cuda, a, kw, flash_cost, sdpa_fn(a), 5,
                "bfloat16"))
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
                    "bfloat16"))
        a, kw = make(16, [2048] * 16, 2048)
        results[name]["long"] = dict(
            shape=f"B16 len2048 H28 KV4 hd128 {kv_type} KV, bf16 q",
            **timed(plain, kernel, a, kw, cost, lib and lib(a), 10,
                    "bfloat16"))
    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{r['library_ms']} ms at {r['shape']}; long: "
            f"{json.dumps(r['long'])}")


def _serve_run(cfg, params, model, pairs, policy, discipline, paged):
    import torch
    from repro_torch.core.policies import make
    from repro_torch.engine.engine import Engine
    from repro_torch.launch.serve import _to_rts
    rts = _to_rts(pairs)
    eng = Engine(cfg, params, max_slots=4, max_seq_len=256, paged=paged,
                 device="cuda")
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
            "prefix_hit_rate": eng.prefix_stats()["hit_rate"]}


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
    from repro_torch.launch.serve import fit_latency_model
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
    for phase, fn in (("kernels", lambda: phase_kernels(ctx["results"])),
                      ("serve", lambda: phase_serve(ctx)),
                      ("int8", lambda: phase_int8(ctx)),
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
