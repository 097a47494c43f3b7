"""Prefill flash attention: causal, optional sliding window, GQA.

Counterpart of the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.  The hand-written
CUDA kernel is ``csrc/flash_attention.cu``: bf16 on the tensor-core
block of ``csrc/flash_attention_fwd_sm90.cuh`` (whose header says what
bounds it on the card and how the design answers), float32 on the
scalar parity block of ``csrc/flash_attention_fwd.cuh``; this module
holds its launch
wrapper and the plain PyTorch version of the same function, which also
gives the per-row log-sum-exp that the training forward (K5a in
``flash_attention_bwd``) saves.
"""
from __future__ import annotations

import torch

from repro_torch.device import upcast
from repro_torch.kernels import _build

NEG_INF = -1e30
NAME = "flash_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head widths every attention kernel is compiled for (h2o-danube's 80
# beside 64 and 128)
HEAD_DIMS = (64, 80, 128)


def masked_scores(q, k, causal: bool, window: int):
    """Scaled f32 scores [B,H,S,S] with kv heads read per group and
    NEG_INF outside the band, and the [S,S] mask (True = attends)."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", upcast(q), upcast(k)) \
        * hd ** -0.5
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return scores.masked_fill(~mask[None, None], NEG_INF), mask


def flash_attention_fwd_lse_plain(q, k, v, *, causal: bool = True,
                                  window: int = 0):
    """q: [B,S,H,hd]; k,v: [B,S,KV,hd] (KV divides H).  -> (out
    [B,S,H,hd] in q's dtype, lse [B,H,S] float32)."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        v = v.repeat_interleave(rep, dim=2)
    scores, _ = masked_scores(q, k, causal, window)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, upcast(v)).to(q.dtype)
    return out, torch.logsumexp(scores, dim=-1)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,S,H,hd]; k,v: [B,S,KV,hd] (KV divides H). -> [B,S,H,hd]."""
    return flash_attention_fwd_lse_plain(q, k, v, causal=causal,
                                         window=window)[0]


def check_inputs(name, q, k, v):
    """Raise unless the CUDA flash kernels take (q, k, v): one CUDA
    device, float32 or bfloat16, [B,S,H,hd] / [B,S,KV,hd] with hd in
    HEAD_DIMS and KV dividing H, contiguous, 16-byte aligned.  Returns
    (b, s, h, kv, hd, dtype code)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: CUDA kernel got a {dev} tensor")
    if k.device != dev or v.device != dev:
        raise ValueError(f"{name}: q/k/v on {dev}/{k.device}/{v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    b, s, h, hd = q.shape
    kb, ks, kv, khd = k.shape
    if (kb, ks, khd) != (b, s, hd):
        raise ValueError(f"{name}: k/v {tuple(k.shape)} vs q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if kv == 0 or h % kv:
        raise ValueError(f"{name}: {h} q heads over {kv} kv heads")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must be 16-byte aligned")
    return b, s, h, kv, hd, _DTYPE_CODES[q.dtype]


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the CUDA kernel on the current stream.  Raises on anything
    the kernel does not take; never falls back."""
    b, s, h, kv, hd, code = check_inputs(NAME, q, k, v)
    out = torch.empty_like(q)
    err = _build.load(NAME)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        kv, hd, int(bool(causal)), int(window), code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(NAME, err)
    _build.LAUNCHES[NAME] += 1
    return out
