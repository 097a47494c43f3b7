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


def masked_scores(q, k, causal: bool, window: int, q_offset: int = 0):
    """Scaled f32 scores [B,H,Sq,Sk] with kv heads read per group and
    NEG_INF outside the band, and the [Sq,Sk] mask (True = attends).
    Query row i sits at position ``q_offset + i`` of the keys (a
    sequence-parallel rank's rows), as the reference's
    ``_causal_mask(q_len, kv_len, q_offset, window)`` places it."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    rep = h // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", upcast(q), upcast(k)) \
        * hd ** -0.5
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return scores.masked_fill(~mask[None, None], NEG_INF), mask


def flash_attention_fwd_lse_plain(q, k, v, *, causal: bool = True,
                                  window: int = 0, q_offset: int = 0):
    """q: [B,Sq,H,hd]; k,v: [B,Sk,KV,hd] (KV divides H; Sk >= q_offset +
    Sq, query row i at position q_offset + i).  -> (out [B,Sq,H,hd] in
    q's dtype, lse [B,H,Sq] float32)."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        v = v.repeat_interleave(rep, dim=2)
    scores, _ = masked_scores(q, k, causal, window, q_offset)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, upcast(v)).to(q.dtype)
    return out, torch.logsumexp(scores, dim=-1)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0):
    """q: [B,Sq,H,hd]; k,v: [B,Sk,KV,hd] (KV divides H). -> [B,Sq,H,hd]."""
    return flash_attention_fwd_lse_plain(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset)[0]


def check_inputs(name, q, k, v, q_offset: int = 0):
    """Raise unless the CUDA flash kernels take (q, k, v) at ``q_offset``:
    one CUDA device, float32 or bfloat16, [B,Sq,H,hd] / [B,Sk,KV,hd]
    with hd in HEAD_DIMS, KV dividing H and every query inside the keys
    (0 <= q_offset, q_offset + Sq <= Sk), contiguous, 16-byte aligned.
    Returns (b, sq, sk, h, kv, hd, dtype code)."""
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
    b, sq, h, hd = q.shape
    kb, sk, kv, khd = k.shape
    if (kb, khd) != (b, hd):
        raise ValueError(f"{name}: k/v {tuple(k.shape)} vs q {tuple(q.shape)}")
    check_offset(name, sq, sk, q_offset)
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if kv == 0 or h % kv:
        raise ValueError(f"{name}: {h} q heads over {kv} kv heads")
    for n, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {n} must be 16-byte aligned")
    return b, sq, sk, h, kv, hd, _DTYPE_CODES[q.dtype]


def check_offset(name, sq: int, sk: int, q_offset: int):
    """Raise unless ``sq`` query rows at ``q_offset`` lie inside ``sk``
    keys (a query past the last key would attend to keys it has not
    got)."""
    if int(q_offset) != q_offset or q_offset < 0 or q_offset + sq > sk:
        raise ValueError(f"{name}: {sq} query rows at offset {q_offset} "
                         f"do not lie inside {sk} keys")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int = 0):
    """Launch the CUDA kernel on the current stream.  Raises on anything
    the kernel does not take; never falls back."""
    b, sq, sk, h, kv, hd, code = check_inputs(NAME, q, k, v, q_offset)
    out = torch.empty_like(q)
    err = _build.load(NAME)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        int(q_offset), h, kv, hd, int(bool(causal)), int(window), code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(NAME, err)
    _build.LAUNCHES[NAME] += 1
    return out
