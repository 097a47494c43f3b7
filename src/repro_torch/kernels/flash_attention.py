"""Prefill flash attention: causal, optional sliding window, GQA.

Counterpart of the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.  The hand-written
CUDA kernel is ``csrc/flash_attention.cu`` (its header says what bounds
it on the card and how the design answers); this module holds its
launch wrapper and the plain PyTorch version of the same function.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
NAME = "flash_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,S,H,hd]; k,v: [B,S,KV,hd] (KV divides H). -> [B,S,H,hd]."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * hd ** -0.5
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Launch the CUDA kernel on the current stream.  Raises on anything
    the kernel does not take; never falls back."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: CUDA kernel got a {dev} tensor")
    if k.device != dev or v.device != dev:
        raise ValueError(f"{NAME}: q/k/v on {dev}/{k.device}/{v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{NAME}: q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{NAME}: bad shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    b, s, h, hd = q.shape
    kb, ks, kv, khd = k.shape
    if (kb, ks, khd) != (b, s, hd):
        raise ValueError(f"{NAME}: k/v {tuple(k.shape)} vs q {tuple(q.shape)}")
    if hd not in (64, 128):
        raise ValueError(f"{NAME}: head_dim {hd} not in (64, 128)")
    if kv == 0 or h % kv:
        raise ValueError(f"{NAME}: {h} q heads over {kv} kv heads")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{NAME}: k/v must be 16-byte aligned")
    out = torch.empty_like(q)
    err = _build.load(NAME)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h,
        kv, hd, int(bool(causal)), int(window), _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(NAME, err)
    _build.LAUNCHES[NAME] += 1
    return out
