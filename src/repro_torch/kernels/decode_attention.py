"""Dense flash-decode: one-token GQA decode over a contiguous
``[B, L, kv, hd]`` cache.

Counterpart of the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``.  The
hand-written CUDA kernel is ``csrc/decode_attention.cu``: bf16 runs the
split-KV tensor-core block ``csrc/decode_attention_split_sm90.cuh``,
float32 the scalar block ``csrc/decode_attention_common.cuh`` (both
shared with the paged decode kernels; each header says what bounds it
on the card and how the design answers).  This module holds its launch
wrapper and the plain PyTorch version of the same function.  Keys at
positions ``< n_valid[b]`` are attended; unlike the TPU kernel any
``L`` is taken.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention_paged import (DTYPE_CODES,
                                                        check_decode,
                                                        split_args)

NEG_INF = -1e30
NAME = "decode_attention"


def decode_attention_plain(q, k_cache, v_cache, n_valid):
    """q: [B,H,hd]; caches: [B,L,KV,hd]; n_valid: [B]. -> [B,H,hd].
    Masked softmax attention in float32 with ``q·hd^-0.5``."""
    h, hd = q.shape[1], q.shape[2]
    L, kv = k_cache.shape[1], k_cache.shape[2]
    rep = h // kv
    if rep > 1:
        k_cache = k_cache.repeat_interleave(rep, dim=2)
        v_cache = v_cache.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bhd,blhd->bhl", q.float(),
                          k_cache.float()) * hd ** -0.5
    valid = torch.arange(L, device=q.device)[None, :] \
        < n_valid.long()[:, None]
    scores = scores.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhl,blhd->bhd", p, v_cache.float()).to(q.dtype)


def check_dense(name, b, k_cache, n_valid):
    if k_cache.shape[0] != b or n_valid.shape != (b,):
        raise ValueError(f"{name}: cache {tuple(k_cache.shape)} / n_valid "
                         f"{tuple(n_valid.shape)} for batch {b}")


def decode_attention_cuda(q, k_cache, v_cache, n_valid):
    """Launch the CUDA kernel on the current stream: bf16 the split-KV
    kernel (pass 1, then the combine when ``split_plan`` splits the
    ring: one counted call, two launches), float32 the scalar one.
    Reads nothing back to the host, so it can be captured in a CUDA
    graph.  Raises on anything the kernel does not take; never falls
    back."""
    b, h, kv, hd = check_decode(NAME, q, k_cache, v_cache, n_valid=n_valid)
    check_dense(NAME, b, k_cache, n_valid)
    L = k_cache.shape[1]
    out = torch.empty_like(q)
    splits, split_len, acc, m, l, _ws = split_args(q, kv, L)
    err = _build.load(NAME)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        n_valid.data_ptr(), out.data_ptr(), acc, m, l, b, h, kv, hd, L,
        splits, split_len, DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(NAME, err)
    _build.LAUNCHES[NAME] += 1
    return out
