"""Paged flash-decode: one-token GQA decode through a block table.

Counterpart of the Pallas TPU kernel
``repro/kernels/decode_attention_paged.py::decode_attention_paged``.
The hand-written CUDA kernel is ``csrc/decode_attention_paged.cu`` (its
header says what bounds it on the card and how the design answers);
this module holds its launch wrapper and the plain PyTorch version of
the same function, which the CPU path runs and the card is held to.

Masking is by token id on the slot's logical ring of length
``pages_per_seq * page_size``: ring slot ``s`` holds token
``t_s = len-1 - mod(len-1-s, L)`` (floor mod — ``torch.remainder``,
never ``fmod``), masked when negative (not yet written) or, with a
window, evicted.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
NAME = "decode_attention_paged"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_paged_plain(q, k_pages, v_pages, block_tables, lengths,
                                 *, window: int = 0):
    """Gather the live pages into the logical [B, L, kv, hd] view, then
    masked softmax attention in float32.

    q: [B,H,hd]; pages: [N,P,KV,hd]; block_tables: [B,pages_per_seq];
    lengths: [B] (context length incl. the current token). -> [B,H,hd].
    """
    b, h, hd = q.shape
    P, kv = k_pages.shape[1], k_pages.shape[2]
    num_pages = block_tables.shape[1]
    L = num_pages * P
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, L, kv, hd)
    v = v_pages[bt].reshape(b, L, kv, hd)
    rep = h // kv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bhd,blhd->bhl", q.float(), k.float()) * hd ** -0.5
    ln = lengths.long()[:, None]
    s_idx = torch.arange(L, device=q.device)[None, :]
    t_s = ln - 1 - torch.remainder(ln - 1 - s_idx, L)
    valid = t_s >= 0
    if window > 0:
        valid &= t_s > ln - 1 - window
    scores = scores.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhl,blhd->bhd", p, v.float()).to(q.dtype)


def decode_attention_paged_cuda(q, k_pages, v_pages, block_tables, lengths,
                                *, window: int = 0):
    """Launch the CUDA kernel on the current stream.  Raises on anything
    the kernel does not take; never falls back."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: CUDA kernel got a {dev} tensor")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{NAME}: {name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"{NAME}: q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"{NAME}: block_tables and lengths must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{NAME}: bad shapes q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    b, h, hd = q.shape
    n_blocks, P, kv, hd_k = k_pages.shape
    if hd not in (64, 128) or hd_k != hd:
        raise ValueError(f"{NAME}: head_dim {hd}/{hd_k} not in (64, 128)")
    if kv == 0 or h % kv or h // kv > 16:
        raise ValueError(f"{NAME}: {h} q heads over {kv} kv heads "
                         "(group must divide and be <= 16)")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError(f"{NAME}: block_tables {tuple(block_tables.shape)}"
                         f" / lengths {tuple(lengths.shape)} for batch {b}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{NAME}: pages must be 16-byte aligned")
    out = torch.empty_like(q)
    lib = _build.load(NAME)
    err = lib.decode_attention_paged(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, kv, hd, n_blocks, P, block_tables.shape[1], int(window),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(NAME, err)
    _build.LAUNCHES[NAME] += 1
    return out
