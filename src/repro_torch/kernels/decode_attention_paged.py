"""Paged flash-decode: one-token GQA decode through a block table, over
float or int8 pages.

Counterpart of the Pallas TPU kernels
``repro/kernels/decode_attention_paged.py::decode_attention_paged`` and
``::decode_attention_paged_q8``.  The hand-written CUDA kernels are in
``csrc/decode_attention_paged.cu``: bf16 q, over bf16 or int8 pages,
runs the split-KV tensor-core block
``csrc/decode_attention_split_sm90.cuh``, float32 q the scalar block
``csrc/decode_attention_common.cuh`` (both shared with the dense decode
kernels; each header says what bounds it on the card and how the design
answers).  This module holds their launch wrappers, the split plan of
the bf16-q kernels (:func:`split_plan`), and the plain PyTorch versions
of the same functions, which the CPU path runs and the card is held
to.

Masking is by token id on the slot's logical ring of length
``pages_per_seq * page_size``: ring slot ``s`` holds token
``t_s = len-1 - mod(len-1-s, L)`` (floor mod — ``torch.remainder``,
never ``fmod``), masked when negative (not yet written) or, with a
window, evicted.

int8 pages are dequantized exactly: the plain version multiplies int8 x
bf16 scale in float32 before the float math, as the TPU kernel does in
VMEM; the bf16-q CUDA kernel feeds the int8 values (exact in bf16) to
the tensor cores and applies the K scale to the scores and the V scale
to the probabilities, the float32-q kernel dequantizes in registers.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models.cache import dequantize_kv

NEG_INF = -1e30
NAME = "decode_attention_paged"
NAME_Q8 = "decode_attention_paged_q8"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the split kernel's key tile (csrc/decode_attention_split_sm90.cuh:
# kKeys, 16 ring slots for each of 4 warps), the engine's page size, the
# SMs of an H100, and the blocks of the split kernel one SM holds at once
# over bf16 K/V (two at hd 128: 104 KB of K/V ring each) and over int8
# K/V (three: kMinBlocks, 67 KB each at hd 128)
KEY_TILE = 64
PAGE = 16
SMS = 132
BLOCKS_PER_SM = 2
BLOCKS_PER_SM_Q8 = 3


def split_plan(batch: int, kv_heads: int, L: int, *, page: int = PAGE,
               sms: int = SMS, blocks_per_sm: int = BLOCKS_PER_SM):
    """(splits, split_len) of the bf16-q split-KV decode over a ring of
    ``L`` slots: split ``i`` walks slots ``[i*split_len, min((i+1)*
    split_len, L))``.  From static shapes only, never from the lengths
    (reading them would sync the host).  ``split_len`` is a multiple of
    ``page`` and of :data:`KEY_TILE`; the splits cover ``[0, L)`` once,
    none empty.  As many splits as fit one wave of
    ``blocks_per_sm * sms`` blocks over the ``batch * kv_heads``
    (sequence, kv head) pairs, at most one per granule; one split (a
    single launch) when the pairs fill the wave alone."""
    granule = KEY_TILE * page // math.gcd(KEY_TILE, page)
    n_gran = -(-L // granule)
    want = max(1, blocks_per_sm * sms // max(1, batch * kv_heads))
    split_len = -(-n_gran // min(n_gran, want)) * granule
    return -(-L // split_len), split_len


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split_args(q, kv_heads: int, L: int, page: int = PAGE,
               blocks_per_sm: int = BLOCKS_PER_SM):
    """The launch's split arguments for q: (num_splits, split_len,
    acc_ptr, m_ptr, l_ptr, workspace).  bf16 q (over bf16 K/V, or int8
    with ``blocks_per_sm=BLOCKS_PER_SM_Q8``) gets :func:`split_plan` on
    q's card and, with more than one split, one f32 workspace for the
    partials acc [B, H, splits, hd], m and l [B, H, splits] (torch.empty;
    the caller keeps it until the launch is queued).  float32 runs the
    scalar block: one split, no partials."""
    if q.dtype != torch.bfloat16:
        return 1, L, 0, 0, 0, None
    b, h, hd = q.shape
    splits, split_len = split_plan(b, kv_heads, L, page=page,
                                   sms=_sms(q.device),
                                   blocks_per_sm=blocks_per_sm)
    if splits == 1:
        return 1, split_len, 0, 0, 0, None
    n = b * h * splits
    ws = torch.empty(n * (hd + 2), dtype=torch.float32, device=q.device)
    acc = ws.data_ptr()
    return splits, split_len, acc, acc + 4 * n * hd, acc + 4 * n * (hd + 1), \
        ws


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


def decode_attention_paged_q8_plain(q, k_pages, k_scale, v_pages, v_scale,
                                    block_tables, lengths, *,
                                    window: int = 0):
    """int8 pages [N,P,KV,hd] + bf16 scales [N,P,KV,1]: dequantize the
    pool in float32, then :func:`decode_attention_paged_plain`."""
    f32 = torch.float32
    return decode_attention_paged_plain(
        q, dequantize_kv(k_pages, k_scale, f32),
        dequantize_kv(v_pages, v_scale, f32), block_tables, lengths,
        window=window)


def check_decode(name, q, k, v, k_scale=None, v_scale=None, **ints):
    """Validate the arguments of a decode kernel (paged or dense, float
    or int8 with scales).  ``ints`` are the int32 index tensors.  Returns
    (batch, q heads, kv heads, head_dim); raises on anything the kernel
    does not take."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: CUDA kernel got a {dev} tensor")
    named = {"q": q, "k": k, "v": v, **ints}
    if k_scale is not None:
        named.update(k_scale=k_scale, v_scale=v_scale)
    for n, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name}: {n} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
    kv_dtype = q.dtype if k_scale is None else torch.int8
    if q.dtype not in DTYPE_CODES or k.dtype != kv_dtype \
            or v.dtype != kv_dtype:
        raise TypeError(f"{name}: q must be float32 or bfloat16 and k/v "
                        f"{'int8' if k_scale is not None else 'the same'}, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    for n, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {n} must be int32, got {t.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    if k_scale is not None:
        want = tuple(k.shape[:3]) + (1,)
        for n, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.dtype != torch.bfloat16 or tuple(t.shape) != want:
                raise ValueError(f"{name}: {n} must be bfloat16 {want}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
    b, h, hd = q.shape
    kv, hd_k = k.shape[2], k.shape[3]
    if hd not in HEAD_DIMS or hd_k != hd:
        raise ValueError(f"{name}: head_dim {hd}/{hd_k} not in {HEAD_DIMS}")
    if kv == 0 or h % kv or h // kv > 16:
        raise ValueError(f"{name}: {h} q heads over {kv} kv heads "
                         "(group must divide and be <= 16)")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: k/v must be 16-byte aligned")
    return b, h, kv, hd


def _check_tables(name, b, block_tables, lengths):
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or lengths.shape != (b,):
        raise ValueError(f"{name}: block_tables {tuple(block_tables.shape)}"
                         f" / lengths {tuple(lengths.shape)} for batch {b}")


def decode_attention_paged_cuda(q, k_pages, v_pages, block_tables, lengths,
                                *, window: int = 0):
    """Launch the CUDA kernel on the current stream: bf16 the split-KV
    kernel (pass 1, then the combine when :func:`split_plan` splits the
    ring: one counted call, two launches), float32 the scalar one.
    Reads nothing back to the host, so it can be captured in a CUDA
    graph.  Raises on anything the kernel does not take; never falls
    back."""
    b, h, kv, hd = check_decode(NAME, q, k_pages, v_pages,
                                block_tables=block_tables, lengths=lengths)
    _check_tables(NAME, b, block_tables, lengths)
    n_blocks, P = k_pages.shape[:2]
    pages_per_seq = block_tables.shape[1]
    out = torch.empty_like(q)
    splits, split_len, acc, m, l, _ws = split_args(q, kv,
                                                   pages_per_seq * P, P)
    err = _build.load(NAME)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        acc, m, l, b, h, kv, hd, n_blocks, P, pages_per_seq, int(window),
        splits, split_len, DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(NAME, err)
    _build.LAUNCHES[NAME] += 1
    return out


def decode_attention_paged_q8_cuda(q, k_pages, k_scale, v_pages, v_scale,
                                   block_tables, lengths, *,
                                   window: int = 0):
    """Launch the int8 CUDA kernel on the current stream (q/out float32
    or bf16): bf16 q the split-KV kernel, split as
    :func:`decode_attention_paged_cuda` splits it, float32 q the scalar
    one.  Reads nothing back to the host.  Raises on anything the kernel
    does not take; never falls back."""
    b, h, kv, hd = check_decode(NAME_Q8, q, k_pages, v_pages, k_scale,
                                v_scale, block_tables=block_tables,
                                lengths=lengths)
    _check_tables(NAME_Q8, b, block_tables, lengths)
    n_blocks, P = k_pages.shape[:2]
    pages_per_seq = block_tables.shape[1]
    out = torch.empty_like(q)
    splits, split_len, acc, m, l, _ws = split_args(
        q, kv, pages_per_seq * P, P, blocks_per_sm=BLOCKS_PER_SM_Q8)
    err = _build.load(NAME_Q8)(
        q.data_ptr(), k_pages.data_ptr(), k_scale.data_ptr(),
        v_pages.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), acc, m, l, b, h, kv, hd,
        n_blocks, P, pages_per_seq, int(window), splits, split_len,
        DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(NAME_Q8, err)
    _build.LAUNCHES[NAME_Q8] += 1
    return out
