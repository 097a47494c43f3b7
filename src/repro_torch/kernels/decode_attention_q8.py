"""Dense flash-decode over an int8 cache with per-(token, kv head) bf16
scales.

Counterpart of the Pallas TPU kernel
``repro/kernels/decode_attention_q8.py::decode_attention_q8``.  The
hand-written CUDA kernel is ``decode_attention_q8`` in
``csrc/decode_attention.cu``: bf16 q runs the split-KV tensor-core block
``csrc/decode_attention_split_sm90.cuh``, float32 q the scalar block
``csrc/decode_attention_common.cuh`` (both shared with the other decode
kernels; each header says what bounds it on the card and how the design
answers); this module holds its launch wrapper and the plain PyTorch
version of the same function.

The cache is dequantized exactly: the plain version multiplies int8 x
bf16 scale in float32 before the float math, as the TPU kernel does in
VMEM; the bf16-q CUDA kernel feeds the int8 values (exact in bf16) to
the tensor cores and applies the K scale to the scores and the V scale
to the probabilities, the float32-q kernel dequantizes in registers.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (check_dense,
                                                  decode_attention_plain)
from repro_torch.kernels.decode_attention_paged import (BLOCKS_PER_SM_Q8,
                                                        DTYPE_CODES,
                                                        check_decode,
                                                        split_args)
from repro_torch.models.cache import dequantize_kv

NAME = "decode_attention_q8"


def decode_attention_q8_plain(q, k_cache, k_scale, v_cache, v_scale,
                              n_valid):
    """q: [B,H,hd] bf16/f32; caches: [B,L,KV,hd] int8; scales:
    [B,L,KV,1] bf16; n_valid: [B]. -> [B,H,hd]."""
    f32 = torch.float32
    return decode_attention_plain(q, dequantize_kv(k_cache, k_scale, f32),
                                  dequantize_kv(v_cache, v_scale, f32),
                                  n_valid)


def decode_attention_q8_cuda(q, k_cache, k_scale, v_cache, v_scale,
                             n_valid):
    """Launch the CUDA kernel on the current stream: bf16 q the split-KV
    kernel (pass 1, then the combine when ``split_plan`` splits the
    ring: one counted call, two launches), float32 q the scalar one.
    Reads nothing back to the host, so it can be captured in a CUDA
    graph.  Raises on anything the kernel does not take; never falls
    back."""
    b, h, kv, hd = check_decode(NAME, q, k_cache, v_cache, k_scale, v_scale,
                                n_valid=n_valid)
    check_dense(NAME, b, k_cache, n_valid)
    L = k_cache.shape[1]
    out = torch.empty_like(q)
    splits, split_len, acc, m, l, _ws = split_args(
        q, kv, L, blocks_per_sm=BLOCKS_PER_SM_Q8)
    err = _build.load(NAME)(
        q.data_ptr(), k_cache.data_ptr(), k_scale.data_ptr(),
        v_cache.data_ptr(), v_scale.data_ptr(), n_valid.data_ptr(),
        out.data_ptr(), acc, m, l, b, h, kv, hd, L, splits, split_len,
        DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(NAME, err)
    _build.LAUNCHES[NAME] += 1
    return out
