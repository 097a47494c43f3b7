"""Call-site wrappers for the port's kernels.

Counterpart of ``src/repro/kernels/ops.py``.  The implementation is picked by
the device of the tensors given: a CPU tensor runs the plain PyTorch
version, a CUDA tensor launches the hand-written kernel or the call
raises.  There is no mode switch and no fallback.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as _dense
from repro_torch.kernels import decode_attention_paged as _paged
from repro_torch.kernels import decode_attention_q8 as _dense_q8
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import ssd_scan as _ssd


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: _build.LAUNCHES[name] for name in _build.KERNELS}


def reset_launch_counts():
    _build.LAUNCHES.clear()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Causal (windowed) GQA attention over a whole sequence.

    Differentiable: when grad mode is on and any of q/k/v requires grad,
    it runs :class:`~repro_torch.kernels.flash_attention_bwd.FlashAttentionFn`
    (the forward that saves the log-sum-exp, then the dq and dk/dv
    backward); otherwise the forward-only kernel."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _flash_bwd.FlashAttentionFn.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return _flash.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
    return _flash.flash_attention_cuda(q, k, v, causal=causal, window=window)


def decode_attention_paged(q, k_pages, v_pages, block_tables, lengths, *,
                           window: int = 0):
    """Flash-decode through a block table (paged KV pool)."""
    if q.device.type == "cpu":
        return _paged.decode_attention_paged_plain(
            q, k_pages, v_pages, block_tables, lengths, window=window)
    return _paged.decode_attention_paged_cuda(
        q, k_pages, v_pages, block_tables, lengths, window=window)


def decode_attention_paged_q8(q, k_pages, k_scale, v_pages, v_scale,
                              block_tables, lengths, *, window: int = 0):
    """int8-KV paged flash-decode (per-(token, head) bf16 scales)."""
    if q.device.type == "cpu":
        return _paged.decode_attention_paged_q8_plain(
            q, k_pages, k_scale, v_pages, v_scale, block_tables, lengths,
            window=window)
    return _paged.decode_attention_paged_q8_cuda(
        q, k_pages, k_scale, v_pages, v_scale, block_tables, lengths,
        window=window)


def decode_attention(q, k_cache, v_cache, n_valid):
    """Flash-decode over a dense [B, L, kv, hd] cache."""
    if q.device.type == "cpu":
        return _dense.decode_attention_plain(q, k_cache, v_cache, n_valid)
    return _dense.decode_attention_cuda(q, k_cache, v_cache, n_valid)


def decode_attention_q8(q, k_cache, k_scale, v_cache, v_scale, n_valid):
    """Flash-decode over a dense int8 cache with bf16 scales."""
    if q.device.type == "cpu":
        return _dense_q8.decode_attention_q8_plain(q, k_cache, k_scale,
                                                   v_cache, v_scale, n_valid)
    return _dense_q8.decode_attention_q8_cuda(q, k_cache, k_scale, v_cache,
                                              v_scale, n_valid)


def ssd_scan(x, dt, A, B, C, *, chunk: int, init_state=None):
    """Mamba2 SSD chunk scan from ``init_state`` (zeros when None).
    -> (y [b,s,nh,hd] in x's dtype, final_state [b,nh,hd,ds] f32).
    Forward only: the kernel has no backward yet, so a call that would
    need gradients raises rather than return a result autograd cannot
    see through."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, init_state)):
        raise NotImplementedError("the SSD scan has no backward kernel: "
                                  "training SSM layers is ROADMAP.md M10")
    if x.device.type == "cpu":
        return _ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                   init_state=init_state)
    return _ssd.ssd_scan_cuda(x, dt, A, B, C, init_state=init_state)
