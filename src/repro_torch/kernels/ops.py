"""Call-site wrappers for the port's kernels.

Counterpart of ``src/repro/kernels/ops.py``.  The implementation is picked by
the device of the tensors given: a CPU tensor runs the plain PyTorch
version, a CUDA tensor launches the hand-written kernel or the call
raises.  There is no mode switch and no fallback.

The reference's ``set_tp_shards`` has no counterpart: it sends paged
decode under tp > 1 to the jnp gather because ``pallas_call`` does not
partition under GSPMD.  Here each tensor-parallel rank is a process
whose pages hold whole kv heads of its shard, so K1 and K2 run on them
unchanged, and a tp > 1 call on a CUDA tensor launches the kernel like
any other.

Under a :class:`~repro_torch.kernels.cost.CostCounter` (the dry run's
count of a step) each wrapper adds its kernel's formula from
:mod:`repro_torch.kernels.cost`, whichever implementation runs, and the
aten ops inside it are not counted (:func:`~repro_torch.kernels.cost.counted`).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import anneal as _anneal
from repro_torch.kernels import cost
from repro_torch.kernels import decode_attention as _dense
from repro_torch.kernels import decode_attention_paged as _paged
from repro_torch.kernels import decode_attention_q8 as _dense_q8
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import ragged_dot as _ragged
from repro_torch.kernels import ssd_scan as _ssd

# calls of PyTorch's own kernels that are counted beside the port's
# (the MoE FFN's grouped product)
LIBRARY_CALLS = (_ragged.NAME,)


def launch_counts() -> Dict[str, int]:
    """Kernel launches, and the counted library calls, since the last
    :func:`reset_launch_counts`."""
    return {name: _build.LAUNCHES[name]
            for name in _build.KERNELS + LIBRARY_CALLS}


def reset_launch_counts():
    _build.LAUNCHES.clear()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """Causal (windowed) GQA attention over a whole sequence, or over
    ``q``'s rows at position ``q_offset`` of the keys (a
    sequence-parallel rank's rows: q [B,Sq,H,hd], k / v [B,Sk,KV,hd],
    q_offset + Sq <= Sk).

    Differentiable: when grad mode is on and any of q/k/v requires grad,
    it runs :class:`~repro_torch.kernels.flash_attention_bwd.FlashAttentionFn`
    (the forward that saves the log-sum-exp, then the dq and dk/dv
    backward); otherwise the forward-only kernel."""
    _flash.check_offset("flash_attention", q.shape[1], k.shape[1], q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _flash_bwd.FlashAttentionFn.apply(q, k, v, causal, window,
                                                 q_offset)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    fn = _flash.flash_attention_plain if q.device.type == "cpu" \
        else _flash.flash_attention_cuda
    return cost.counted(lambda: fn(q, k, v, **kw),
                        (_flash.NAME, lambda: cost.flash_work(q, k, window,
                                                              q_offset)))


def decode_attention_paged(q, k_pages, v_pages, block_tables, lengths, *,
                           window: int = 0):
    """Flash-decode through a block table (paged KV pool)."""
    args = (q, k_pages, v_pages, block_tables, lengths)
    fn = _paged.decode_attention_paged_plain if q.device.type == "cpu" \
        else _paged.decode_attention_paged_cuda
    return cost.counted(lambda: fn(*args, window=window),
                        (_paged.NAME, lambda: cost.paged_work(args, window)))


def decode_attention_paged_q8(q, k_pages, k_scale, v_pages, v_scale,
                              block_tables, lengths, *, window: int = 0):
    """int8-KV paged flash-decode (per-(token, head) bf16 scales)."""
    args = (q, k_pages, k_scale, v_pages, v_scale, block_tables, lengths)
    fn = _paged.decode_attention_paged_q8_plain if q.device.type == "cpu" \
        else _paged.decode_attention_paged_q8_cuda
    return cost.counted(lambda: fn(*args, window=window),
                        (_paged.NAME_Q8,
                         lambda: cost.paged_q8_work(args, window)))


def decode_attention(q, k_cache, v_cache, n_valid):
    """Flash-decode over a dense [B, L, kv, hd] cache."""
    args = (q, k_cache, v_cache, n_valid)
    fn = _dense.decode_attention_plain if q.device.type == "cpu" \
        else _dense.decode_attention_cuda
    return cost.counted(lambda: fn(*args),
                        (_dense.NAME, lambda: cost.dense_work(args)))


def decode_attention_q8(q, k_cache, k_scale, v_cache, v_scale, n_valid):
    """Flash-decode over a dense int8 cache with bf16 scales."""
    args = (q, k_cache, k_scale, v_cache, v_scale, n_valid)
    fn = _dense_q8.decode_attention_q8_plain if q.device.type == "cpu" \
        else _dense_q8.decode_attention_q8_cuda
    return cost.counted(lambda: fn(*args),
                        (_dense_q8.NAME, lambda: cost.dense_q8_work(args)))


def ssd_scan(x, dt, A, B, C, *, chunk: int, init_state=None):
    """Mamba2 SSD chunk scan from ``init_state`` (zeros when None).
    -> (y [b,s,nh,hd] in x's dtype, final_state [b,nh,hd,ds] f32).

    Differentiable through :class:`~repro_torch.kernels.ssd_scan.SSDScanFn`:
    the forward is the plain version on the CPU and the K4 kernel on the
    card, with or without grad; the backward (float32 only) is the plain
    VJP on the CPU and the SSD backward kernel on the card."""
    return _ssd.SSDScanFn.apply(x, dt, A, B, C, init_state, chunk)


def ragged_dot(x, w, group_sizes):
    """The MoE FFN's grouped product: rows of ``x`` [T, K] in consecutive
    groups of ``group_sizes`` [G], group g times ``w[g]`` ([G, K, N]).
    -> [T, N].  Counted by its formula in the forward; its backward is
    the aten ops autograd runs (:mod:`repro_torch.kernels.cost`)."""
    fn = _ragged.ragged_dot_plain if x.device.type == "cpu" \
        else _ragged.ragged_dot_cuda
    return cost.counted(lambda: fn(x, w, group_sizes),
                        (_ragged.NAME,
                         lambda: _ragged.ragged_work(x, w, group_sizes)))


def anneal_chains(reqc, n_valid, draws, max_batch: int, T0: float,
                  T_thres: float, tau: float, iters: int,
                  incremental: bool = True):
    """The batched simulated anneal over instances x chains (Algorithm 1,
    ``draws`` the uniforms each proposal reads).  -> (best perm [I,C,N]
    int32, best bnd [I,C,N] bool, best G [I,C])."""
    fn = _anneal.anneal_chains_plain if reqc.device.type == "cpu" \
        else _anneal.anneal_chains_cuda
    return cost.counted(
        lambda: fn(reqc, n_valid, draws, max_batch, T0, T_thres, tau, iters,
                   incremental),
        (_anneal.NAME, lambda: _anneal.anneal_work(
            reqc, draws, max_batch, T0, T_thres, tau, iters, incremental)))
