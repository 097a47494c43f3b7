"""Differentiable flash attention: the forward that saves the per-row
log-sum-exp, and the dq and dk/dv backward.

Counterpart of ``repro/kernels/flash_attention_bwd.py`` (three Pallas TPU
kernels behind the ``jax.custom_vjp`` ``flash_attention_vjp``).  The
hand-written CUDA kernels are in ``csrc/flash_attention_bwd.cu`` (its
header says what bounds them on the card and how the design answers);
this module holds their launch wrappers, the plain PyTorch backward
(the JAX kernels' math written out, not autograd; the plain forward
with lse is K2's, ``flash_attention.flash_attention_fwd_lse_plain``),
and :class:`FlashAttentionFn`, the ``torch.autograd.Function`` that
picks one or the other by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.device import upcast
from repro_torch.kernels import _build, cost
from repro_torch.kernels.flash_attention import (  # noqa: F401  (K5a plain)
    check_inputs, flash_attention_fwd_lse_plain, masked_scores)

FWD, DQ, DKV = ("flash_attention_fwd_lse", "flash_attention_dq",
                "flash_attention_dkv")


def attention_delta(out, dout) -> torch.Tensor:
    """Δ = rowsum(out ⊙ dout) in f32, [B,H,S] (the JAX backward computes
    it outside its kernels too)."""
    return (upcast(out) * upcast(dout)).sum(-1).transpose(1, 2) \
        .contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0):
    """Gradients of :func:`flash_attention_fwd_lse_plain`'s ``out`` given
    its cotangent ``dout``: P recomputed from ``lse``, dP = dout·Vᵀ,
    dS = P ⊙ (dP − Δ) · scale; dq = dS·K, dk = dSᵀ·Q and dv = Pᵀ·dout,
    each summed over the GQA group's q heads.  q, out, dout [B,Sq,H,hd]
    at ``q_offset`` into k, v [B,Sk,KV,hd]: dq is [B,Sq,H,hd] and dk, dv
    [B,Sk,KV,hd], zero on the keys no query row sees.  -> (dq, dk, dv)
    in the inputs' dtypes."""
    b, _, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = hd ** -0.5
    scores, mask = masked_scores(q, k, causal, window, q_offset)
    p = torch.where(mask, torch.exp(scores - lse[..., None]), 0.0)
    dof, qf = upcast(dout), upcast(q)
    kf = upcast(k).repeat_interleave(rep, dim=2)
    vf = upcast(v).repeat_interleave(rep, dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - attention_delta(out, dout)[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, sk, kv, rep, hd).sum(3)
    dv = dv.reshape(b, sk, kv, rep, hd).sum(3)
    # contiguous, as the kernels write them
    return dq.to(q.dtype).contiguous(), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ CUDA wrappers
def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd_lse_cuda(q, k, v, *, causal: bool = True,
                                 window: int = 0, q_offset: int = 0):
    """Launch K5a (forward + lse) on the current stream.  Raises on
    anything the kernel does not take; never falls back."""
    b, sq, sk, h, kv, hd, code = check_inputs(FWD, q, k, v, q_offset)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = _build.load(FWD)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, sk, int(q_offset), h, kv, hd,
        int(bool(causal)), int(window), code, _stream(q))
    _build.check(FWD, err)
    _build.LAUNCHES[FWD] += 1
    return out, lse


def _check_bwd(name, q, k, v, dout, lse, delta, q_offset):
    """check_inputs, plus dout like q and lse/delta f32 [B,H,Sq], all
    contiguous and aligned on q's device."""
    dims = check_inputs(name, q, k, v, q_offset)
    b, s, h = dims[0], dims[1], dims[3]
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or dout.device != q.device or not dout.is_contiguous() \
            or dout.data_ptr() % 16:
        raise ValueError(f"{name}: dout must be a contiguous, 16-byte "
                         f"aligned {q.dtype} {tuple(q.shape)} on {q.device}")
    for n, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, s) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be a contiguous float32 "
                             f"{(b, h, s)} on {q.device}")
    return dims


def flash_attention_dq_cuda(q, k, v, dout, lse, delta, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0):
    """Launch K5b (dq) on the current stream; ``delta`` from
    :func:`attention_delta`.  Raises on anything it does not take."""
    b, sq, sk, h, kv, hd, code = _check_bwd(DQ, q, k, v, dout, lse, delta,
                                            q_offset)
    dq = torch.empty_like(q)
    err = _build.load(DQ)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, sq, sk,
        int(q_offset), h, kv, hd, int(bool(causal)), int(window), code,
        _stream(q))
    _build.check(DQ, err)
    _build.LAUNCHES[DQ] += 1
    return dq


def flash_attention_dkv_cuda(q, k, v, dout, lse, delta, *,
                             causal: bool = True, window: int = 0,
                             q_offset: int = 0):
    """Launch K5c (dk, dv summed over each kv head's q-head group) on
    the current stream; every key row is written, zeros where no query
    row at ``q_offset`` sees it.  Raises on anything it does not take."""
    b, sq, sk, h, kv, hd, code = _check_bwd(DKV, q, k, v, dout, lse, delta,
                                            q_offset)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _build.load(DKV)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b,
        sq, sk, int(q_offset), h, kv, hd, int(bool(causal)), int(window),
        code, _stream(q))
    _build.check(DKV, err)
    _build.LAUNCHES[DKV] += 1
    return dk, dv


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool = True,
                             window: int = 0, q_offset: int = 0):
    """Δ as a torch op, then K5b and K5c.  -> (dq, dk, dv)."""
    delta = attention_delta(out, dout)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    dq = flash_attention_dq_cuda(q, k, v, dout, lse, delta, **kw)
    dk, dv = flash_attention_dkv_cuda(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of
    ``flash_attention_vjp``: forward and backward run the plain versions
    on CPU tensors and the CUDA kernels on CUDA tensors.  The residuals
    are q, k, v, out and the f32 lse [B,H,Sq].  ``q_offset``: q's rows
    sit at that position of k / v (a sequence-parallel rank's rows): dq
    is [B,Sq,H,hd], dk / dv [B,Sk,KV,hd].  Each pass adds its kernels'
    formulas to a :class:`~repro_torch.kernels.cost.CostCounter` in
    force."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int = 0):
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        fwd = flash_attention_fwd_lse_plain if q.device.type == "cpu" \
            else flash_attention_fwd_lse_cuda
        out, lse = cost.counted(
            lambda: fwd(q, k, v, **kw),
            (FWD, lambda: cost.flash_train_work(FWD, q, k, window,
                                                q_offset)))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd_plain if q.device.type == "cpu"
               else flash_attention_bwd_cuda)
        window, off = ctx.kw["window"], ctx.kw["q_offset"]
        dq, dk, dv = cost.counted(
            lambda: bwd(q, k, v, out, lse, dout.contiguous(), **ctx.kw),
            *((name, lambda name=name: cost.flash_train_work(
                name, q, k, window, off)) for name in (DQ, DKV)))
        return dq, dk, dv, None, None, None
