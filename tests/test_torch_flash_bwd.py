"""The plain PyTorch versions of the flash-attention training kernels
(K5a forward + lse, K5b dq, K5c dk/dv) against the JAX package's Pallas
kernels in interpret mode and against ``jax.grad`` of the oracle
``repro.kernels.ref.flash_attention_ref``, on the same numpy inputs in
float32; and ``FlashAttentionFn`` / ``ops.flash_attention`` on CPU
tensors against autograd of ``flash_attention_plain``.

Bounds are the reference's own (tests/test_kernels.py:190-213): 3e-5 for
the forward's out and lse, 3e-4 for the gradients.  Shapes: the four of
tests/test_kernels.py:184-189 (MHA, GQA, a window, a 3-head group with
rectangular blocks) plus one hd=128 group of 7 and one windowed hd=80
(h2o-danube-1.8b's width)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention_bwd import _fwd as pallas_fwd
from repro.kernels.flash_attention_bwd import flash_attention_vjp
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.flash_attention_bwd import (
    FlashAttentionFn, flash_attention_bwd_cuda, flash_attention_bwd_plain,
    flash_attention_fwd_lse_cuda, flash_attention_fwd_lse_plain)

torch.set_num_threads(2)
TOL_FWD = dict(atol=3e-5, rtol=3e-5)
TOL_GRAD = dict(atol=3e-4, rtol=3e-4)

SHAPES = [  # b, s, h, kv, hd, window, block_q, block_k
    (1, 64, 4, 4, 32, 0, 32, 32),      # MHA
    (2, 64, 4, 2, 32, 0, 32, 32),      # GQA
    (1, 64, 4, 2, 32, 24, 32, 32),     # sliding window
    (1, 128, 6, 3, 64, 0, 64, 32),     # non-pow2 heads, rectangular blocks
    (1, 64, 7, 1, 128, 0, 32, 32),     # hd=128, a group of 7
    (1, 64, 4, 2, 80, 16, 32, 32),     # hd=80 (h2o-danube), windowed
]


def _inputs(b, s, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    ct = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    return q, k, v, ct


@pytest.mark.parametrize("b,s,h,kv,hd,window,bq,bk", SHAPES)
def test_fwd_lse_plain_matches_pallas(b, s, h, kv, hd, window, bq, bk):
    q, k, v, _ = _inputs(b, s, h, kv, hd)
    want_out, want_lse = pallas_fwd(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, window=window,
        block_q=bq, block_k=bk, interpret=True)
    out, lse = flash_attention_fwd_lse_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), window=window)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL_FWD)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL_FWD)


@pytest.mark.parametrize("b,s,h,kv,hd,window,bq,bk", SHAPES)
def test_bwd_plain_matches_pallas_and_oracle_grad(b, s, h, kv, hd, window,
                                                  bq, bk):
    q, k, v, ct = _inputs(b, s, h, kv, hd, seed=1)
    jq, jk, jv, jct = (jnp.asarray(a) for a in (q, k, v, ct))

    def f_pal(q, k, v):
        return jnp.sum(flash_attention_vjp(q, k, v, True, window, bq, bk,
                                           True) * jct)

    def f_ref(q, k, v):
        return jnp.sum(ref.flash_attention_ref(q, k, v, causal=True,
                                               window=window) * jct)

    g_pal = jax.grad(f_pal, argnums=(0, 1, 2))(jq, jk, jv)
    g_ref = jax.grad(f_ref, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv, tct = (torch.from_numpy(a) for a in (q, k, v, ct))
    out, lse = flash_attention_fwd_lse_plain(tq, tk, tv, window=window)
    got = flash_attention_bwd_plain(tq, tk, tv, out, lse, tct, window=window)
    for name, g, p, r in zip("qkv", got, g_pal, g_ref):
        assert g.shape == p.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(p), **TOL_GRAD)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL_GRAD)


@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (2, 32, 4, 2, 16, 0), (1, 48, 6, 3, 8, 10), (1, 16, 7, 1, 64, 0)])
def test_autograd_fn_matches_autograd_of_plain(b, s, h, kv, hd, window):
    """On CPU tensors FlashAttentionFn (and ops.flash_attention, which
    takes it when grad is needed) runs the plain forward and backward;
    out and grads match autograd through flash_attention_plain."""
    q, k, v, ct = (torch.from_numpy(a) for a in
                   _inputs(b, s, h, kv, hd, seed=2))
    want_in = [t.clone().requires_grad_() for t in (q, k, v)]
    want = flash_attention_plain(*want_in, window=window)
    want_g = torch.autograd.grad((want * ct).sum(), want_in)
    for fn in (lambda *a: FlashAttentionFn.apply(*a, True, window),
               lambda *a: ops.flash_attention(*a, window=window)):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        got = fn(*ins)
        assert type(got.grad_fn).__name__ == "FlashAttentionFnBackward"
        got_g = torch.autograd.grad((got * ct).sum(), ins)
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), **TOL_FWD)
        for g, w in zip(got_g, want_g):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL_GRAD)


def test_dispatch_without_grad_and_no_cpu_launch():
    """Without grad, ops.flash_attention stays the forward-only path; on
    CPU tensors no wrapper launches a kernel, and the CUDA wrappers
    refuse CPU tensors instead of falling back."""
    q, k, v, ct = (torch.from_numpy(a) for a in _inputs(1, 32, 4, 2, 64))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is None
    np.testing.assert_array_equal(out.numpy(),
                                  flash_attention_plain(q, k, v).numpy())
    with torch.no_grad():
        assert ops.flash_attention(q.requires_grad_(), k, v).grad_fn is None
    assert not any(ops.launch_counts().values())
    q = q.detach()
    with pytest.raises(ValueError, match="CUDA kernel got a cpu tensor"):
        flash_attention_fwd_lse_cuda(q, k, v)
    out, lse = flash_attention_fwd_lse_plain(q, k, v)
    with pytest.raises(ValueError, match="CUDA kernel got a cpu tensor"):
        flash_attention_bwd_cuda(q, k, v, out, lse, ct)


# The card's bound for the bf16 gradient kernels, as a share of max
# |plain| over each tensor (chip_smoke.py GRAD_TOL["bfloat16"])
GRAD_TOL_BF16 = 1e-2


def _bwd_tensor_core_roundings(q, k, v, out, lse, dout, *, window=0):
    """The plain backward with the roundings the bf16 tensor-core
    kernels make (csrc/flash_attention_bwd_sm90.cuh): the scale applied
    to the f32 scores; P and dS rounded to bf16 before the three
    products dq = dS·K, dk = dSᵀ·Q and dv = Pᵀ·dO; f32 accumulation;
    one rounding of each gradient to bf16."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    scale = hd ** -0.5
    qf, dof = q.float(), dout.float()
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    pos = torch.arange(s)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    p = torch.where(mask, torch.exp(scores - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (out.float() * dof).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None]) * scale
    p16, ds16 = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds16, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds16, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p16, dof)
    dk = dk.reshape(b, s, kv, rep, hd).sum(3)
    dv = dv.reshape(b, s, kv, rep, hd).sum(3)
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (1, 64, 2, 2, 64, 0),        # group 1
    (2, 100, 4, 2, 80, 24),      # group 2, hd 80, windowed, ragged S
    (1, 256, 7, 1, 128, 0),      # group 7, hd 128
    (1, 128, 14, 2, 128, 32),    # group 7, windowed
    (1, 200, 4, 4, 64, 48),      # group 1, windowed, ragged S
])
def test_bf16_tensor_core_roundings_stay_within_card_bound(b, s, h, kv, hd,
                                                           window):
    """Before any chip run: rounding P and dS to bf16 ahead of the
    tensor-core products (the TPU kernels' default-precision dots round
    them too) keeps dq, dk and dv within GRAD_TOL_BF16 of max |plain|,
    the bound chip_smoke.py holds the bf16 kernels to."""
    q, k, v, ct = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(b, s, h, kv, hd, seed=3))
    out, lse = flash_attention_fwd_lse_plain(q, k, v, window=window)
    want = flash_attention_bwd_plain(q, k, v, out, lse, ct, window=window)
    got = _bwd_tensor_core_roundings(q, k, v, out, lse, ct, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype == torch.bfloat16, name
        err = float((g.float() - w.float()).abs().max())
        assert 0 < err <= GRAD_TOL_BF16 * float(w.float().abs().max()), name
