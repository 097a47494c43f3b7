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
