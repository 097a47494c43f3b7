"""The plain PyTorch versions of the port's kernels against the
reference oracles (``repro.kernels.ref``) and against the Pallas kernels
in interpret mode, on the same numpy inputs, in float32
(atol = rtol = 3e-5, the reference's own kernel tolerance).

int8 kernels (paged ``_q8``, dense ``decode_attention_q8``): the plain
version dequantizes in float32, as the Pallas kernels (and the CUDA
kernels) do, and as XLA does for the JAX package's jitted CPU route
(``dequantize_kv`` feeding a float32 consumer keeps its product in
float32: excess precision).  So it meets the Pallas kernels, and the
oracle on float32-dequantized caches, at 3e-5.  Against the oracle on
eagerly dequantized caches (``dequantize_kv`` rounds to bf16 outside
``jit``) it is held to the reference's own 5e-3 for that comparison
(tests/test_paged.py, tests/test_kernels.py).

Shapes: those of tests/test_paged.py and tests/test_kernels.py, plus a
non-power-of-two GQA group (14 q heads over 2 kv heads), a wrapped ring,
lengths shorter than one page, sliding windows, and dense lengths 1,
partial and L.  On CPU tensors the call-site wrappers take the plain
version and launch nothing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention as pallas_dense
from repro.kernels.decode_attention_paged import \
    decode_attention_paged as pallas_paged
from repro.kernels.decode_attention_paged import \
    decode_attention_paged_q8 as pallas_paged_q8
from repro.kernels.decode_attention_q8 import \
    decode_attention_q8 as pallas_dense_q8
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models.cache import dequantize_kv as jax_dequantize
from repro.models.cache import quantize_kv as jax_quantize
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.decode_attention_paged import (
    decode_attention_paged_plain, decode_attention_paged_q8_plain)
from repro_torch.kernels.decode_attention_q8 import \
    decode_attention_q8_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models.cache import quantize_kv

torch.set_num_threads(2)
TOL = dict(atol=3e-5, rtol=3e-5)
TOL_Q8_EAGER = dict(atol=5e-3, rtol=5e-3)


def _paged_inputs(b, h, kv, hd, P, npg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    nb = 1 + b * npg
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kp = rng.standard_normal((nb, P, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, P, kv, hd)).astype(np.float32)
    # shuffled page ids: page 0 stays the null page
    bt = (rng.permutation(nb - 1)[:b * npg] + 1).reshape(b, npg)
    return q, kp, vp, bt.astype(np.int32), np.asarray(lengths, np.int32)


@pytest.mark.parametrize("b,h,kv,hd,P,npg,window,lengths", [
    # tests/test_paged.py shapes, mixed lengths incl. a wrapped ring
    (1, 4, 4, 32, 16, 4, 0, [3]),
    (3, 8, 2, 64, 16, 8, 0, [3, 70, 144]),
    (2, 4, 1, 64, 32, 4, 0, [3, 160]),
    (2, 8, 2, 64, 16, 4, 24, [3, 80]),
    # non-power-of-two group, len < P, len == 1, ring wrap, window
    (4, 14, 2, 64, 16, 4, 0, [1, 5, 64, 100]),
    (3, 14, 2, 128, 16, 4, 40, [7, 64, 130]),
])
def test_paged_plain_matches_ref_and_pallas(b, h, kv, hd, P, npg, window,
                                            lengths):
    q, kp, vp, bt, ln = _paged_inputs(b, h, kv, hd, P, npg, lengths)
    j = [jnp.asarray(a) for a in (q, kp, vp, bt, ln)]
    want_ref = ref.decode_attention_paged_ref(*j, window=window)
    want_pallas = pallas_paged(*j, window=window, interpret=True)
    got = decode_attention_paged_plain(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt, ln)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **TOL)


@pytest.mark.parametrize("b,s,h,kv,hd,bq,bk,window", [
    # tests/test_kernels.py shapes
    (1, 64, 4, 4, 32, 32, 32, 0),
    (2, 128, 8, 2, 64, 64, 32, 0),
    (1, 256, 4, 1, 64, 64, 64, 0),
    (2, 128, 6, 3, 128, 128, 64, 0),
    (1, 128, 4, 2, 32, 32, 32, 16),
    (1, 128, 4, 2, 32, 32, 32, 64),
    # non-power-of-two group; the prefill bucket floor S = 16
    (1, 16, 14, 2, 64, 16, 16, 0),
    (1, 64, 14, 2, 128, 32, 32, 24),
])
def test_flash_plain_matches_ref_and_pallas(b, s, h, kv, hd, bq, bk,
                                            window):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, hd)).astype(np.float32)
    j = [jnp.asarray(a) for a in (q, k, v)]
    want_ref = ref.flash_attention_ref(*j, window=window)
    want_pallas = pallas_flash(*j, window=window, block_q=bq, block_k=bk,
                               interpret=True)
    got = flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pallas), **TOL)


def _q8(a):
    """float32 numpy -> (int8, bf16 scale) as torch and as jax arrays."""
    tq, ts = quantize_kv(torch.from_numpy(a))
    jq, js = jax_quantize(jnp.asarray(a))
    return (tq, ts), (jq, js)


def _f32(q, s):
    """int8 x scale multiplied in float32 (exact), as jax arrays."""
    return q.astype(jnp.float32) * s.astype(jnp.float32)


def _bf16(q, s):
    """Eager ``dequantize_kv``: the product rounded to bf16."""
    return jax_dequantize(q, s).astype(jnp.float32)


@pytest.mark.parametrize("b,h,kv,hd,P,npg,window,lengths", [
    (2, 8, 2, 64, 16, 4, 0, [17, 64]),          # tests/test_paged.py
    (4, 14, 2, 64, 16, 4, 0, [1, 5, 64, 100]),  # len 1, partial, wrap
    (3, 14, 2, 128, 16, 4, 40, [7, 64, 130]),   # window, wrap
])
def test_paged_q8_plain_matches_ref_and_pallas(b, h, kv, hd, P, npg, window,
                                               lengths):
    q, kp, vp, bt, ln = _paged_inputs(b, h, kv, hd, P, npg, lengths, seed=2)
    (tk, tks), (jk, jks) = _q8(kp)
    (tv, tvs), (jv, jvs) = _q8(vp)
    tq, tbt, tln = (torch.from_numpy(a) for a in (q, bt, ln))
    jq, jbt, jln = (jnp.asarray(a) for a in (q, bt, ln))
    got = decode_attention_paged_q8_plain(tq, tk, tks, tv, tvs, tbt, tln,
                                          window=window).numpy()
    np.testing.assert_allclose(
        got, np.asarray(pallas_paged_q8(jq, jk, jks, jv, jvs, jbt, jln,
                                        window=window, interpret=True)),
        **TOL)
    for deq, tol in ((_f32, TOL), (_bf16, TOL_Q8_EAGER)):
        want = ref.decode_attention_paged_ref(jq, deq(jk, jks), deq(jv, jvs),
                                              jbt, jln, window=window)
        np.testing.assert_allclose(got, np.asarray(want), **tol)


def _dense_inputs(b, h, kv, hd, L, n_valid, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kc = rng.standard_normal((b, L, kv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, L, kv, hd)).astype(np.float32)
    return q, kc, vc, np.asarray(n_valid, np.int32)


@pytest.mark.parametrize("b,h,kv,hd,L,bk,n_valid", [
    # tests/test_kernels.py shapes
    (2, 8, 2, 64, 256, 64, [128, 256]),
    (1, 4, 4, 32, 128, 128, [77]),
    # non-power-of-two group: n_valid 1 / partial / L at L = 256 and 64
    (3, 14, 2, 128, 256, 256, [1, 90, 256]),
    (3, 14, 2, 64, 64, 64, [1, 33, 64]),
])
def test_dense_decode_plain_matches_ref_and_pallas(b, h, kv, hd, L, bk,
                                                   n_valid):
    args = _dense_inputs(b, h, kv, hd, L, n_valid)
    j = [jnp.asarray(a) for a in args]
    got = decode_attention_plain(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref.decode_attention_ref(*j)),
                               **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(pallas_dense(*j, block_k=bk,
                                             interpret=True)), **TOL)


@pytest.mark.parametrize("b,h,kv,hd,L,bk,n_valid", [
    (2, 8, 2, 64, 256, 64, [128, 256]),          # tests/test_kernels.py
    (1, 4, 4, 32, 128, 128, [64]),
    (3, 14, 2, 128, 256, 256, [1, 90, 256]),
    (3, 14, 2, 64, 64, 64, [1, 33, 64]),
])
def test_dense_q8_plain_matches_ref_and_pallas(b, h, kv, hd, L, bk,
                                               n_valid):
    q, kc, vc, nv = _dense_inputs(b, h, kv, hd, L, n_valid, seed=5)
    (tk, tks), (jk, jks) = _q8(kc)
    (tv, tvs), (jv, jvs) = _q8(vc)
    tq, tnv = torch.from_numpy(q), torch.from_numpy(nv)
    jq, jnv = jnp.asarray(q), jnp.asarray(nv)
    got = decode_attention_q8_plain(tq, tk, tks, tv, tvs, tnv).numpy()
    np.testing.assert_allclose(
        got, np.asarray(pallas_dense_q8(jq, jk, jks, jv, jvs, jnv,
                                        block_k=bk, interpret=True)), **TOL)
    for deq, tol in ((_f32, TOL), (_bf16, TOL_Q8_EAGER)):
        want = ref.decode_attention_ref(jq, deq(jk, jks), deq(jv, jvs), jnv)
        np.testing.assert_allclose(got, np.asarray(want), **tol)


def test_cpu_wrappers_run_plain_and_launch_nothing():
    ops.reset_launch_counts()
    q, kp, vp, bt, ln = (torch.from_numpy(a) for a in _paged_inputs(
        2, 14, 2, 64, 16, 4, [9, 70]))
    got = ops.decode_attention_paged(q, kp, vp, bt, ln, window=0)
    assert torch.equal(got, decode_attention_paged_plain(q, kp, vp, bt, ln))
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    got = ops.decode_attention_paged_q8(q, kq, ks, vq, vs, bt, ln, window=8)
    assert torch.equal(got, decode_attention_paged_q8_plain(
        q, kq, ks, vq, vs, bt, ln, window=8))
    kc, vc = kp[1:].reshape(2, 64, 2, 64), vp[1:].reshape(2, 64, 2, 64)
    assert torch.equal(ops.decode_attention(q, kc, vc, ln),
                       decode_attention_plain(q, kc, vc, ln))
    kq, ks = quantize_kv(kc)
    vq, vs = quantize_kv(vc)
    assert torch.equal(ops.decode_attention_q8(q, kq, ks, vq, vs, ln),
                       decode_attention_q8_plain(q, kq, ks, vq, vs, ln))
    x = torch.randn(1, 32, 14, 64, generator=torch.Generator().manual_seed(0))
    kv = x[:, :, :2].contiguous()
    got = ops.flash_attention(x, kv, kv, causal=True, window=8)
    assert torch.equal(got, flash_attention_plain(x, kv, kv, causal=True,
                                                  window=8))
    g = torch.Generator().manual_seed(1)
    sx, sb, sc = (torch.randn(1, 20, n, generator=g) for n in (64, 8, 8))
    sx = sx.reshape(1, 20, 2, 32)
    sdt = torch.rand(1, 20, 2, generator=g)
    sa = -torch.rand(2, generator=g) - 0.5
    got = ops.ssd_scan(sx, sdt, sa, sb, sc, chunk=8)
    want = ssd_scan_plain(sx, sdt, sa, sb, sc, chunk=8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.launch_counts() == dict.fromkeys(
        ("decode_attention_paged", "decode_attention_paged_q8",
         "decode_attention", "decode_attention_q8", "flash_attention",
         "flash_attention_fwd_lse", "flash_attention_dq",
         "flash_attention_dkv", "ssd_scan"), 0)
