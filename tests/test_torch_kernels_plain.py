"""The plain PyTorch versions of the port's two kernels against the
reference oracles (``repro.kernels.ref``) and against the Pallas kernels
in interpret mode, on the same numpy inputs, in float32
(atol = rtol = 3e-5, the reference's own kernel tolerance).

Shapes: those of tests/test_paged.py and tests/test_kernels.py, plus a
non-power-of-two GQA group (14 q heads over 2 kv heads), a wrapped ring,
lengths shorter than one page, and sliding windows.  On CPU tensors the
call-site wrappers take the plain version and launch nothing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention_paged import \
    decode_attention_paged as pallas_paged
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention_paged import \
    decode_attention_paged_plain
from repro_torch.kernels.flash_attention import flash_attention_plain

torch.set_num_threads(2)
TOL = dict(atol=3e-5, rtol=3e-5)


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


def test_cpu_wrappers_run_plain_and_launch_nothing():
    ops.reset_launch_counts()
    q, kp, vp, bt, ln = (torch.from_numpy(a) for a in _paged_inputs(
        2, 14, 2, 64, 16, 4, [9, 70]))
    got = ops.decode_attention_paged(q, kp, vp, bt, ln, window=0)
    assert torch.equal(got, decode_attention_paged_plain(q, kp, vp, bt, ln))
    x = torch.randn(1, 32, 14, 64, generator=torch.Generator().manual_seed(0))
    kv = x[:, :, :2].contiguous()
    got = ops.flash_attention(x, kv, kv, causal=True, window=8)
    assert torch.equal(got, flash_attention_plain(x, kv, kv, causal=True,
                                                  window=8))
    assert ops.launch_counts() == {"decode_attention_paged": 0,
                                   "flash_attention": 0}
