"""The split-KV plan of the bf16 decode kernels (paged
``decode_attention_paged`` and dense ``decode_attention``,
``csrc/decode_attention_split_sm90.cuh``) and what their two passes
compute, on the CPU.

The CUDA kernels cannot run here, so the test holds the plan the wrappers
hand them (``split_plan``: the splits cover the ring ``[0, L)`` once,
each a whole number of pages and key tiles) and a plain split-and-combine
reference written in this file from the kernels' own formulas: per split
``(m, l, acc)`` over its slots below ``min(len, L)`` under the token-id
ring mask and window, then ``out = sum_i e^(m_i - M) acc_i / sum_i
e^(m_i - M) l_i`` over the splits with ``m_i > -inf``.  That reference
meets the port's one-pass plain versions, ``repro.kernels.ref`` and the
Pallas kernels in interpret mode in float32 at atol = rtol = 3e-5 (the
reference's own kernel tolerance), on a ring split by the plan: a
length of 1, splits lying wholly past the length, a wrapped ring,
windows, head_dim 80, a GQA group of 12 and dense ``n_valid`` of 1, L
and beyond L.  The card holds the kernels to the one-pass plain versions
(``chip_smoke.py``)."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention as pallas_dense
from repro.kernels.decode_attention_paged import \
    decode_attention_paged as pallas_paged
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import decode_attention_paged as dap
from repro_torch.kernels import decode_attention_q8 as dq8

torch.set_num_threads(2)
TOL = dict(atol=3e-5, rtol=3e-5)


def _ranges(splits, split_len, L):
    return [(i * split_len, min((i + 1) * split_len, L))
            for i in range(splits)]


def _check_plan(batch, kv, L, page, sms, per_sm):
    splits, split_len = dap.split_plan(batch, kv, L, page=page, sms=sms,
                                       blocks_per_sm=per_sm)
    assert splits >= 1
    assert split_len % page == 0 and split_len % dap.KEY_TILE == 0
    covered = np.zeros(L, np.int64)
    for lo, hi in _ranges(splits, split_len, L):
        assert lo < hi                      # no split is empty
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # one wave of pass-1 blocks; a second split whenever the pairs leave
    # half the wave idle and the ring holds more than one granule
    pairs, wave = batch * kv, per_sm * sms
    assert splits * pairs <= max(pairs, wave)
    granule = np.lcm(page, dap.KEY_TILE)
    if 2 * pairs <= wave and L > granule:
        assert splits > 1


@pytest.mark.parametrize("batch,kv,L,page,sms", [
    (4, 4, 256, 16, 132),       # the serve shape: Qwen2.5-7B, 16 pages
    (16, 4, 2048, 16, 132),     # the timed B16 x 2048 shape
    (4, 2, 2048, 16, 132),      # group 12 (starcoder2-3b: 2 kv heads)
    (4, 8, 256, 16, 132),       # h2o-danube-1.8b: 8 kv heads
    (1, 1, 16, 16, 132),        # one page: one split
    (64, 8, 2048, 16, 132),     # the pairs fill the card: one split
    (3, 8, 80, 16, 132),        # a ring of 5 pages: a short last split
    (2, 2, 77, 16, 132),        # a dense ring of any length
    (2, 4, 4096, 32, 114),      # 32-slot pages, another SM count
])
def test_split_plan_covers_the_ring(batch, kv, L, page, sms):
    _check_plan(batch, kv, L, page, sms, dap.BLOCKS_PER_SM)


@pytest.mark.parametrize("batch,kv,L,page,sms", [
    (4, 4, 256, 16, 132),       # the serve shape
    (16, 4, 2048, 16, 132),     # B16 x 2048: six splits
    (4, 2, 2048, 16, 132),      # group 12
    (99, 4, 2048, 16, 132),     # the pairs fill the card: one split
    (3, 8, 80, 16, 132),        # a short last split
])
def test_split_plan_covers_the_ring_int8(batch, kv, L, page, sms):
    """The int8 kernels' plan: three blocks an SM (kMinBlocks)."""
    _check_plan(batch, kv, L, page, sms, dap.BLOCKS_PER_SM_Q8)


@pytest.mark.parametrize("fn", [dap.decode_attention_paged_cuda,
                                da.decode_attention_cuda, dap.split_args,
                                dap.split_plan,
                                dap.decode_attention_paged_q8_cuda,
                                dq8.decode_attention_q8_cuda])
def test_cuda_wrappers_read_nothing_to_the_host(fn):
    """The plan comes from static shapes: no wrapper reads lengths (a
    device tensor) back, so a decode round stays free of syncs and can be
    captured in a CUDA graph."""
    src = inspect.getsource(fn)
    for call in (".item(", ".tolist(", ".cpu(", ".numpy(", "synchronize(",
                 "lengths[", "n_valid["):
        assert call not in src, (fn.__name__, call)


def split_combine(q, k, v, lengths, window, splits, split_len):
    """Plain two-pass split-KV decode in float32 over the logical ring
    view k, v [B, L, KV, hd].  -> (out [B, H, hd], m [splits, B, H])."""
    b, h, hd = q.shape
    L, kv = k.shape[1], k.shape[2]
    kq = k.repeat_interleave(h // kv, dim=2).float()
    vq = v.repeat_interleave(h // kv, dim=2).float()
    scores = torch.einsum("bhd,blhd->bhl", q.float(), kq) * hd ** -0.5
    ln = lengths.long()[:, None]
    s_idx = torch.arange(L)[None, :]
    t_s = ln - 1 - torch.remainder(ln - 1 - s_idx, L)
    live = (s_idx < torch.clamp(ln, max=L)) & (t_s >= 0)
    if window > 0:
        live &= t_s > ln - 1 - window
    ms, ls, accs = [], [], []
    for lo, hi in _ranges(splits, split_len, L):          # pass 1
        sc = scores[:, :, lo:hi].masked_fill(~live[:, None, lo:hi],
                                             float("-inf"))
        m = sc.amax(-1)
        p = torch.exp(sc - torch.where(torch.isinf(m), 0., m)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhl,blhd->bhd", p, vq[:, lo:hi]))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    big = m.amax(0)                                        # pass 2
    w = torch.where(torch.isinf(m), 0., torch.exp(m - big))
    out = (w[..., None] * acc).sum(0) / (w * l).sum(0)[..., None]
    return out, m


def _paged_inputs(b, h, kv, hd, P, npg, lengths, seed=5):
    rng = np.random.default_rng(seed)
    nb = 1 + b * npg
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kp = rng.standard_normal((nb, P, kv, hd)).astype(np.float32)
    vp = rng.standard_normal((nb, P, kv, hd)).astype(np.float32)
    # shuffled page ids: page 0 stays the null page
    bt = (rng.permutation(nb - 1)[:b * npg] + 1).reshape(b, npg)
    return q, kp, vp, bt.astype(np.int32), np.asarray(lengths, np.int32)


@pytest.mark.parametrize("b,h,kv,hd,P,npg,window,lengths", [
    # 16-page ring (L 256) in 4 splits of 64: len 1 leaves three splits
    # wholly past it
    (1, 4, 1, 64, 16, 16, 0, [1]),
    (3, 8, 2, 64, 16, 16, 0, [1, 70, 256]),
    # wrapped rings, without and with a window
    (2, 8, 2, 64, 16, 16, 0, [300, 600]),
    (2, 8, 2, 64, 16, 16, 100, [300, 600]),
    (3, 14, 2, 128, 16, 8, 24, [7, 64, 130]),
    # head_dim 80 (h2o-danube-1.8b), group 12 (starcoder2-3b)
    (3, 8, 2, 80, 16, 16, 0, [1, 37, 256]),
    (2, 24, 2, 64, 16, 16, 0, [1, 200]),
    (2, 24, 2, 128, 16, 16, 40, [100, 500]),
])
def test_paged_split_combine_matches_plain_ref_and_pallas(
        b, h, kv, hd, P, npg, window, lengths):
    q, kp, vp, bt, ln = _paged_inputs(b, h, kv, hd, P, npg, lengths)
    L = npg * P
    splits, split_len = dap.split_plan(b, kv, L, page=P)
    assert splits > 1
    t = [torch.from_numpy(a) for a in (q, kp, vp, bt, ln)]
    k = t[1][t[3].long()].reshape(b, L, kv, hd)
    v = t[2][t[3].long()].reshape(b, L, kv, hd)
    got, m = split_combine(t[0], k, v, t[4], window, splits, split_len)
    # a split starting at or past min(len, L) adds nothing: m = -inf
    for i, (lo, _) in enumerate(_ranges(splits, split_len, L)):
        dead = lo >= np.minimum(ln, L)
        assert torch.isinf(m[i][torch.from_numpy(dead)]).all()
    j = [jnp.asarray(a) for a in (q, kp, vp, bt, ln)]
    plain = dap.decode_attention_paged_plain(*t, window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref.decode_attention_paged_ref(
            *j, window=window)), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(pallas_paged(*j, window=window,
                                             interpret=True)), **TOL)


@pytest.mark.parametrize("b,h,kv,hd,L,n_valid", [
    (3, 8, 2, 64, 256, [1, 90, 256]),        # n_valid 1, partial, L
    (2, 8, 2, 64, 256, [1, 300]),            # n_valid > L keeps all L
    (3, 8, 2, 80, 128, [1, 33, 128]),        # head_dim 80
    (2, 24, 2, 128, 256, [1, 256]),          # group 12
    (2, 4, 4, 64, 200, [1, 150]),            # L not a whole key tile
])
def test_dense_split_combine_matches_plain_ref_and_pallas(b, h, kv, hd, L,
                                                          n_valid):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    kc = rng.standard_normal((b, L, kv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, L, kv, hd)).astype(np.float32)
    nv = np.asarray(n_valid, np.int32)
    splits, split_len = dap.split_plan(b, kv, L)
    assert splits > 1
    t = [torch.from_numpy(a) for a in (q, kc, vc, nv)]
    got, _ = split_combine(*t, 0, splits, split_len)
    j = [jnp.asarray(a) for a in (q, kc, vc, nv)]
    np.testing.assert_allclose(got.numpy(),
                               da.decode_attention_plain(*t).numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref.decode_attention_ref(*j)),
                               **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(pallas_dense(*j, block_k=min(L, 256),
                                             interpret=True)), **TOL)
