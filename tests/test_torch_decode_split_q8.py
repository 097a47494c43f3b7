"""What the int8 instances of the split-KV decode kernels compute, on the
CPU: the paged ``decode_attention_paged_q8`` (K3) and the dense
``decode_attention_q8`` (K7) with bf16 q run the split-KV tensor-core
block of ``csrc/decode_attention_split_sm90.cuh`` over int8 K/V.

The CUDA kernels cannot run here, so the test holds a plain two-pass
split-and-combine written in this file from the kernel's own formulas,
on a ring split by ``split_plan``: per split, scores ``(q·k_int_j) ·
s_k[j] · hd^-0.5`` (the K scale on the scores, a masked score -inf),
``m`` their max, ``l = sum_j p_j`` over the unscaled ``p_j = e^(S_j -
m)``, ``acc = sum_j (p_j s_v[j]) v_int_j`` (the V scale folded into P);
then the splits merged as ``sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M)
l_i``.  In float32 it meets the port's one-pass plain versions,
``repro.kernels.ref`` (over K/V dequantized in float32) and the Pallas
q8 kernels in interpret mode at atol = rtol = 3e-5 (the reference's own
kernel tolerance).  With ``P' = p_j s_v[j]`` rounded to bf16, as the
kernel rounds the A operand of P·V, and q rounded to bf16, it stays
within 1e-2 of max |plain| of the plain version on the same bf16 q (the
card's bound for a bf16 rounding of P, as ``test_torch_flash_bwd.py``
states it).  The kernel's int8 -> bf16 conversion (a byte placed in the
mantissa of 2^23 by a byte permute, 2^23 + 128 subtracted in f32, the
upper half of the float taken as bf16) is emulated bit by bit and held
exact for every int8 value, and the build variants that
``tools/decode_variants.py`` times are held to apply to the header.  The
card holds the kernels to the plain versions (``chip_smoke.py``)."""
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention_paged import \
    decode_attention_paged_q8 as pallas_paged_q8
from repro.kernels.decode_attention_q8 import \
    decode_attention_q8 as pallas_dense_q8
from repro_torch.kernels import decode_attention_paged as dap
from repro_torch.kernels import decode_attention_q8 as dq8
from repro_torch.models.cache import quantize_kv

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
sys.path.insert(0, str(ROOT / "tools"))
import decode_variants  # noqa: E402  (imports no JAX)

torch.set_num_threads(2)
TOL = dict(atol=3e-5, rtol=3e-5)
# bf16 rounding of P' (and of q, on both sides), as a share of max |plain|
BF16_BOUND = 1e-2


def _ranges(splits, split_len, L):
    return [(i * split_len, min((i + 1) * split_len, L))
            for i in range(splits)]


def split_combine_q8(q, k8, ks, v8, vs, lengths, window, splits, split_len,
                     round_p=False):
    """Plain two-pass split-KV decode of the int8 kernel over the logical
    ring view: k8, v8 [B, L, KV, hd] int8, ks, vs [B, L, KV, 1] bf16.
    ``round_p`` rounds P' = p · s_v to bf16.  -> (out [B, H, hd] f32,
    m [splits, B, H])."""
    b, h, hd = q.shape
    L, kv = k8.shape[1], k8.shape[2]
    rep = h // kv
    ki = k8.float().repeat_interleave(rep, dim=2)
    vi = v8.float().repeat_interleave(rep, dim=2)
    sk = ks.float()[..., 0].repeat_interleave(rep, dim=2).transpose(1, 2)
    sv = vs.float()[..., 0].repeat_interleave(rep, dim=2).transpose(1, 2)
    # the tensor cores' exact q·k_int, then the K scale and hd^-0.5
    scores = torch.einsum("bhd,blhd->bhl", q.float(), ki) * sk * hd ** -0.5
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
        ls.append(p.sum(-1))                               # l: unscaled p
        pv = p * sv[:, :, lo:hi]                           # P' = p · s_v
        if round_p:
            pv = pv.to(torch.bfloat16).float()
        ms.append(m)
        accs.append(torch.einsum("bhl,blhd->bhd", pv, vi[:, lo:hi]))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    big = m.amax(0)                                        # pass 2
    w = torch.where(torch.isinf(m), 0., torch.exp(m - big))
    out = (w[..., None] * acc).sum(0) / (w * l).sum(0)[..., None]
    return out, m


def _f32(q8, s):
    """int8 x scale in float32 (exact), as a jax array."""
    return jnp.asarray(q8.numpy()).astype(jnp.float32) * jnp.asarray(
        s.float().numpy())


def _q8(a):
    return quantize_kv(torch.from_numpy(a))


PAGED = pytest.mark.parametrize("b,h,kv,hd,P,npg,window,lengths", [
    # 16-page ring (L 256) in 4 splits of 64: len 1 leaves three splits
    # wholly past it
    (1, 4, 1, 64, 16, 16, 0, [1]),
    (3, 8, 2, 64, 16, 16, 0, [1, 70, 256]),
    # a wrapped ring under a window
    (2, 8, 2, 64, 16, 16, 100, [300, 600]),
    # head_dim 80 (h2o-danube-1.8b), group 12 (starcoder2-3b), wrapped
    (3, 8, 2, 80, 16, 16, 0, [1, 37, 256]),
    (2, 24, 2, 128, 16, 16, 40, [100, 500]),
])


def _paged(b, h, kv, hd, P, npg, lengths, seed=9):
    rng = np.random.default_rng(seed)
    nb = 1 + b * npg
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    kq, ks = _q8(rng.standard_normal((nb, P, kv, hd)).astype(np.float32))
    vq, vs = _q8(rng.standard_normal((nb, P, kv, hd)).astype(np.float32))
    # shuffled page ids: page 0 stays the null page
    bt = torch.from_numpy((rng.permutation(nb - 1)[:b * npg] + 1).reshape(
        b, npg).astype(np.int32))
    ln = torch.tensor(lengths, dtype=torch.int32)
    L = npg * P
    ring = [t[bt.long()].reshape((b, L) + t.shape[2:])
            for t in (kq, ks, vq, vs)]
    splits, split_len = dap.split_plan(b, kv, L, page=P,
                                       blocks_per_sm=dap.BLOCKS_PER_SM_Q8)
    assert splits > 1
    return (q, kq, ks, vq, vs, bt, ln), ring, (splits, split_len)


@PAGED
def test_paged_q8_split_combine_f32_matches_plain_ref_and_pallas(
        b, h, kv, hd, P, npg, window, lengths):
    args, ring, plan = _paged(b, h, kv, hd, P, npg, lengths)
    q, kq, ks, vq, vs, bt, ln = args
    got, m = split_combine_q8(q, *ring, ln, window, *plan)
    # a split starting at or past min(len, L) adds nothing: m = -inf
    for i, (lo, _) in enumerate(_ranges(*plan, npg * P)):
        dead = lo >= torch.clamp(ln, max=npg * P)
        assert torch.isinf(m[i][dead]).all()
    plain = dap.decode_attention_paged_q8_plain(*args, window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    jq, jbt, jln = (jnp.asarray(t.numpy()) for t in (q, bt, ln))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref.decode_attention_paged_ref(
            jq, _f32(kq, ks), _f32(vq, vs), jbt, jln, window=window)),
        **TOL)
    j8 = [jnp.asarray(kq.numpy()), jnp.asarray(ks.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(vq.numpy()),
        jnp.asarray(vs.float().numpy()).astype(jnp.bfloat16)]
    np.testing.assert_allclose(
        got.numpy(), np.asarray(pallas_paged_q8(
            jq, *j8, jbt, jln, window=window, interpret=True)), **TOL)


@PAGED
def test_paged_q8_split_combine_bf16_p_within_card_bound(
        b, h, kv, hd, P, npg, window, lengths):
    args, ring, plan = _paged(b, h, kv, hd, P, npg, lengths)
    qb = args[0].to(torch.bfloat16)
    got, _ = split_combine_q8(qb, *ring, args[-1], window, *plan,
                              round_p=True)
    plain = dap.decode_attention_paged_q8_plain(qb, *args[1:],
                                                window=window).float()
    err = (got - plain).abs().max()
    assert err <= BF16_BOUND * plain.abs().max(), err


DENSE = pytest.mark.parametrize("b,h,kv,hd,L,n_valid", [
    (3, 8, 2, 64, 256, [1, 90, 256]),        # n_valid 1, partial, L
    (2, 8, 2, 64, 256, [1, 300]),            # n_valid > L keeps all L
    (3, 8, 2, 80, 128, [1, 33, 128]),        # head_dim 80
    (2, 24, 2, 128, 256, [1, 256]),          # group 12
])


def _dense(b, h, kv, hd, L, n_valid, seed=11):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, h, hd)).astype(np.float32))
    kq, ks = _q8(rng.standard_normal((b, L, kv, hd)).astype(np.float32))
    vq, vs = _q8(rng.standard_normal((b, L, kv, hd)).astype(np.float32))
    nv = torch.tensor(n_valid, dtype=torch.int32)
    splits, split_len = dap.split_plan(b, kv, L,
                                       blocks_per_sm=dap.BLOCKS_PER_SM_Q8)
    assert splits > 1
    return (q, kq, ks, vq, vs, nv), (splits, split_len)


@DENSE
def test_dense_q8_split_combine_f32_matches_plain_ref_and_pallas(
        b, h, kv, hd, L, n_valid):
    args, plan = _dense(b, h, kv, hd, L, n_valid)
    q, kq, ks, vq, vs, nv = args
    got, _ = split_combine_q8(*args, 0, *plan)
    np.testing.assert_allclose(got.numpy(),
                               dq8.decode_attention_q8_plain(*args).numpy(),
                               **TOL)
    jq, jnv = jnp.asarray(q.numpy()), jnp.asarray(nv.numpy())
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref.decode_attention_ref(
            jq, _f32(kq, ks), _f32(vq, vs), jnv)), **TOL)
    j8 = [jnp.asarray(kq.numpy()), jnp.asarray(ks.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(vq.numpy()),
        jnp.asarray(vs.float().numpy()).astype(jnp.bfloat16)]
    np.testing.assert_allclose(
        got.numpy(), np.asarray(pallas_dense_q8(
            jq, *j8, jnv, block_k=min(L, 256), interpret=True)), **TOL)


@DENSE
def test_dense_q8_split_combine_bf16_p_within_card_bound(b, h, kv, hd, L,
                                                         n_valid):
    args, plan = _dense(b, h, kv, hd, L, n_valid)
    qb = args[0].to(torch.bfloat16)
    got, _ = split_combine_q8(qb, *args[1:], 0, *plan, round_p=True)
    plain = dq8.decode_attention_q8_plain(qb, *args[1:]).float()
    err = (got - plain).abs().max()
    assert err <= BF16_BOUND * plain.abs().max(), err


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 numpy arrays: result byte n is byte
    (sel >> 4n) & 7 of the 8 bytes y:x."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint64)
    for n in range(4):
        src = (sel >> (4 * n)) & 7
        byte = (both >> np.uint64(8 * src)) & np.uint64(0xFF)
        out |= byte << np.uint64(8 * n)
    return out.astype(np.uint32)


def test_int8_to_bf16_conversion_is_exact():
    """The kernel's i8x4_to_bf16x4 on every int8 value, in each byte
    position of the word: the bf16 bits equal torch's int8 -> bf16."""
    vals = np.arange(-128, 128, dtype=np.int32)
    for pos in range(4):
        words = ((vals & 0xFF) << (8 * pos)).astype(np.uint32)
        u = words ^ np.uint32(0x80808080)
        magic = np.full_like(u, 0x4B000000)
        f = _byte_perm(u, magic, 0x7540 | pos).view(np.float32) \
            - np.float32(8388736.0)
        assert f.dtype == np.float32
        np.testing.assert_array_equal(f, vals.astype(np.float32))
        # two floats packed by their upper halves (byte_perm 0x7632)
        packed = _byte_perm(f.view(np.uint32), f.view(np.uint32), 0x7632)
        want = torch.from_numpy(vals.astype(np.int8)).to(torch.bfloat16) \
            .view(torch.int16).numpy().astype(np.uint16)
        np.testing.assert_array_equal((packed & 0xFFFF).astype(np.uint16),
                                      want)
        np.testing.assert_array_equal((packed >> 16).astype(np.uint16), want)


@pytest.mark.parametrize("name", sorted(decode_variants.VARIANTS))
def test_decode_variant_patches_apply(name):
    """``tools/decode_variants.py`` builds its variants by exact patches of
    the split block's header (the fragments route as the hunks of a
    diff): each applies once, so the variants the tool times are the
    ones it names."""
    header = (CSRC / decode_variants.HEADER).read_text()
    for old, new in decode_variants.VARIANTS[name]:
        assert header.count(old) == 1, (name, old[:80])
        header = header.replace(old, new)
