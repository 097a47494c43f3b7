"""The plain flash-attention kernels with a query offset (K2 / K5a
forward + lse, K5b dq, K5c dk / dv): a sequence-parallel rank's s/tp
query rows at key positions ``rank * s/tp`` onwards against all s keys,
as ``attn_sharding="auto"`` runs them.

Each rank's output and lse equal rows ``[q_offset, q_offset + Sq)`` of
the whole-sequence plain call, of the JAX oracle
``repro.kernels.ref.flash_attention_ref`` and of the Pallas forward in
interpret mode, at the forward bound of ``tests/test_kernels.py`` (3e-5);
its dq equals those rows of the whole dq, and the ranks' dk / dv summed
equal the whole dk / dv (and ``jax.grad`` of the oracle) at the gradient
bound (3e-4, ``tests/test_kernels.py:213``); every dk / dv row of a key
no row of the rank sees is exactly 0.  Causal and a window of 64 that
crosses the rank boundary, hd 64 and 80, tp 2 and 4.  At offset 0 over
the whole sequence the plain versions are bit for bit what they were
before the offset existed."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention_bwd import _fwd as pallas_fwd
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (NEG_INF, check_offset,
                                                 flash_attention_plain,
                                                 masked_scores)
from repro_torch.kernels.flash_attention_bwd import (
    FlashAttentionFn, flash_attention_bwd_plain, flash_attention_fwd_lse_plain)

torch.set_num_threads(2)
TOL_FWD = dict(atol=3e-5, rtol=3e-5)
TOL_GRAD = dict(atol=3e-4, rtol=3e-4)
B, S, H, KV = 1, 256, 4, 2
CASES = [(hd, window, tp) for hd in (64, 80) for window in (0, 64)
         for tp in (2, 4)]


@functools.lru_cache(maxsize=None)
def whole(hd, window):
    """Numpy inputs and the whole-sequence results: the plain forward,
    lse and gradients, the oracle's output and gradients, the Pallas
    forward (interpret mode) and its lse."""
    rng = np.random.default_rng(hd + window)
    q, ct = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, S, KV, hd)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv, tct = map(torch.from_numpy, (q, k, v, ct))
    out, lse = flash_attention_fwd_lse_plain(tq, tk, tv, window=window)
    grads = flash_attention_bwd_plain(tq, tk, tv, out, lse, tct,
                                      window=window)
    jq, jk, jv, jct = map(jnp.asarray, (q, k, v, ct))
    oracle = ref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    g_oracle = jax.grad(lambda a, b, c: jnp.sum(ref.flash_attention_ref(
        a, b, c, causal=True, window=window) * jct), argnums=(0, 1, 2))(
        jq, jk, jv)
    p_out, p_lse = pallas_fwd(jq, jk, jv, causal=True, window=window,
                              block_q=32, block_k=32, interpret=True)
    return {"in": (tq, tk, tv, tct), "out": out, "lse": lse,
            "grads": grads, "oracle": np.asarray(oracle),
            "g_oracle": [np.asarray(g) for g in g_oracle],
            "pallas": (np.asarray(p_out), np.asarray(p_lse))}


def ranks(hd, window, tp):
    """Each rank's (offset, q rows, cotangent rows, out, lse, dq, dk,
    dv) from the plain versions at its offset."""
    w = whole(hd, window)
    tq, tk, tv, tct = w["in"]
    n = S // tp
    out = []
    for r in range(tp):
        off = r * n
        q, ct = tq[:, off:off + n], tct[:, off:off + n]
        o, lse = flash_attention_fwd_lse_plain(q, tk, tv, window=window,
                                               q_offset=off)
        g = flash_attention_bwd_plain(q, tk, tv, o, lse, ct, window=window,
                                      q_offset=off)
        out.append((off, q, ct, o, lse) + g)
    return out


def seen(off, n, window):
    kp = torch.arange(S)
    m = kp <= off + n - 1
    if window:
        m &= kp > off - window
    return m


@pytest.mark.parametrize("hd,window,tp", CASES)
def test_offset_forward_is_the_whole_rows(hd, window, tp):
    w = whole(hd, window)
    n = S // tp
    for off, q, _, o, lse, *_ in ranks(hd, window, tp):
        rows = slice(off, off + n)
        assert o.shape == (B, n, H, hd) and lse.shape == (B, H, n)
        for want in (w["out"][:, rows].numpy(), w["oracle"][:, rows],
                     w["pallas"][0][:, rows]):
            np.testing.assert_allclose(o.numpy(), want, **TOL_FWD)
        for want in (w["lse"][..., rows].numpy(), w["pallas"][1][..., rows]):
            np.testing.assert_allclose(lse.numpy(), want, **TOL_FWD)
        np.testing.assert_array_equal(
            flash_attention_plain(q, w["in"][1], w["in"][2], window=window,
                                  q_offset=off).numpy(), o.numpy())


@pytest.mark.parametrize("hd,window,tp", CASES)
def test_offset_grads_are_rows_and_sum_to_the_whole(hd, window, tp):
    w = whole(hd, window)
    n = S // tp
    res = ranks(hd, window, tp)
    dk_sum = sum(r[6] for r in res)
    dv_sum = sum(r[7] for r in res)
    for off, _, _, _, _, dq, dk, dv in res:
        rows = slice(off, off + n)
        assert dq.shape == (B, n, H, hd) and dk.shape == (B, S, KV, hd)
        np.testing.assert_allclose(dq.numpy(), w["grads"][0][:, rows]
                                   .numpy(), **TOL_GRAD)
        np.testing.assert_allclose(dq.numpy(), w["g_oracle"][0][:, rows],
                                   **TOL_GRAD)
        # keys no row of this rank sees: exactly zero rows
        unseen = ~seen(off, n, window)
        assert int(unseen.sum()) == S - (off + n) + (
            max(0, off - window + 1) if window else 0)
        assert int(torch.count_nonzero(dk[:, unseen])) == 0
        assert int(torch.count_nonzero(dv[:, unseen])) == 0
    for got, plain, oracle in ((dk_sum, w["grads"][1], w["g_oracle"][1]),
                               (dv_sum, w["grads"][2], w["g_oracle"][2])):
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL_GRAD)
        np.testing.assert_allclose(got.numpy(), oracle, **TOL_GRAD)


@pytest.mark.parametrize("window", [0, 64])
def test_autograd_fn_with_offset_matches_autograd_of_plain(window):
    """FlashAttentionFn (and ops.flash_attention under grad) at an
    offset: out and grads equal autograd through the plain forward at
    the same offset; dk / dv span all the keys."""
    tq, tk, tv, tct = whole(64, window)["in"]
    off, n = 96, 64
    q, ct = tq[:, off:off + n], tct[:, off:off + n]
    want_in = [t.clone().requires_grad_() for t in (q, tk, tv)]
    want = flash_attention_plain(*want_in, window=window, q_offset=off)
    want_g = torch.autograd.grad((want * ct).sum(), want_in)
    for fn in (lambda *a: FlashAttentionFn.apply(*a, True, window, off),
               lambda *a: ops.flash_attention(*a, window=window,
                                              q_offset=off)):
        ins = [t.clone().requires_grad_() for t in (q, tk, tv)]
        got = fn(*ins)
        assert type(got.grad_fn).__name__ == "FlashAttentionFnBackward"
        got_g = torch.autograd.grad((got * ct).sum(), ins)
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), **TOL_FWD)
        assert [g.shape for g in got_g] == [q.shape, tk.shape, tv.shape]
        for g, w in zip(got_g, want_g):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL_GRAD)


def _old_masked_scores(q, k, causal, window):
    """masked_scores as it was before the offset (one length S)."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * hd ** -0.5
    qpos = torch.arange(s)[:, None]
    kpos = torch.arange(s)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return scores.masked_fill(~mask[None, None], NEG_INF), mask


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_offset_zero_is_bit_for_bit_the_whole_sequence(causal, window):
    tq, tk, tv, _ = whole(64, 0)["in"]
    q, k = tq[:, :48], tk[:, :48]
    got, got_m = masked_scores(q, k, causal, window)
    want, want_m = _old_masked_scores(q, k, causal, window)
    assert torch.equal(got, want) and torch.equal(got_m, want_m)
    got, got_m = masked_scores(q, k, causal, window, 0)
    assert torch.equal(got, want) and torch.equal(got_m, want_m)


def test_offset_must_keep_queries_inside_the_keys():
    tq, tk, tv, _ = whole(64, 0)["in"]
    check_offset("t", 64, 256, 192)
    check_offset("t", 256, 256, 0)
    for sq, off in ((64, 193), (64, -1), (257, 0), (64, 2.5)):
        with pytest.raises(ValueError, match="do not lie inside"):
            check_offset("t", sq, 256, off)
    with pytest.raises(ValueError, match="do not lie inside"):
        ops.flash_attention(tq[:, :64], tk, tv, q_offset=200)
    # a non-causal rank sees every key, whatever its offset
    o = ops.flash_attention(tq[:, :64], tk, tv, causal=False, q_offset=100)
    np.testing.assert_allclose(
        o.numpy(), flash_attention_plain(tq, tk, tv, causal=False)[:, :64]
        .numpy(), **TOL_FWD)
