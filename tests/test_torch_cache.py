"""The port's dense and int8 cache functions against the JAX package's
``repro.models.cache``, on the same numpy inputs.

``quantize_kv`` / ``dequantize_kv`` are bit-exact (int8 values and bf16
scales equal, including values on a rounding tie); ``init_cache`` /
``init_paged_cache`` give the same shapes and dtypes; ``write_prefill``
(its ``_ring_write``), ``write_prefill_paged`` on int8 pages and
``copy_page`` write the same values, including a wrapped ring."""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.models import cache as jc
from repro_torch.models import cache as tc

CFG = dataclasses.replace(get_reduced("qwen3-1.7b"), dtype="float32")
WIN = dataclasses.replace(get_reduced("h2o-danube-1.8b"), dtype="float32",
                          sliding_window=24)


def _np(x):
    """torch or jax array -> numpy, bf16 as float32 (exact)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == ml_dtypes.bfloat16 else x


def _kv_inputs(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30)).astype(dtype)
    x[0, 0] = 0.0                                   # an all-zero row
    # a row of exact rounding ties: amax 127 -> scale 1, values k + 0.5
    x[0, 1] = np.linspace(-126.5, 127, shape[-1]).round() + 0.5
    x[0, 1, ..., 0] = 127.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_exact(dtype):
    x = _kv_inputs(0, (3, 5, 2, 64))
    if dtype == "bfloat16":
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jq, js = jc.quantize_kv(jx)
    tq, ts = tc.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert ts.shape == (3, 5, 2, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), _np(js))
    # and the dequantized bf16 product, bit for bit
    np.testing.assert_array_equal(_np(tc.dequantize_kv(tq, ts)),
                                  _np(jc.dequantize_kv(jq, js)))


@pytest.mark.parametrize("cfg,window,quantized", [
    (CFG, 0, False), (CFG, 0, True), (CFG, 40, False), (WIN, 0, True)])
def test_init_cache_matches_jax(cfg, window, quantized):
    want = jc.init_cache(cfg, 3, 128, window=window, quantized=quantized)
    got = tc.init_cache(cfg, 3, 128, window=window, quantized=quantized,
                        device="cpu")
    assert got["pos"].shape == (3,) and got["pos"].dtype == torch.int32
    assert len(got["layers"]) == len(want["layers"])
    for gl, wl in zip(got["layers"], want["layers"]):
        assert sorted(gl) == sorted(wl)
        for name in wl:
            assert tuple(gl[name].shape) == wl[name].shape
            assert str(gl[name].dtype).split(".")[1] == str(wl[name].dtype)
            assert not gl[name].any()


@pytest.mark.parametrize("quantized", [False, True])
def test_init_paged_cache_int8_matches_jax(quantized):
    want = jc.init_paged_cache(CFG, 2, 64, 9, 16, quantized=quantized)
    got = tc.init_paged_cache(CFG, 2, 64, 9, 16, quantized=quantized,
                              device="cpu")
    assert tuple(got["block_tables"].shape) == want["block_tables"].shape
    for gl, wl in zip(got["layers"], want["layers"]):
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
                for k, v in gl.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in wl.items()}


@pytest.mark.parametrize("cfg,s", [
    (CFG, 20),        # S < L: rows past S keep their values
    (WIN, 24),        # S == L
    (WIN, 41),        # S > L: the ring wraps (token t at slot t % L)
])
@pytest.mark.parametrize("quantized", [False, True])
def test_write_prefill_matches_jax(cfg, s, quantized):
    b, msl = 2, 32
    rng = np.random.default_rng(s)
    kv = [rng.standard_normal((b, s, cfg.num_kv_heads, cfg.head_dim))
          .astype(np.float32) for _ in range(2)]
    want = jc.init_cache(cfg, b, msl, quantized=quantized)
    got = tc.init_cache(cfg, b, msl, quantized=quantized, device="cpu")
    # a non-zero ring, so rows the write must leave alone are visible
    fill = rng.integers(-5, 5, got["layers"][0]["k"].shape)
    for name in want["layers"][0]:
        buf = want["layers"][0][name]
        want["layers"][0][name] = jnp.asarray(fill[..., :buf.shape[-1]]
                                              ).astype(buf.dtype)
        got["layers"][0][name].copy_(torch.from_numpy(
            fill[..., :buf.shape[-1]]))
    want = jc.write_prefill(want, 0, tuple(jnp.asarray(a) for a in kv), cfg)
    got = tc.write_prefill(got, 0, tuple(torch.from_numpy(a) for a in kv),
                           cfg)
    for name, w in want["layers"][0].items():
        np.testing.assert_array_equal(_np(got["layers"][0][name]), _np(w))


def test_write_prefill_paged_int8_and_copy_page_match_jax():
    P, npg, n, S = 16, 4, 37, 64
    rng = np.random.default_rng(4)
    kv = [rng.standard_normal((1, S, CFG.num_kv_heads, CFG.head_dim))
          .astype(np.float32) for _ in range(2)]
    bt = np.array([[3, 1, 4, 2], [5, 6, 7, 8]], np.int32)
    want = jc.init_paged_cache(CFG, 2, P * npg, 9, P, quantized=True)
    want["block_tables"] = jnp.asarray(bt)
    got = tc.init_paged_cache(CFG, 2, P * npg, 9, P, quantized=True,
                              device="cpu")
    got["block_tables"] = torch.from_numpy(bt)
    want = jc.write_prefill_paged(want, 1, tuple(jnp.asarray(a) for a in kv),
                                  CFG, 0, n)
    got = tc.write_prefill_paged(got, 1, tuple(torch.from_numpy(a)
                                               for a in kv), CFG, 0, n)
    # copy-on-write of page 4 (the slot's third page) into page 7
    want = jc.copy_page(want, 4, 7)
    got = tc.copy_page(got, 4, 7)
    # page 0 (the null page) takes every padded row, in no set order
    for gl, wl in zip(got["layers"], want["layers"]):
        for name, w in wl.items():
            np.testing.assert_array_equal(_np(gl[name])[1:], _np(w)[1:])
    assert got["layers"][1]["k_scale"][7].any()
    assert torch.equal(got["layers"][1]["v_scale"][7],
                       got["layers"][1]["v_scale"][4])
