"""Port vs JAX reference: the Mamba2 SSD scan (K4's plain version), the
Mamba2 block, and the SSM forwards over the dense cache, in float32.

The plain scan is held to the reference's own oracle (``ssd_ref``, a
sequential recurrence) at its 2e-3, and to the Pallas kernel in
interpret mode on ``tests/test_kernels.py``'s shapes (no initial state:
the Pallas kernel has none) at that file's bounds, 2e-3 in float32 and
5e-2 in bfloat16; both on that file's input recipe (unit normals,
softplus dt, A = -exp(normal)).  Against the jnp ``ssd_chunked`` it
runs the same formulation (chunked einsums, the inter-chunk recurrence)
and is held at 1e-5, with and without an initial state and at a ragged
length, on inputs at the reduced model's scan magnitudes (x, B, C of
std 0.2, softplus dt, A = -1..-16, as ``mamba2_full`` hands the scan at
init): with unit-normal x, B and C the intra-chunk terms reach ~10 and
float32 sums in another order differ by ~1e-5 on small outputs.

The Mamba2 block (``mamba2_full``, ``mamba2_decode``) and
``forward_full`` / ``forward_chunk`` / ``forward_decode`` on reduced
``mamba2-780m`` (d 256, ds 16, hd 32, chunk 32) in float32: logits and
the caches' conv and SSM leaves at the reference's 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import init_params as jax_init_params
from repro.models import model as jax_model
from repro.models import ssm as jax_ssm
from repro.models.cache import init_cache as jax_init_cache
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_reduced as torch_get_reduced
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models import ssm
from repro_torch.models.cache import init_cache, init_paged_cache
from repro_torch.models.model import (forward_chunk, forward_decode,
                                      forward_full, init_params)

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
ORACLE_TOL = dict(atol=2e-3, rtol=2e-3)
CFG = dataclasses.replace(get_reduced("mamba2-780m"), dtype="float32")
TCFG = dataclasses.replace(torch_get_reduced("mamba2-780m"), dtype="float32")
jax_full = jax.jit(jax_model.forward_full, static_argnames=("cfg",))
jax_decode = jax.jit(jax_model.forward_decode, static_argnames=("cfg",))
jax_chunk = jax.jit(jax_model.forward_chunk, static_argnames=("cfg",))
jax_mamba2_full = jax.jit(jax_ssm.mamba2_full, static_argnums=1)
jax_mamba2_decode = jax.jit(jax_ssm.mamba2_decode, static_argnums=1)
jax_ssd_chunked = jax.jit(jax_ssm.ssd_chunked, static_argnums=5)


def _softplus(a):
    return np.logaddexp(a, 0.0)


def _unit_inputs(b, s, nh, hd, ds, seed=0):
    """``tests/test_kernels.py``'s recipe, drawn with numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, nh, hd)).astype(np.float32),
            _softplus(rng.standard_normal((b, s, nh))).astype(np.float32),
            -np.exp(rng.standard_normal(nh)).astype(np.float32),
            rng.standard_normal((b, s, ds)).astype(np.float32),
            rng.standard_normal((b, s, ds)).astype(np.float32))


def _model_scale_inputs(b, s, nh, hd, ds, seed=0):
    """The reduced model's scan magnitudes, plus an initial state."""
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal((b, s, nh, hd)).astype(np.float32),
            _softplus(rng.standard_normal((b, s, nh))).astype(np.float32),
            -np.linspace(1.0, 16.0, nh).astype(np.float32),
            0.2 * rng.standard_normal((b, s, ds)).astype(np.float32),
            0.2 * rng.standard_normal((b, s, ds)).astype(np.float32),
            rng.standard_normal((b, nh, hd, ds)).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


SHAPES = [(1, 64, 2, 32, 16, 16), (2, 128, 4, 64, 32, 32),
          (1, 256, 3, 32, 64, 64)]


@pytest.mark.parametrize("b,s,nh,hd,ds,chunk", SHAPES + [
    (2, 70, 4, 32, 16, 32)])                       # ragged: 70 = 2x32 + 6
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_scan_matches_sequential_oracle(b, s, nh, hd, ds, chunk,
                                              with_state):
    arrays = _unit_inputs(b, s, nh, hd, ds)
    st = np.random.default_rng(1).standard_normal(
        (b, nh, hd, ds)).astype(np.float32) if with_state else None
    y, fin = ssd_scan_plain(*_t(arrays), chunk=chunk,
                            init_state=None if st is None else _t([st])[0])
    yr, fr = ref.ssd_ref(*map(jnp.asarray, arrays), chunk=chunk,
                         init_state=None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **ORACLE_TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(fr), **ORACLE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,nh,hd,ds,chunk", SHAPES)
def test_plain_scan_matches_pallas_interpret(dtype, b, s, nh, hd, ds, chunk):
    """The Pallas kernel (no initial state) in interpret mode; x, B, C
    in ``dtype`` on both sides, dt and A float32."""
    x, dt, A, B, C = _unit_inputs(b, s, nh, hd, ds, seed=3)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x, B, C = (np.asarray(jnp.asarray(a).astype(jdt)) for a in (x, B, C))
    y, st = pallas_ssd(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                       jnp.asarray(B), jnp.asarray(C), chunk=chunk,
                       interpret=True)
    tdt = getattr(torch, dtype)
    tx, tB, tC = (torch.tensor(np.asarray(a, np.float32)).to(tdt)
                  for a in (x, B, C))
    got, fin = ssd_scan_plain(tx, torch.from_numpy(dt), torch.from_numpy(A),
                              tB, tC, chunk=chunk)
    assert got.dtype == tdt and fin.dtype == torch.float32
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else ORACLE_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(y.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(fin.numpy(), np.asarray(st), **ORACLE_TOL)


@pytest.mark.parametrize("s,chunk", [(64, 16), (70, 32), (100, 32)])
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_scan_matches_ssd_chunked(s, chunk, with_state):
    """Same formulation as the jnp scan the JAX model runs: 1e-5.  A
    ragged ``s`` is zero-padded to a chunk multiple on the JAX side, as
    ``mamba2_full`` pads it."""
    x, dt, A, B, C, st = _model_scale_inputs(2, s, 4, 32, 16)
    st = st if with_state else None
    got, fin = ssd_scan_plain(*_t((x, dt, A, B, C)), chunk=chunk,
                              init_state=None if st is None else _t([st])[0])
    pad = (-s) % chunk

    def zpad(a):
        return np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
    y, want_fin = jax_ssd_chunked(
        *map(jnp.asarray, (zpad(x), zpad(dt), A, zpad(B), zpad(C))), chunk,
        init_state=None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(y)[:, :s], **TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(want_fin), **TOL)


def _split_scan(tx, tdt, tA, tB, tC, h):
    """Scan [0, h) from zeros, then [h, s) from its final state."""
    y1, st1 = ssd_scan_plain(tx[:, :h], tdt[:, :h], tA, tB[:, :h],
                             tC[:, :h], chunk=32)
    y2, st2 = ssd_scan_plain(tx[:, h:], tdt[:, h:], tA, tB[:, h:],
                             tC[:, h:], chunk=32, init_state=st1)
    return torch.cat([y1, y2], dim=1), st2


def test_split_continuation_equals_one_scan():
    """Two scans with the state carried == one scan (the mirror of
    tests/test_kernels.py::test_ssd_scan_init_state_continuation, split
    at a ragged 50 of 128): at the reference's 2e-3 against its oracle
    on that test's recipe, and at 1e-5 against the port's own one-scan
    result at the model's scan magnitudes."""
    x, dt, A, B, C = _unit_inputs(1, 128, 2, 16, 8, seed=11)
    y, st = _split_scan(*_t((x, dt, A, B, C)), 50)
    yr, sr = ref.ssd_ref(*map(jnp.asarray, (x, dt, A, B, C)), chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **ORACLE_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sr), **ORACLE_TOL)
    arrays = _t(_model_scale_inputs(1, 128, 2, 16, 8, seed=11)[:5])
    y, st = _split_scan(*arrays, 50)
    y_all, st_all = ssd_scan_plain(*arrays, chunk=32)
    np.testing.assert_allclose(y.numpy(), y_all.numpy(), **TOL)
    np.testing.assert_allclose(st.numpy(), st_all.numpy(), **TOL)


def test_ops_ssd_scan_runs_plain_on_cpu():
    arrays = _t(_unit_inputs(1, 40, 2, 16, 8))
    ops.reset_launch_counts()
    y, fin = ops.ssd_scan(*arrays, chunk=16)
    want = ssd_scan_plain(*arrays, chunk=16)
    assert torch.equal(y, want[0]) and torch.equal(fin, want[1])
    assert ops.launch_counts()["ssd_scan"] == 0


# ------------------------------------------------------------ the model
@pytest.fixture(scope="module")
def params():
    jp = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    CFG)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_block_matches_jax(params, with_state):
    """``mamba2_full`` over 45 tokens (ragged: 32 + 13), from zeros or
    from a random (conv, ssm) state, then one ``mamba2_decode`` step."""
    jp, tp = params
    jb, tb = jp["layers"][0]["mamba"], tp["layers"][0]["mamba"]
    s = CFG.ssm
    di, nh = s.d_inner(CFG.d_model), s.n_heads(CFG.d_model)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 45, CFG.d_model)).astype(np.float32)
    conv = st = None
    if with_state:
        conv = rng.standard_normal((2, s.d_conv - 1, di + 2 * s.d_state)
                                   ).astype(np.float32)
        st = rng.standard_normal((2, nh, s.head_dim, s.d_state)
                                 ).astype(np.float32)
    jo, (jconv, jst) = jax_mamba2_full(
        jb, CFG, jnp.asarray(x), None if conv is None else jnp.asarray(conv),
        None if st is None else jnp.asarray(st))
    to, (tconv, tst) = ssm.mamba2_full(
        tb, TCFG, torch.from_numpy(x),
        None if conv is None else torch.from_numpy(conv),
        None if st is None else torch.from_numpy(st))
    for got, want in ((to, jo), (tconv, jconv), (tst, jst)):
        _close(got, want)
    x1 = rng.standard_normal((2, 1, CFG.d_model)).astype(np.float32)
    jo, jconv, jst = jax_mamba2_decode(jb, CFG, jnp.asarray(x1), jconv, jst)
    to, tconv, tst = ssm.mamba2_decode(tb, TCFG, torch.from_numpy(x1),
                                       tconv, tst)
    for got, want in ((to, jo), (tconv, jconv), (tst, jst)):
        _close(got, want)


def _close_cache(tc, jc):
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    for gl, wl in zip(tc["layers"], jc["layers"]):
        assert set(gl) == set(wl) == {"conv", "ssm"}
        for name in ("conv", "ssm"):
            assert gl[name].dtype == getattr(torch, str(wl[name].dtype))
            _close(gl[name], wl[name])


def test_forwards_match_jax(params):
    """``forward_full`` of a 45-token prompt into a dense cache, 2
    decode steps, a 20-token chunk continuation, one more decode step:
    logits and every conv/SSM leaf at 1e-5."""
    jp, tp = params
    B, S = 2, 45
    rng = np.random.default_rng(0)
    jc = jax_init_cache(CFG, B, 128)
    tc = init_cache(TCFG, B, 128, device="cpu")
    _close_cache(tc, jc)
    toks = rng.integers(0, CFG.vocab_size, (B, S)).astype(np.int32)
    jl, jc, _ = jax_full(jp, CFG, tokens=jnp.asarray(toks), cache=jc)
    tl, tc, aux = forward_full(tp, TCFG, tokens=torch.from_numpy(toks),
                               cache=tc)
    assert aux == 0.0
    _close(tl, jl)
    _close_cache(tc, jc)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for _ in range(2):
        jl, jc = jax_decode(jp, CFG, tokens=jnp.asarray(nxt), cache=jc)
        tl, tc = forward_decode(tp, TCFG, tokens=torch.from_numpy(nxt),
                                cache=tc)
        _close(tl, jl)
        _close_cache(tc, jc)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    chunk = rng.integers(0, CFG.vocab_size, (B, 20)).astype(np.int32)
    jl, jc = jax_chunk(jp, CFG, tokens=jnp.asarray(chunk), cache=jc)
    tl, tc = forward_chunk(tp, TCFG, tokens=torch.from_numpy(chunk),
                           cache=tc)
    _close(tl, jl)
    _close_cache(tc, jc)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    jl, jc = jax_decode(jp, CFG, tokens=jnp.asarray(nxt), cache=jc)
    tl, tc = forward_decode(tp, TCFG, tokens=torch.from_numpy(nxt), cache=tc)
    _close(tl, jl)
    _close_cache(tc, jc)


def test_decode_active_freezes_inactive_slot(params):
    """``forward_decode(active=)`` leaves an inactive slot's conv and SSM
    state bit-identical and steps the active one exactly as an unmasked
    decode does (the JAX engine's ``where`` freeze)."""
    _, tp = params
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, CFG.vocab_size, (2, 20)).astype(np.int32))
    base = init_cache(TCFG, 2, 64, device="cpu")
    forward_full(tp, TCFG, tokens=toks, cache=base)
    masked = {"pos": base["pos"].clone(),
              "layers": [{k: v.clone() for k, v in lc.items()}
                         for lc in base["layers"]]}
    nxt = torch.tensor([[3], [5]], dtype=torch.int32)
    lm, _ = forward_decode(tp, TCFG, tokens=nxt, cache=masked,
                           active=torch.tensor([True, False]))
    lf, _ = forward_decode(tp, TCFG, tokens=nxt, cache=base)
    assert torch.equal(lm[0], lf[0])
    for ml, fl in zip(masked["layers"], base["layers"]):
        for name in ("conv", "ssm"):
            assert torch.equal(ml[name][0], fl[name][0])
            assert not torch.equal(ml[name][1], fl[name][1])
    # slot 1 still holds the prefill state: re-running the full decode
    # from a fresh copy of it reproduces ``base``'s slot-1 step
    again = init_cache(TCFG, 2, 64, device="cpu")
    forward_full(tp, TCFG, tokens=toks, cache=again)
    for ml, al in zip(masked["layers"], again["layers"]):
        for name in ("conv", "ssm"):
            assert torch.equal(ml[name][1], al[name][1])


def test_init_params_and_bridge_keep_the_mamba_layout():
    """The port's own init and the bridge of JAX params (bf16 config)
    give the same tree: ``{"norm", "mamba"}`` per layer, projections and
    conv in bf16, ``A_log``/``dt_bias``/``D``/``norm`` float32."""
    cfg = get_reduced("mamba2-780m")                 # bfloat16
    jp = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    cfg)
    bridged = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    own = init_params(torch_get_reduced("mamba2-780m"), seed=0, device="cpu")
    for tree in (bridged, own):
        assert len(tree["layers"]) == cfg.num_layers
        for jl, tl in zip(jp["layers"], tree["layers"]):
            assert set(tl) == {"norm", "mamba"}
            assert set(tl["mamba"]) == set(jl["mamba"])
            for name, leaf in jl["mamba"].items():
                got = tl["mamba"][name]
                assert tuple(got.shape) == leaf.shape, name
                assert got.dtype == {"bfloat16": torch.bfloat16,
                                     "float32": torch.float32}[
                                         str(leaf.dtype)], name
    for jl, tl in zip(jp["layers"], bridged["layers"]):
        for name, leaf in jl["mamba"].items():
            np.testing.assert_array_equal(
                tl["mamba"][name].float().numpy(),
                np.asarray(leaf.astype(jnp.float32)))


def test_unported_ssm_paths_raise():
    """zamba2 (hybrid) raises naming ROADMAP.md M10; Mamba2 has no paged
    pool and is not trained through remat."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md M10"):
        init_params(torch_get_reduced("zamba2-1.2b"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md M10"):
        init_cache(torch_get_reduced("zamba2-1.2b"), 1, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md M10"):
        init_paged_cache(TCFG, 1, 32, 3, 16, device="cpu")
    tp = init_params(TCFG, seed=0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md M10"):
        forward_full(tp, TCFG, tokens=toks, remat=True)
    tp["layers"][0]["mamba"]["in_proj"].requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP.md M10"):
        forward_full(tp, TCFG, tokens=toks)
