"""The SSD scan's gradient on the CPU: ``ssd_scan_bwd_plain`` (the VJP of
the plain scan by ``torch.autograd``), the differentiable
``ops.ssd_scan`` (``SSDScanFn``) against ``jax.vjp`` of the JAX model's
``ssd_chunked``, and the backward kernel's own decomposition
(``csrc/ssd_scan_bwd.cu``: 32-row chunks walked in reverse from dfinal,
the states recomputed forward first) emulated in PyTorch and held to the
plain VJP and to a float64 truth.

Bounds, each with its reason:
  * ``ssd_scan_bwd_plain`` vs autograd through ``_ssd_chunked``: equal
    (the same graph);
  * ``ops.ssd_scan`` grads vs ``jax.vjp(ssd_chunked)``: 1e-5 of each
    gradient's max (f32 sums in another order);
  * the kernel's decomposition vs the plain VJP over the same 32-row
    chunks: 1e-5 of each gradient's max, dA 5e-5: dA
    sums dt·da over every row, and those terms cancel, so each side is
    up to 1.3e-5 of max |dA| off the float64 truth (measured);
  * against the float64 truth at the Mamba2 widths over 2048 rows: the
    plain VJP over 32-row chunks within 1e-5 of each gradient's max, over
    256-row chunks within 1e-4 (measured 5.3e-6 and 4.0e-5: ddt sums
    long running sums of dc that cancel), which is why ``chip_smoke.py`` holds
    the kernel to the plain VJP over its own 32-row chunks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss

torch.set_num_threads(2)
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def _inputs(rng, b, s, nh, hd, ds, with_state):
    """x, B, C of std 0.5, dt = softplus(N(0,1) - 1), A = -(1..16)
    (the model's A_log init), a N(0,1) state or None, float32 numpy."""
    f = np.float32
    x = (0.5 * rng.standard_normal((b, s, nh, hd))).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)) - 1.0)).astype(f)
    A = -np.linspace(1.0, 16.0, nh).astype(f)
    B = (0.5 * rng.standard_normal((b, s, ds))).astype(f)
    C = (0.5 * rng.standard_normal((b, s, ds))).astype(f)
    st = rng.standard_normal((b, nh, hd, ds)).astype(f) if with_state \
        else None
    return x, dt, A, B, C, st


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    lim = rel * float(np.abs(want).max())
    assert err <= lim, (what, err, lim)
    return err / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("with_state", [False, True])
def test_plain_bwd_is_autograd_through_ssd_chunked(with_state):
    rng = np.random.default_rng(0)
    x, dt, A, B, C, st = map(_t, _inputs(rng, 2, 32, 3, 8, 5, with_state))
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    dfin = torch.randn((2, 3, 8, 5)) if with_state else None
    got = ss.ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk=16,
                                init_state=st, dfinal=dfin)
    ins = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    sti = None if st is None else st.clone().requires_grad_()
    y, fin = ss._ssd_chunked(*ins, 16, sti)
    outs, cots = [y], [dy]
    if dfin is not None:
        outs.append(fin)
        cots.append(dfin)
    want = torch.autograd.grad(outs, ins + ([sti] if with_state else []),
                               cots)
    for nm, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), nm
    assert (got[5] is None) == (not with_state)


def _jax_vjp(x, dt, A, B, C, st, dy, dfin, chunk):
    """``jax.vjp`` of ``ssd_chunked`` over the sequence zero-padded to a
    chunk multiple, as the JAX ``mamba2_full`` pads it."""
    s = x.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk

    def f(x, dt, A, B, C, st):
        def zp(a):
            return jnp.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
        y, fin = ssd_chunked(zp(x), zp(dt), A, zp(B), zp(C), chunk, st)
        return y[:, :s], fin
    st_j = jnp.zeros((x.shape[0], x.shape[2], x.shape[3], B.shape[-1]),
                     jnp.float32) if st is None else jnp.asarray(st)
    (y, fin), vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, dt, A, B, C)),
                            st_j)
    cot_fin = jnp.zeros_like(fin) if dfin is None else jnp.asarray(dfin)
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), cot_fin))]


@pytest.mark.parametrize("s,chunk,with_state,with_dfinal", [
    (37, 8, False, False), (37, 16, True, True), (48, 16, False, True),
    (48, 8, True, False), (5, 16, True, True)])
def test_ops_ssd_scan_grads_match_jax_vjp(s, chunk, with_state, with_dfinal):
    rng = np.random.default_rng(s + chunk)
    b, nh, hd, ds = 2, 3, 8, 5
    x, dt, A, B, C, st = _inputs(rng, b, s, nh, hd, ds, with_state)
    dy = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    dfin = rng.standard_normal((b, nh, hd, ds)).astype(np.float32) \
        if with_dfinal else None
    want = _jax_vjp(x, dt, A, B, C, st, dy, dfin, chunk)
    ins = [_t(a).requires_grad_() for a in (x, dt, A, B, C)]
    sti = None if st is None else _t(st).requires_grad_()
    y, fin = ops.ssd_scan(*ins, chunk=chunk, init_state=sti)
    loss = (y * _t(dy)).sum()
    if dfin is not None:
        loss = loss + (fin * _t(dfin)).sum()
    got = torch.autograd.grad(loss, ins + ([sti] if with_state else []))
    for nm, g, w in zip(NAMES, got, want):
        _close(g.numpy(), w, 1e-5, nm)


def _emulate_kernel(x, dt, A, B, C, dy, init_state, dfinal, q=ss.CHUNK):
    """The backward kernel's arithmetic, vectorised over (batch, head):
    the sequence zero-padded to 32-row chunks, the state before each
    chunk recomputed forward, then per chunk in reverse from dfinal the
    32 x 32 tiles M = (C·Bᵀ)∘E, P = (dy·uᵀ)∘E, w = M∘(dy·uᵀ) over the
    causal side, du, dC, dB, the carried dS, and dc's suffix sums
    (csrc/ssd_scan_bwd.cu's header has the formulas)."""
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    nc = -(-s // q)
    pad = nc * q - s

    def zp(a):
        return torch.cat([a, a.new_zeros((b, pad) + a.shape[2:])], 1)
    x, dt, B, C, dy = (zp(t).reshape((b, nc, q) + t.shape[2:])
                       for t in (x, dt, B, C, dy))
    c = torch.cumsum(dt * A, 2)                        # [b,nc,q,nh]
    eC, eL = torch.exp(c), torch.exp(c[:, :, -1:] - c)
    u = dt[..., None] * x
    S = x.new_zeros((b, nh, hd, ds)) if init_state is None \
        else init_state.clone()
    states = []
    for n in range(nc):
        states.append(S)
        S = eC[:, n, -1, :, None, None] * S + torch.einsum(
            "bjh,bjhp,bjd->bhpd", eL[:, n], u[:, n], B[:, n])
    dS = x.new_zeros((b, nh, hd, ds)) if dfinal is None else dfinal.clone()
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool))[None, :, :, None]
    strict = causal & ~torch.eye(q, dtype=torch.bool)[None, :, :, None]
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    dB, dC = torch.zeros_like(B), torch.zeros_like(C)
    dA = x.new_zeros(nh)
    for n in reversed(range(nc)):
        cn, Sp, Bn, Cn, dyn, un = c[:, n], states[n], B[:, n], C[:, n], \
            dy[:, n], u[:, n]
        diff = cn[:, :, None, :] - cn[:, None, :, :]
        E = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)),
                        0.0)
        dyu = torch.einsum("bihp,bjhp->bijh", dyn, un)
        M = torch.einsum("bid,bjd->bij", Cn, Bn)[..., None] * E
        P = dyu * E
        W = M * dyu
        dsb = torch.einsum("bhpd,bjd->bjhp", dS, Bn)
        du = torch.einsum("bijh,bihp->bjhp", M, dyn) \
            + eL[:, n, ..., None] * dsb
        dx[:, n] = dt[:, n, ..., None] * du
        qv = (un * dsb).sum(-1)
        sdy = torch.einsum("bhpd,bihp->bihd", Sp, dyn)
        dC[:, n] = (torch.einsum("bijh,bjd->bihd", P, Bn)
                    + eC[:, n, ..., None] * sdy).sum(2)
        r = (Cn[:, :, None, :] * sdy).sum(-1)
        dB[:, n] = (torch.einsum("bijh,bid->bjhd", P, Cn)
                    + eL[:, n, ..., None] * torch.einsum(
                        "bhpd,bjhp->bjhd", dS, un)).sum(2)
        sdot = (dS * Sp).sum((-1, -2))
        dS = eC[:, n, -1, :, None, None] * dS + torch.einsum(
            "bih,bihp,bid->bhpd", eC[:, n], dyn, Cn)
        Wo = torch.where(strict, W, 0.0)
        dc = Wo.sum(2) - Wo.sum(1) + eC[:, n] * r - eL[:, n] * qv
        dc[:, -1] += eC[:, n, -1] * sdot + (eL[:, n] * qv).sum(1)
        da = torch.flip(torch.cumsum(torch.flip(dc, [1]), 1), [1])
        ddt[:, n] = (x[:, n] * du).sum(-1) + A * da
        dA = dA + (dt[:, n] * da).sum((0, 1))

    def cut(t):
        return t.reshape((b, nc * q) + t.shape[3:])[:, :s]
    return (cut(dx), cut(ddt), dA, cut(dB), cut(dC),
            None if init_state is None else dS)


@pytest.mark.parametrize("s,with_state", [(1, True), (32, False),
                                          (70, True), (100, False)])
def test_kernel_decomposition_matches_plain_vjp(s, with_state):
    rng = np.random.default_rng(7 + s)
    b, nh, hd, ds = 2, 3, 16, 12
    x, dt, A, B, C, st = map(_t, _inputs(rng, b, s, nh, hd, ds, with_state))
    dy = _t(rng.standard_normal((b, s, nh, hd)).astype(np.float32))
    dfin = _t(rng.standard_normal((b, nh, hd, ds)).astype(np.float32)) \
        if with_state else None
    want = ss.ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk=ss.CHUNK,
                                 init_state=st, dfinal=dfin)
    got = _emulate_kernel(x, dt, A, B, C, dy, st, dfin)
    for nm, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None
            continue
        _close(g.numpy(), w.numpy(), 5e-5 if nm == "dA" else 1e-5, nm)


def test_plain_vjp_against_float64_truth():
    """At the Mamba2-780M head widths (hd 64, ds 128; 4 of its 48 heads)
    over 2048 rows: the emulated kernel in float64 is the truth (it
    matches the plain VJP at every shape above)."""
    rng = np.random.default_rng(11)
    b, s, nh, hd, ds = 1, 2048, 4, 64, 128
    x, dt, A, B, C, st = map(_t, _inputs(rng, b, s, nh, hd, ds, True))
    A = -torch.tensor([1.0, 6.0, 11.0, 16.0])
    dy = _t(rng.standard_normal((b, s, nh, hd)).astype(np.float32))
    dfin = _t(rng.standard_normal((b, nh, hd, ds)).astype(np.float32))
    truth = _emulate_kernel(*(t.double() for t in (x, dt, A, B, C, dy, st,
                                                   dfin)))
    for chunk, rel in ((ss.CHUNK, 1e-5), (256, 1e-4)):
        got = ss.ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk=chunk,
                                    init_state=st, dfinal=dfin)
        worst = max(_close(g.numpy(), w.numpy(), rel, f"{nm} chunk {chunk}")
                    for nm, g, w in zip(NAMES, got, truth))
        print(f"plain VJP over {chunk}-row chunks: worst gradient error "
              f"{worst:.2e} of its max against float64")


def test_backward_wrapper_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(3)
    x, dt, A, B, C, _ = map(_t, _inputs(rng, 1, 8, 2, 4, 4, False))
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan_bwd_cuda(x, dt, A, B, C, torch.zeros_like(x))
    with pytest.raises(ValueError, match="float32"):
        ss.check_bwd_inputs(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(),
                            None, torch.zeros_like(x), None)
    with pytest.raises(ValueError, match="dy"):
        ss.check_bwd_inputs(x, dt, A, B, C, None, torch.zeros(1), None)
