"""The SSD scan kernel's decomposition (``csrc/ssd_scan.cu``, K4), on the
CPU, where the kernel cannot run.

(a) The launch plan of the wrapper (``scan_plan``, static shapes only):
its blocks cover every (batch, head, column of head_dim) exactly once.

(b) An emulation of what the kernel computes, written here from its own
decomposition: 32-row chunks, C·Bᵀ once per (batch, chunk) shared by
every head, then per (batch, head, column slice of the plan) a chunk loop
carrying the state slice, every product 3xTF32 as the kernel splits
its operands (CUTLASS's fast split: hi = a truncated to TF32, lo = a − hi
rounded to TF32 as ``cvt.rna`` rounds, the mantissa to 10 bits, ties away
from zero; then hi·hi + hi·lo + lo·hi summed in float32).  It meets the
port's plain version, the JAX model's jnp ``ssd_chunked`` and the Pallas
kernel in interpret mode (no initial state: the Pallas kernel has none)
within the card's float32 bound ``chip_smoke.SSD_TOL``: 5e-5 of max
|plain|.  One TF32 pass instead of three lands at least 10x further off
and outside that bound, which is why the kernel takes three.  Inputs are
``chip_smoke.py``'s recipe at the model's widths (hd 64, ds 128 and
Zamba2's ds 64), drawn with numpy."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models import ssm as jax_ssm
from repro_torch.kernels import ssd_scan as ss

torch.set_num_threads(2)
SHARE = 5e-5            # chip_smoke.SSD_TOL["float32"]: share of max |plain|


@pytest.mark.parametrize("batch,nh,hd", [
    (1, 48, 64),      # Mamba2-780M serve prefill: batch 1
    (4, 48, 64),      # the timed B4 x 2048 shape
    (3, 48, 64),
    (1, 7, 64),       # few heads
    (1, 64, 64),      # Zamba2-1.2B widths (hd 64, 64 heads)
    (2, 32, 32),      # hd 32: one slice
    (1, 48, 48),      # hd 48: the last slice half masked
    (1, 5, 20),       # hd 20: a ragged slice
    (1, 3, 8),        # narrower than a column tile
    (2, 4, 33),       # one column into a second slice
])
def test_scan_plan_covers_every_column_once(batch, nh, hd):
    """The scan blocks (slice, head, batch) own columns [32·slice,
    32·slice + 32) ∩ [0, hd): every (batch, head, column) exactly once,
    no slice wholly past hd."""
    slices = ss.scan_plan(hd)
    owned = np.zeros((batch, nh, hd), np.int64)
    for sl in range(slices):
        lo, hi = sl * ss.SLICE, min((sl + 1) * ss.SLICE, hd)
        assert lo < hi
        owned[:, :, lo:hi] += 1
    assert (owned == 1).all()


def test_scan_plan_at_the_model_widths():
    """Mamba2-780M (hd 64, 48 heads): 2 slices, so a batch-1 prefill runs
    96 scan blocks of four warps on the H100's 132 SMs, at most one per
    SM, and B4 384 blocks at two per SM.  16-column slices (192 blocks at
    B1, one wave) measured within 3% of 32 columns at batch 1 and ~20%
    slower at B4 x 2048 on the card (tools/ssd_variants.py, PERF.md), so
    the plan keeps 32 columns and does not fill the wave at B1."""
    assert ss.scan_plan(64) == 2
    assert 1 * 48 * ss.scan_plan(64) == 96 < 132
    assert ss.scan_plan(32) == 1 and ss.scan_plan(48) == 2


def test_cuda_wrapper_reads_nothing_to_the_host():
    """The plan comes from static shapes and the workspace from
    torch.empty: no sync, so a call can be captured in a CUDA graph."""
    for fn in (ss.ssd_scan_cuda, ss.scan_plan):
        src = inspect.getsource(fn)
        for call in (".item(", ".tolist(", ".cpu(", ".numpy(",
                     "synchronize(", "torch.zeros("):
            assert call not in src, (fn.__name__, call)


# ------------------------------------------------ (b) the emulation
def tf32(a):
    """float32 -> TF32 rounded to nearest, ties away from zero (as
    ``cvt.rna`` rounds; the tensor core reads the top 19 bits of an
    operand, so the kernel's lo + half an ulp is lo rounded so)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_rz(a):
    """float32 -> TF32 truncated: the kernel's hi."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def mm(a, b, passes):
    """a @ b as the kernel's tensor-core products, float32 sums: 3xTF32
    (passes 3: hi = tf32_rz(a), lo = tf32(a − hi), hi·hi + hi·lo +
    lo·hi), or one TF32 pass of the operands rounded to nearest."""
    a, b = np.float32(a), np.float32(b)
    if passes == 1:
        return tf32(a) @ tf32(b)
    ah, bh = tf32_rz(a), tf32_rz(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def emulate(x, dt, A, B, C, init_state=None, *, passes=3):
    """The kernel's decomposition in numpy float32.  -> (y, state)."""
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    q = ss.CHUNK
    nc = -(-s // q)
    pad = nc * q - s

    def zpad(a):
        return np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
    x, dt, B, C = zpad(x), zpad(dt), zpad(B), zpad(C)
    # C·Bᵀ once per (batch, chunk), shared by every head
    cb = [[mm(C[i, c * q:(c + 1) * q], B[i, c * q:(c + 1) * q].T, passes)
           for c in range(nc)] for i in range(b)]
    slices, width = ss.scan_plan(hd), ss.SLICE
    causal = np.tril(np.ones((q, q), bool))
    y = np.zeros((b, nc * q, nh, hd), np.float32)
    fin = np.zeros((b, nh, hd, ds), np.float32)
    for i in range(b):
        for h in range(nh):
            for sl in range(slices):
                cols = slice(sl * width, min((sl + 1) * width, hd))
                st = (np.zeros((cols.stop - cols.start, ds), np.float32)
                      if init_state is None else
                      np.float32(init_state[i, h, cols]))
                for c in range(nc):
                    rows = slice(c * q, (c + 1) * q)
                    xs, d = x[i, rows, h, cols], dt[i, rows, h]
                    Bc, Cc = B[i, rows], C[i, rows]
                    cum = np.cumsum(d * A[h], dtype=np.float32)
                    diff = np.where(causal, cum[:, None] - cum[None, :],
                                    np.float32(0))
                    att = np.where(causal, cb[i][c] * np.exp(diff),
                                   np.float32(0))
                    y[i, rows, h, cols] = (
                        np.exp(cum)[:, None] * mm(Cc, st.T, passes)
                        + mm(att, xs * d[:, None], passes))
                    w = d * np.exp(cum[-1] - cum)
                    st = (np.exp(cum[-1]) * st
                          + mm((xs * w[:, None]).T, Bc, passes))
                fin[i, h, cols] = st
    return y[:, :s], fin


def _inputs(b, s, nh, hd, ds, with_state, seed):
    """chip_smoke.ssd_inputs' recipe: x, B, C normal of std 0.5, dt =
    softplus(N(0,1) - 1), A = -(1..16), a N(0,1) initial state."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (0.5 * rng.standard_normal((b, s, nh, hd))).astype(f32)
    dt = np.logaddexp(rng.standard_normal((b, s, nh)) - 1.0, 0.0).astype(f32)
    A = -np.linspace(1.0, 16.0, nh).astype(f32)
    B = (0.5 * rng.standard_normal((b, s, ds))).astype(f32)
    C = (0.5 * rng.standard_normal((b, s, ds))).astype(f32)
    st = rng.standard_normal((b, nh, hd, ds)).astype(f32) if with_state \
        else None
    return x, dt, A, B, C, st


def _err(got, want):
    """max |got - want| as a share of max |want|."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


CASES = [  # b, s, nh, hd, ds: ragged s; Mamba2 (ds 128), Zamba2 (ds 64)
    (2, 100, 3, 64, 128),
    (1, 45, 2, 64, 64),
]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,s,nh,hd,ds", CASES)
def test_emulation_meets_plain_and_jax(b, s, nh, hd, ds, with_state):
    """3xTF32 emulation vs the plain version (the card's reference in
    chip_smoke.py, chunk 256) and the jnp ``ssd_chunked`` (chunk 25,
    zero-padded as ``mamba2_full`` pads): within 5e-5 of max |plain| on y
    and the final state; one TF32 pass at least 10x further off."""
    x, dt, A, B, C, st = _inputs(b, s, nh, hd, ds, with_state, seed=s)
    y3, f3 = emulate(x, dt, A, B, C, st)
    y1, f1 = emulate(x, dt, A, B, C, st, passes=1)
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    yp, fp = ss.ssd_scan_plain(
        *t, chunk=256, init_state=None if st is None else
        torch.from_numpy(st))
    chunk = 25
    pad = (-s) % chunk

    def zpad(a):
        return np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
    yj, fj = jax_ssm.ssd_chunked(
        *map(jnp.asarray, (zpad(x), zpad(dt), A, zpad(B), zpad(C))), chunk,
        init_state=None if st is None else jnp.asarray(st))
    yj = np.asarray(yj)[:, :s]
    for got, got1, plain, jax_out in ((y3, y1, yp.numpy(), yj),
                                      (f3, f1, fp.numpy(), np.asarray(fj))):
        assert _err(got, plain) <= SHARE
        assert _err(got, jax_out) <= SHARE
        assert _err(plain, jax_out) <= SHARE
        one_pass = _err(got1, plain)
        assert one_pass >= 10 * _err(got, plain) and one_pass > SHARE


@pytest.mark.parametrize("b,s,nh,hd,ds,chunk", [
    (2, 100, 3, 64, 128, 50),
    (1, 45, 2, 64, 64, 45),
])
def test_emulation_meets_pallas_interpret(b, s, nh, hd, ds, chunk):
    """The Pallas kernel in interpret mode, from a zero state (it takes
    none), on the same inputs: within 5e-5 of max |Pallas|."""
    x, dt, A, B, C, _ = _inputs(b, s, nh, hd, ds, False, seed=s + 1)
    y3, f3 = emulate(x, dt, A, B, C)
    yk, fk = pallas_ssd(*map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk,
                        interpret=True)
    assert _err(y3, np.asarray(yk)) <= SHARE
    assert _err(f3, np.asarray(fk)) <= SHARE
