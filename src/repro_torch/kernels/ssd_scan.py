"""Mamba2 SSD chunk scan (state-space duality, arXiv:2405.21060).

Counterpart of the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan``, and of the function the JAX
model actually runs, the jnp ``repro/models/ssm.py::ssd_chunked`` with
its optional initial state.  The hand-written CUDA kernel is
``csrc/ssd_scan.cu`` (its header says what bounds it on the card and how
the design answers); this module holds its launch wrapper and the plain
PyTorch version of the same function, which the CPU path runs and the
card is held to.  Its gradient is :class:`SSDScanFn`: the backward is the
hand-written ``csrc/ssd_scan_bwd.cu`` on the card (the JAX model
differentiates its jnp scan by autodiff, so no Pallas backward exists),
and on the CPU :func:`ssd_scan_bwd_plain`, the VJP of the plain version
by ``torch.autograd``.

Layout (``repro/models/ssm.py``): x ``[b,s,nh,hd]``, dt ``[b,s,nh]``
(post-softplus, float32), A ``[nh]`` float32 (negative), B and C
``[b,s,ds]`` (one group, shared by every head), state ``[b,nh,hd,ds]``
float32.  Returns ``y [b,s,nh,hd]`` in x's dtype and the final state in
float32; every sum and exponential is taken in float32.  The SSD algebra
is exact for any split of the sequence into chunks, so the kernel's own
chunk and the caller's ``chunk`` differ only in summation order.

The kernel is two launches per call, counted as one: ``C·Bᵀ`` once per
(batch, 32-row chunk) into a float32 workspace, then the scan, whose
blocks each own (batch, head, 32 columns of head_dim) as
:func:`scan_plan` says; all four products are 3xTF32 tensor-core
products (``csrc/ssd_scan.cu``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NAME = "ssd_scan"
BWD = "ssd_scan_bwd"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the widest head and state the kernel is built for, its own chunk and
# the columns of head_dim a scan block owns (csrc/ssd_scan.cu: kHD, kDS,
# kQ, kP)
MAX_HEAD_DIM, MAX_D_STATE = 64, 128
CHUNK = 32
SLICE = 32


def scan_plan(head_dim: int) -> int:
    """The scan launch's slices, from static shapes only: block (slice,
    head, batch) owns columns ``[slice*SLICE, (slice+1)*SLICE)`` of the
    head's ``head_dim`` (the last may run past it, masked).  32 columns
    a block at every shape: on the card (``tools/ssd_variants.py``,
    PERF.md) 16-column blocks, 192 at B1 x 48 heads and so a full wave
    on 132 SMs, are within 3% of 32 columns at batch 1 and ~20% slower
    at B4 x 2048; 64-column blocks are ~45% slower at batch 1."""
    return -(-head_dim // SLICE)


def _ssd_chunked(x, dt, A, B, C, chunk: int, init_state):
    """``ssd_chunked`` line for line; s a multiple of ``chunk``.
    -> (y [b,s,nh,hd] float32, final_state [b,nh,hd,ds] float32), both
    float64 where x is."""
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    nc = s // chunk
    ct = torch.promote_types(x.dtype, torch.float32)   # float64 stays
    xc = x.reshape(b, nc, chunk, nh, hd).to(ct)
    dtc = dt.reshape(b, nc, chunk, nh).to(ct)
    Bc = B.reshape(b, nc, chunk, ds).to(ct)
    Cc = C.reshape(b, nc, chunk, ds).to(ct)

    dA = dtc * A[None, None, None, :]             # [b,nc,q,nh] (negative)
    cum = torch.cumsum(dA, dim=2)                 # running log-decay
    # --- intra-chunk (quadratic): L[i,j] = exp(cum_i - cum_j), j <= i
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [b,nc,i,j,nh]
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    diff = torch.where(tril[None, None, :, :, None], diff,
                       torch.tensor(-1e30, dtype=ct, device=x.device))
    L = torch.exp(diff)
    cb = torch.einsum("bnid,bnjd->bnij", Cc, Bc)            # [b,nc,i,j]
    att = cb[..., None] * L                                 # [b,nc,i,j,nh]
    xdt = xc * dtc[..., None]                               # [b,nc,j,nh,hd]
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", att, xdt)

    # --- chunk summary states: S_n = sum_j decay_to_end_j dt_j B_j x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)       # [b,nc,j,nh]
    states = torch.einsum("bnjh,bnjhp,bnjd->bnhpd",
                          decay_to_end * dtc, xc, Bc)

    # --- inter-chunk recurrence over the nc chunks
    chunk_decay = torch.exp(torch.sum(dA, dim=2))           # [b,nc,nh]
    carry = torch.zeros((b, nh, hd, ds), dtype=ct, device=x.device) \
        if init_state is None else init_state.to(ct)
    prev = []
    for n in range(nc):
        prev.append(carry)                     # the state BEFORE chunk n
        carry = carry * chunk_decay[:, n, :, None, None] + states[:, n]
    prev_states = torch.stack(prev, dim=1)                  # [b,nc,nh,hd,ds]

    # --- inter-chunk contribution
    in_decay = torch.exp(cum)                               # from chunk start
    y_inter = torch.einsum("bnid,bnih,bnhpd->bnihp", Cc, in_decay,
                           prev_states)
    return (y_intra + y_inter).reshape(b, s, nh, hd), carry


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int,
                   init_state: Optional[torch.Tensor] = None):
    """The SSD scan over any ``s >= 1``: chunks of ``min(chunk, s)``,
    the sequence zero-padded to a chunk multiple as ``mamba2_full``
    pads it (a padded step has dt = 0: no decay, no update), then
    ``ssd_chunked``.  -> (y [b,s,nh,hd] in x's dtype, final_state
    [b,nh,hd,ds] float32)."""
    s = x.shape[1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        def zpad(a):
            return torch.cat([a, a.new_zeros((a.shape[0], pad)
                                             + tuple(a.shape[2:]))], dim=1)
        x, dt, B, C = zpad(x), zpad(dt), zpad(B), zpad(C)
    y, final = _ssd_chunked(x, dt, A, B, C, chunk, init_state)
    return y[:, :s].to(x.dtype), final


def check_inputs(x, dt, A, B, C, init_state):
    """What the kernel takes: x/B/C float32 or bfloat16 of one dtype, dt,
    A and init_state float32, all contiguous on x's CUDA device; hd <=
    MAX_HEAD_DIM, ds <= MAX_D_STATE.  Raises otherwise.  -> (b, s, nh,
    hd, ds, dtype code)."""
    if x.dim() != 4 or x.dtype not in DTYPE_CODES:
        raise ValueError(f"{NAME}: x must be a float32 or bfloat16 "
                         f"[b,s,nh,hd], got {x.dtype} {tuple(x.shape)}")
    b, s, nh, hd = x.shape
    ds = B.shape[-1] if B.dim() == 3 else -1
    want = {"dt": (dt, (b, s, nh), torch.float32),
            "A": (A, (nh,), torch.float32),
            "B": (B, (b, s, ds), x.dtype), "C": (C, (b, s, ds), x.dtype)}
    if init_state is not None:
        want["init_state"] = (init_state, (b, nh, hd, ds), torch.float32)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{NAME}: {name} must be a contiguous {dtype} "
                             f"{shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"{NAME}: x must be a contiguous CUDA tensor")
    if s < 1 or not 1 <= hd <= MAX_HEAD_DIM or not 1 <= ds <= MAX_D_STATE:
        raise ValueError(f"{NAME}: s={s}, hd={hd}, ds={ds}; the kernel "
                         f"takes s >= 1, hd <= {MAX_HEAD_DIM}, ds <= "
                         f"{MAX_D_STATE}")
    if b > 65535:
        raise ValueError(f"{NAME}: batch {b} > 65535")
    return b, s, nh, hd, ds, DTYPE_CODES[x.dtype]


def ssd_scan_cuda(x, dt, A, B, C, *,
                  init_state: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel on the current stream.  The kernel walks
    its own 32-row chunks (the algebra is exact for any split), so it
    takes no ``chunk``.  The plan comes from static shapes and the
    workspace from ``torch.empty``; nothing is read back to the host, so
    a call can be captured in a CUDA graph.  Raises on anything the
    kernel does not take; never falls back."""
    b, s, nh, hd, ds, code = check_inputs(x, dt, A, B, C, init_state)
    y = torch.empty_like(x)
    final = torch.empty((b, nh, hd, ds), dtype=torch.float32,
                        device=x.device)
    cb = torch.empty((b, -(-s // CHUNK), CHUNK, CHUNK), dtype=torch.float32,
                     device=x.device)
    err = _build.load(NAME)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), 0 if init_state is None else init_state.data_ptr(),
        y.data_ptr(), final.data_ptr(), cb.data_ptr(), b, s, nh, hd, ds,
        code, scan_plan(hd),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(NAME, err)
    _build.LAUNCHES[NAME] += 1
    return y, final


def ssd_scan_bwd_plain(x, dt, A, B, C, dy, *, chunk: int,
                       init_state: Optional[torch.Tensor] = None,
                       dfinal: Optional[torch.Tensor] = None):
    """The VJP of :func:`ssd_scan_plain` by ``torch.autograd``: the
    cotangents ``dy`` of y and ``dfinal`` of the final state (zeros when
    None) back to the inputs.  -> (dx, ddt, dA, dB, dC, dinit), dinit
    None when ``init_state`` is."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, dt, A, B, C)]
        st = None if init_state is None else \
            init_state.detach().requires_grad_()
        y, final = ssd_scan_plain(*ins, chunk=chunk, init_state=st)
        outs, cots = [y], [dy]
        if dfinal is not None:
            outs.append(final)
            cots.append(dfinal)
        wrt = ins + ([] if st is None else [st])
        grads = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, wrt)]
    return (*grads[:5], grads[5] if st is not None else None)


def check_bwd_inputs(x, dt, A, B, C, init_state, dy, dfinal):
    """What the backward kernel takes: float32 x (what ``mamba2_full``
    hands the scan), dy ``[b,s,nh,hd]`` and dfinal ``[b,nh,hd,ds]`` (or
    None) contiguous float32 on x's device, and what
    :func:`check_inputs` asks.  Raises otherwise.  -> (b, s, nh, hd,
    ds)."""
    if x.dtype != torch.float32:
        raise ValueError(f"{BWD}: takes float32 x, B and C, got {x.dtype}")
    b, s, nh, hd = x.shape
    want = {"dy": (dy, (b, s, nh, hd))}
    if dfinal is not None:
        want["dfinal"] = (dfinal, (b, nh, hd, B.shape[-1]))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{BWD}: {name} must be a contiguous float32 "
                             f"{shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return check_inputs(x, dt, A, B, C, init_state)[:5]


def ssd_scan_bwd_cuda(x, dt, A, B, C, dy, *,
                      init_state: Optional[torch.Tensor] = None,
                      dfinal: Optional[torch.Tensor] = None):
    """Launch the backward kernel on the current stream.  It writes dx,
    ddt, and per-head partials of dA, dB and dC (B and C are shared by
    every head, A by every batch row), which are summed here over heads
    and batch rows by ``torch.sum``, in a fixed order (no atomics
    anywhere: the result repeats bit for bit).  The states before each
    32-row chunk go to a float32 workspace ``[b, nc, nh, hd, ds]``.
    Nothing is read back to the host.  Raises on anything the kernel
    does not take; never falls back.  -> (dx, ddt, dA, dB, dC, dinit),
    dinit None when ``init_state`` is."""
    b, s, nh, hd, ds = check_bwd_inputs(x, dt, A, B, C, init_state, dy,
                                        dfinal)
    f32 = dict(dtype=torch.float32, device=x.device)
    states = torch.empty((b, -(-s // CHUNK), nh, hd, ds), **f32)
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt)
    dA = torch.empty((b, nh), **f32)
    dB = torch.empty((b, s, nh, ds), **f32)
    dC = torch.empty((b, s, nh, ds), **f32)
    dinit = None if init_state is None else torch.empty((b, nh, hd, ds),
                                                        **f32)

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    err = _build.load(BWD)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), ptr(init_state), dy.data_ptr(), ptr(dfinal),
        states.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), ptr(dinit), b, s, nh, hd, ds,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(BWD, err)
    _build.LAUNCHES[BWD] += 1
    return dx, ddt, dA.sum(0), dB.sum(2), dC.sum(2), dinit


class SSDScanFn(torch.autograd.Function):
    """The differentiable SSD scan, built as ``FlashAttentionFn`` is:
    the forward runs the plain version on CPU tensors and the K4 kernel
    on CUDA tensors; the backward :func:`ssd_scan_bwd_plain` on the CPU
    and :func:`ssd_scan_bwd_cuda` on the card.  The residuals are the
    inputs; the states are recomputed in the backward.  A cotangent that
    autograd leaves out (the final state's, in training) reaches the
    kernel as a null pointer, not as zeros."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, init_state, chunk: int):
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            y, final = ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                      init_state=init_state)
        else:
            y, final = ssd_scan_cuda(x, dt, A, B, C, init_state=init_state)
        ctx.save_for_backward(x, dt, A, B, C, init_state)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C, st = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dfinal is not None:
            dfinal = dfinal.contiguous()
        if x.device.type == "cpu":
            grads = ssd_scan_bwd_plain(x, dt, A, B, C, dy, chunk=ctx.chunk,
                                       init_state=st, dfinal=dfinal)
        else:
            grads = ssd_scan_bwd_cuda(x, dt, A, B, C, dy, init_state=st,
                                      dfinal=dfinal)
        return (*grads, None)
