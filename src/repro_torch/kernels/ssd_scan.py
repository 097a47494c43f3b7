"""Mamba2 SSD chunk scan (state-space duality, arXiv:2405.21060).

Counterpart of the Pallas TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan``, and of the function the JAX
model actually runs, the jnp ``repro/models/ssm.py::ssd_chunked`` with
its optional initial state.  The hand-written CUDA kernel is
``csrc/ssd_scan.cu`` (its header says what bounds it on the card and how
the design answers); this module holds its launch wrapper and the plain
PyTorch version of the same function, which the CPU path runs and the
card is held to.

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
    -> (y [b,s,nh,hd] float32, final_state [b,nh,hd,ds] float32)."""
    b, s, nh, hd = x.shape
    ds = B.shape[-1]
    nc = s // chunk
    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, nh, hd).to(f32)
    dtc = dt.reshape(b, nc, chunk, nh).to(f32)
    Bc = B.reshape(b, nc, chunk, ds).to(f32)
    Cc = C.reshape(b, nc, chunk, ds).to(f32)

    dA = dtc * A[None, None, None, :]             # [b,nc,q,nh] (negative)
    cum = torch.cumsum(dA, dim=2)                 # running log-decay
    # --- intra-chunk (quadratic): L[i,j] = exp(cum_i - cum_j), j <= i
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [b,nc,i,j,nh]
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    diff = torch.where(tril[None, None, :, :, None], diff,
                       torch.tensor(-1e30, dtype=f32, device=x.device))
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
    carry = torch.zeros((b, nh, hd, ds), dtype=f32, device=x.device) \
        if init_state is None else init_state.to(f32)
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
