"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block.

Counterpart of ``src/repro/models/ssm.py``: the chunked SSD forward for
prefill (``mamba2_full``, through the SSD scan kernel ``ops.ssd_scan``)
and the O(1) single-token decode step against the recurrent state
(``mamba2_decode``, plain tensor ops as in the JAX package).

Layout conventions (those of the JAX module):
  x (inner)    [B, S, nh, hd]
  B, C         [B, S, ds]          (n_groups = 1)
  dt           [B, S, nh]          (after softplus)
  ssm state    [B, nh, hd, ds]     float32
  conv state   [B, d_conv-1, d_inner + 2*ds]
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import upcast
from repro_torch.kernels import ops
from repro_torch.models.layers import dot, normal, rmsnorm


def init_mamba2(cfg, dtype: torch.dtype, device: torch.device,
                generator: torch.Generator):
    """One Mamba2 block's parameters: projections and the conv in
    ``dtype``; ``A_log``, ``dt_bias``, ``D`` and the norm scale float32
    whatever ``dtype`` is, as in the JAX package."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_ch = di + 2 * s.d_state
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": normal((d, 2 * di + 2 * s.d_state + nh), d ** -0.5, dtype,
                          device, generator),
        "conv_w": normal((s.d_conv, conv_ch), 0.2, dtype, device, generator),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.zeros(nh, **f32),
        "D": torch.ones(nh, **f32),
        "norm": torch.ones(di, **f32),
        "out_proj": normal((di, d), di ** -0.5, dtype, device, generator),
    }


def _split_in_proj(cfg, zxbcdt):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    ds = s.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + di + 2 * ds]
    dt = zxbcdt[..., di + di + 2 * ds:]
    assert dt.shape[-1] == s.n_heads(cfg.d_model)
    return z, xbc, dt


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv_full(xbc, conv_w, conv_b, conv_state=None):
    """xbc: [B, S, C]; conv_w [K, C] depthwise.  Returns (y, new_state):
    the causal conv over the state's K-1 rows then the sequence, SiLU'd,
    and the last K-1 rows as the next state."""
    k = conv_w.shape[0]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    else:
        pad = conv_state
    xp = torch.cat([pad, xbc], dim=1)                  # [B, S+K-1, C]
    # depthwise causal conv via stacked shifts (K is tiny, typically 4)
    y = sum(xp[:, i: i + xbc.shape[1], :] * conv_w[i] for i in range(k))
    y = F.silu(y + conv_b)
    new_state = xp[:, xp.shape[1] - (k - 1):, :] if k > 1 else pad[:, :0]
    return y, new_state


def mamba2_full(params, cfg, x, conv_state=None, ssm_state=None):
    """Full-sequence Mamba2 from (conv_state, ssm_state) (zeros when
    None). x: [B,S,D].  Returns (out [B,S,D], (conv_state, ssm_state)).

    The scan runs on float32 x, B and C (exact copies of the model-dtype
    values): the JAX package's ``ssd_chunked`` casts them to float32 and
    returns float32 y, to which D·x is added before the one rounding to
    the model dtype; so does this."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    di = s_cfg.d_inner(d)
    nh, hd, ds = s_cfg.n_heads(d), s_cfg.head_dim, s_cfg.d_state
    zxbcdt = dot(x, params["in_proj"])
    z, xbc, dt = _split_in_proj(cfg, zxbcdt)
    xbc, new_conv = _causal_conv_full(xbc, params["conv_w"],
                                      params["conv_b"], conv_state)
    xin = upcast(xbc[..., :di].reshape(b, s, nh, hd)).contiguous()
    Bm = upcast(xbc[..., di: di + ds]).contiguous()
    Cm = upcast(xbc[..., di + ds:]).contiguous()
    dt = _softplus(upcast(dt) + params["dt_bias"]).contiguous()
    A = -torch.exp(params["A_log"])
    y, final = ops.ssd_scan(xin, dt, A, Bm, Cm, chunk=s_cfg.chunk_size,
                            init_state=ssm_state)
    y = y + params["D"][None, None, :, None] * xin
    y = y.to(x.dtype).reshape(b, s, di)
    y = rmsnorm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return dot(y, params["out_proj"]), (new_conv, final)


def mamba2_decode(params, cfg, x, conv_state, ssm_state):
    """One-token recurrent step. x: [B,1,D].

    conv_state: [B, K-1, conv_ch]; ssm_state: [B,nh,hd,ds] float32.
    Returns (out [B,1,D], new_conv_state, new_ssm_state) — new tensors;
    the caller decides which rows to keep."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    assert s == 1
    di = s_cfg.d_inner(d)
    nh, hd, ds = s_cfg.n_heads(d), s_cfg.head_dim, s_cfg.d_state
    zxbcdt = dot(x, params["in_proj"])
    z, xbc, dt = _split_in_proj(cfg, zxbcdt)
    window = torch.cat([conv_state, xbc], dim=1)            # [B, K, C]
    y = torch.einsum("bkc,kc->bc", window, params["conv_w"])
    xbc = F.silu(y + params["conv_b"])[:, None, :]
    new_conv = window[:, 1:, :]
    xin = xbc[..., :di].reshape(b, nh, hd).float()
    Bm = xbc[:, 0, di: di + ds].float()
    Cm = xbc[:, 0, di + ds:].float()
    dtv = _softplus(dt[:, 0].float() + params["dt_bias"])   # [B, nh]
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dtv * A[None, :])                     # [B, nh]
    upd = torch.einsum("bh,bhp,bd->bhpd", dtv, xin, Bm)
    new_state = ssm_state * decay[:, :, None, None] + upd
    yv = torch.einsum("bhpd,bd->bhp", new_state, Cm)
    yv = yv + params["D"][None, :, None] * xin
    yv = yv.reshape(b, 1, di).to(x.dtype)
    yv = rmsnorm(yv * F.silu(z), params["norm"], cfg.norm_eps)
    return dot(yv, params["out_proj"]), new_conv, new_state

