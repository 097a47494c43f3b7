"""Latency predictor (paper §4.2, Eqs. 14–19).

Multiple linear regression with interaction terms, valid for lengths below
~2k tokens (the paper's stated fit region):

  prefill:          t_p(b, l_i)  = α_p·b·l_i + β_p·b + γ_p·l_i + δ_p
  per-token decode: τ_d(b, l_a)  = α_d·b·l_a + β_d·b + γ_d·l_a + δ_d

The decode total over l_o generated tokens (Eq. 16) has the closed form

  t_d(b, l_i, l_o) = Σ_{k=1..l_o} τ_d(b, l_i + k)
                   = (α_d·b + γ_d)·(l_i·l_o + l_o(l_o+1)/2) + (β_d·b + δ_d)·l_o

so schedule evaluation never loops over output tokens.

Coefficients are fit with ordinary least squares on profiler samples
(design matrix [b·l, b, l, 1]).  Units: seconds (the paper's Table 2 is in
milliseconds; we keep SI and convert at the fixture boundary).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LinearLatencyModel:
    """Fitted coefficients for one LLM instance on one device type."""
    alpha_p: float
    beta_p: float
    gamma_p: float
    delta_p: float
    alpha_d: float
    beta_d: float
    gamma_d: float
    delta_d: float

    # ---------------- Eq. 14
    def prefill_time(self, b, l_i, cached=0):
        """``cached`` prompt tokens already in KV (shared-prefix reuse)
        are not computed: the prefill term is priced at the *unique*
        length ``l_i - cached``.  Decode terms keep the full context —
        cached pages are still attended."""
        l_i = l_i - cached
        return (self.alpha_p * b * l_i + self.beta_p * b
                + self.gamma_p * l_i + self.delta_p)

    # ---------------- Eq. 15
    def per_token_decode_time(self, b, l_a):
        return (self.alpha_d * b * l_a + self.beta_d * b
                + self.gamma_d * l_a + self.delta_d)

    # ---------------- Eq. 16 (closed form)
    def decode_time(self, b, l_i, l_o):
        tri = l_i * l_o + l_o * (l_o + 1) / 2.0
        return ((self.alpha_d * b + self.gamma_d) * tri
                + (self.beta_d * b + self.delta_d) * l_o)

    # ---------------- Eqs. 17, 18, 19
    def exec_time(self, b, l_i, l_o, cached=0):
        return self.prefill_time(b, l_i, cached) \
            + self.decode_time(b, l_i, l_o)

    def ttft_exec(self, b, l_i, cached=0):
        return self.prefill_time(b, l_i, cached)

    def tpot(self, b, l_i, l_o):
        l_o = np.maximum(l_o, 1)
        return self.decode_time(b, l_i, l_o) / l_o

    def as_tuple(self) -> Tuple[float, ...]:
        return dataclasses.astuple(self)

    def perturbed(self, rel: float, which: str = "all",
                  rng: np.random.Generator | None = None):
        """Scale coefficients by (1+rel) — used by the Fig.10 study."""
        vals = dataclasses.asdict(self)
        for k in list(vals):
            if which == "all" or k.startswith(which):
                vals[k] = vals[k] * (1.0 + rel)
        return LinearLatencyModel(**vals)


def _ols(samples: Sequence[Tuple[float, float, float]], nonneg: bool = False):
    """samples: (b, l, t). Returns (alpha, beta, gamma, delta).

    With ``nonneg`` the fit is constrained to non-negative coefficients
    by backward elimination: refit without the most negative column
    until none remain.  Unconstrained OLS on a handful of noisy
    wall-clock samples can balance a large positive term against a
    large negative one — fine inside the sampled range, but the
    extrapolated cost can go *negative*, which runs an event-driven
    simulator clock backwards.  Elimination keeps the surviving terms
    least-squares-calibrated instead of naively truncating them.
    """
    arr = np.asarray(samples, np.float64)
    b, l, t = arr[:, 0], arr[:, 1], arr[:, 2]
    X = np.stack([b * l, b, l, np.ones_like(b)], axis=1)
    keep = list(range(X.shape[1]))
    while True:
        coef, *_ = np.linalg.lstsq(X[:, keep], t, rcond=None)
        if not nonneg or len(coef) == 0 or float(coef.min()) >= 0.0:
            break
        keep.pop(int(np.argmin(coef)))
    full = np.zeros(X.shape[1])
    full[keep] = coef
    return tuple(full)


def fit(prefill_samples, decode_samples,
        nonneg: bool = False) -> LinearLatencyModel:
    """prefill_samples: (b, l_i, t_prefill); decode_samples: (b, l_a, τ_d)."""
    ap, bp, gp, dp = _ols(prefill_samples, nonneg=nonneg)
    ad, bd, gd, dd = _ols(decode_samples, nonneg=nonneg)
    return LinearLatencyModel(ap, bp, gp, dp, ad, bd, gd, dd)


# Paper Table 2 (V100 ×2, Qwen2.5-7B), converted ms → s.  Used as a golden
# fixture in tests and as a fallback before the local profiler has data.
PAPER_TABLE2 = LinearLatencyModel(
    alpha_p=0.1e-3, beta_p=5.7e-3, gamma_p=0.01e-3, delta_p=43.67e-3,
    alpha_d=0.0002e-3, beta_d=0.275e-3, gamma_d=0.00088e-3, delta_d=15.85e-3,
)
