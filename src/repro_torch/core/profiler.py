"""Request profiler (paper §4.2 and §5.1 'Workflows').

Three responsibilities:
  1. Collect (batch, length) → time samples from the engine and fit the
     linear latency model.
  2. Track per-task-type output lengths and model them as Gaussians
     (the paper's dynamic output-length predictor).
  3. Estimate the memory-utility constants μ and σ of Eq. 20.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from repro_torch.core import latency_model as lm


@dataclasses.dataclass
class RunningGaussian:
    """Welford running mean/std."""
    n: int = 0
    mean: float = 0.0
    m2: float = 0.0

    def update(self, x: float):
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)

    @property
    def std(self) -> float:
        return math.sqrt(self.m2 / self.n) if self.n > 1 else 0.0


class OutputLengthPredictor:
    """Per-task-type Gaussian over observed output lengths.

    ``predict`` draws from the fitted distribution (paper §5.1: 'the
    predictor generates a random integer based on this fitted
    distribution'); ``predict_mean`` returns the deterministic mean.
    Optionally a business-supplied prior (mean, std) seeds a type.
    """

    def __init__(self, priors: Optional[Dict[str, tuple]] = None, seed: int = 0):
        self._g: Dict[str, RunningGaussian] = defaultdict(RunningGaussian)
        self._rng = np.random.default_rng(seed)
        self._priors = dict(priors or {})

    def observe(self, task_type: str, output_len: int):
        self._g[task_type].update(float(output_len))

    def _dist(self, task_type: str):
        g = self._g.get(task_type)
        if g is not None and g.n >= 2:
            return g.mean, max(g.std, 1.0)
        if task_type in self._priors:
            return self._priors[task_type]
        return 128.0, 64.0          # cold-start default

    def predict(self, task_type: str) -> int:
        mu, sd = self._dist(task_type)
        return max(1, int(round(self._rng.normal(mu, sd))))

    def predict_mean(self, task_type: str) -> int:
        mu, _ = self._dist(task_type)
        return max(1, int(round(mu)))


class LatencyProfiler:
    """Accumulates engine timings and fits Eqs. 14–15."""

    def __init__(self):
        self.prefill_samples = []      # (b, l_i, t)
        self.decode_samples = []       # (b, l_a, tau)

    def observe_prefill(self, batch: int, input_len: int, seconds: float):
        self.prefill_samples.append((batch, input_len, seconds))

    def observe_decode(self, batch: int, accum_len: int, seconds: float):
        self.decode_samples.append((batch, accum_len, seconds))

    @property
    def ready(self) -> bool:
        return len(self.prefill_samples) >= 8 and len(self.decode_samples) >= 8

    def fit(self, nonneg: bool = False) -> lm.LinearLatencyModel:
        """``nonneg`` constrains every coefficient to be ≥ 0 — use it
        when the model feeds a simulator clock, where an extrapolated
        negative cost would make time run backwards."""
        if not self.ready:
            return lm.PAPER_TABLE2
        return lm.fit(self.prefill_samples, self.decode_samples,
                      nonneg=nonneg)


class MemoryModel:
    """Eq. 20: token_num(m) = m·μ/σ."""

    def __init__(self, total_memory: float, mu: float = 0.9,
                 sigma_per_token: float = 1.0):
        self.total = total_memory
        self.mu = mu
        self.sigma = sigma_per_token
        self._peak_ratios = []
        self._token_bytes = []

    def observe_run(self, peak_mem: float, avail_mem: float, tokens: int,
                    mem_used: float):
        self._peak_ratios.append(peak_mem / max(avail_mem, 1e-9))
        if tokens:
            self._token_bytes.append(mem_used / tokens)
        self.mu = float(np.mean(self._peak_ratios))
        if self._token_bytes:
            self.sigma = float(np.mean(self._token_bytes))

    def token_capacity(self, remaining: float) -> int:
        return int(remaining * self.mu / self.sigma)

    def tokens_to_memory(self, tokens: int) -> float:
        return tokens * self.sigma / self.mu
