"""Trace-replay workloads: paper-dataset length distributions + arrival
processes.

The paper evaluates on two public datasets this container cannot
download:

  * Python-Code-23k-ShareGPT  [hf:ajibawa-2023/Python-Code-23k-ShareGPT]
      code generation — e2e SLO (30 s)
  * ShareGPT_Vicuna_unfiltered [hf:anon8231489123/ShareGPT_Vicuna_unfiltered]
      chat — TTFT (10 s) + TPOT (50 ms) SLOs

Instead of parametric stand-ins (``repro_torch.data.synthetic`` fits
lognormals), this module replays *length histograms* checked into
``experiments/traces/*.json`` — inverse-CDF sampling reproduces the
full shape (multi-modal bulk + heavy tail), and swapping the JSON for
one distilled from the real dataset changes nothing downstream.  See
docs/evaluation.md for the file format and how to regenerate.

Arrivals come from three processes (all seeded, all mean-``rate``):

  * ``poisson`` — i.i.d. exponential gaps (the classic open-loop model)
  * ``bursty``  — 2-state MMPP: calm/burst states with a ``burst``-fold
    rate ratio, switching with geometric dwell times
  * ``diurnal`` — inhomogeneous Poisson by thinning against
    ``λ(t) = rate·(1 + depth·sin(2πt/period))``

Every generator funnels into the one shared convention the executors
already speak: :func:`sample_trace` returns ``List[Request]`` (for
``events.simulate`` and the planners) and :func:`sample_trace_workload`
returns ``[(Request, prompt_tokens)]`` (for ``Engine.run_policy`` /
``ServeLoop.submit_trace``), with identical length/arrival draws for a
given seed.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.slo import SLO, Request

TRACES_DIR = pathlib.Path(__file__).resolve().parents[3] \
    / "experiments" / "traces"

#: trace profiles shipped with the repo (experiments/traces/<name>.json)
BUILTIN_TRACES = ("python-code-23k-sharegpt", "sharegpt-vicuna")


# ------------------------------------------------------------- histograms
@dataclasses.dataclass(frozen=True)
class LengthHistogram:
    """A token-length distribution as ``k+1`` ascending bin edges and
    ``k`` non-negative masses.  Sampling is inverse-CDF: pick a bin by
    mass, then uniform within it — reproducing the checked-in shape
    without carrying the raw dataset."""
    edges: Tuple[float, ...]
    counts: Tuple[float, ...]

    def __post_init__(self):
        if len(self.edges) != len(self.counts) + 1:
            raise ValueError("need len(edges) == len(counts) + 1")
        if any(b <= a for a, b in zip(self.edges, self.edges[1:])):
            raise ValueError("edges must be strictly ascending")
        if min(self.counts, default=0.0) < 0 or sum(self.counts) <= 0:
            raise ValueError("counts must be non-negative with mass > 0")

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """``n`` integer lengths (≥ 1) drawn from the histogram."""
        p = np.asarray(self.counts, np.float64)
        p = p / p.sum()
        bins = rng.choice(len(p), size=n, p=p)
        lo = np.asarray(self.edges[:-1], np.float64)[bins]
        hi = np.asarray(self.edges[1:], np.float64)[bins]
        vals = lo + rng.random(n) * (hi - lo)
        return np.maximum(vals.astype(np.int64), 1)

    @classmethod
    def from_samples(cls, values: Sequence[float],
                     bins: int = 32) -> "LengthHistogram":
        """Distill raw lengths (e.g. a real dataset's token counts) into
        a checked-in histogram: log-spaced bins cover the heavy tail."""
        v = np.asarray(values, np.float64)
        v = v[v > 0]
        edges = np.geomspace(v.min(), v.max() + 1.0, bins + 1)
        counts, edges = np.histogram(v, bins=edges)
        return cls(edges=tuple(float(e) for e in edges),
                   counts=tuple(float(c) for c in counts))


@dataclasses.dataclass(frozen=True)
class TraceProfile:
    """One dataset's shape: length histograms + task type + SLO."""
    name: str
    task_type: str
    slo: SLO
    input: LengthHistogram
    output: LengthHistogram
    source: str = ""

    def to_json(self) -> dict:
        return {
            "name": self.name, "task_type": self.task_type,
            "source": self.source,
            "slo": {"ttft": self.slo.ttft, "tpot": self.slo.tpot,
                    "e2e": self.slo.e2e},
            "input": {"edges": list(self.input.edges),
                      "counts": list(self.input.counts)},
            "output": {"edges": list(self.output.edges),
                       "counts": list(self.output.counts)},
        }

    @classmethod
    def from_json(cls, obj: dict) -> "TraceProfile":
        slo = obj.get("slo") or {}
        return cls(
            name=obj["name"], task_type=obj.get("task_type", obj["name"]),
            source=obj.get("source", ""),
            slo=SLO(ttft=slo.get("ttft"), tpot=slo.get("tpot"),
                    e2e=slo.get("e2e")),
            input=LengthHistogram(tuple(obj["input"]["edges"]),
                                  tuple(obj["input"]["counts"])),
            output=LengthHistogram(tuple(obj["output"]["edges"]),
                                   tuple(obj["output"]["counts"])))


def load_trace_profile(name: Union[str, pathlib.Path,
                                   TraceProfile]) -> TraceProfile:
    """Resolve a profile: pass-through, a path to a JSON file, or the
    name of a checked-in trace (``experiments/traces/<name>.json``)."""
    if isinstance(name, TraceProfile):
        return name
    path = pathlib.Path(name)
    if not path.suffix:
        path = TRACES_DIR / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(
            f"no trace profile {str(name)!r}; built-ins: "
            f"{sorted(BUILTIN_TRACES)} (dir: {TRACES_DIR})")
    with open(path) as f:
        return TraceProfile.from_json(json.load(f))


# --------------------------------------------------------------- arrivals
def poisson_arrivals(n: int, rate: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Homogeneous Poisson process: i.i.d. exponential gaps."""
    if rate <= 0:
        return np.zeros(n)
    return np.cumsum(rng.exponential(1.0 / rate, n))


def bursty_arrivals(n: int, rate: float, rng: np.random.Generator,
                    burst: float = 8.0, burst_frac: float = 0.15,
                    dwell: int = 16) -> np.ndarray:
    """2-state Markov-modulated Poisson process with mean rate ``rate``.

    A fraction ``burst_frac`` of arrivals lands in the burst state,
    where the instantaneous rate is ``burst``× the calm rate; states
    persist for geometric dwells of mean ``dwell`` arrivals.  With
    ``f`` of the arrivals bursty, the long-run rate is
    ``1 / ((1-f)/r_calm + f/(burst·r_calm))``; solving for ``r_calm``
    keeps it equal to the Poisson process at the same ``rate``, so
    attainment curves across processes are load-comparable.
    """
    if rate <= 0:
        return np.zeros(n)
    r_calm = rate * ((1.0 - burst_frac) + burst_frac / burst)
    rates = (r_calm, r_calm * burst)
    # stationary split of *arrivals*: burst_frac of them come from the
    # burst state, so dwell lengths are scaled per state
    dwells = (max(dwell * (1 - burst_frac) / max(burst_frac, 1e-9), 1.0),
              float(max(dwell, 1)))
    state = 1 if rng.random() < burst_frac else 0
    gaps = np.empty(n)
    for i in range(n):
        gaps[i] = rng.exponential(1.0 / rates[state])
        if rng.random() < 1.0 / dwells[state]:
            state = 1 - state
    return np.cumsum(gaps)


def diurnal_arrivals(n: int, rate: float, rng: np.random.Generator,
                     period: float = 300.0,
                     depth: float = 0.8) -> np.ndarray:
    """Inhomogeneous Poisson by thinning: ``λ(t) = rate·(1 +
    depth·sin(2πt/period))`` — a compressed day/night load cycle.
    ``depth`` ∈ [0, 1): 0 degrades to plain Poisson."""
    if rate <= 0:
        return np.zeros(n)
    if not 0.0 <= depth < 1.0:
        raise ValueError("depth must be in [0, 1)")
    lam_max = rate * (1.0 + depth)
    out = np.empty(n)
    t = 0.0
    for i in range(n):
        while True:
            t += rng.exponential(1.0 / lam_max)
            lam = rate * (1.0 + depth * np.sin(2 * np.pi * t / period))
            if rng.random() * lam_max <= lam:
                break
        out[i] = t
    return out


ARRIVAL_PROCESSES = {
    "poisson": poisson_arrivals,
    "bursty": bursty_arrivals,
    "diurnal": diurnal_arrivals,
}


def make_arrivals(n: int, rate: float, process: str = "poisson",
                  rng: Optional[np.random.Generator] = None, seed: int = 0,
                  **kw) -> np.ndarray:
    """Arrival clock for ``n`` requests at mean ``rate`` req/s under a
    named process (``rate <= 0``: everything arrives at t=0)."""
    if process not in ARRIVAL_PROCESSES:
        raise ValueError(f"unknown arrival process {process!r}; one of "
                         f"{sorted(ARRIVAL_PROCESSES)}")
    if rng is None:
        rng = np.random.default_rng(seed)
    return ARRIVAL_PROCESSES[process](n, rate, rng, **kw)


# ----------------------------------------------------------------- traces
def _scale_slo(slo: SLO, scale: float) -> SLO:
    if scale == 1.0:
        return slo
    return SLO(
        ttft=None if slo.ttft is None else slo.ttft * scale,
        tpot=None if slo.tpot is None else slo.tpot * scale,
        e2e=None if slo.e2e is None else slo.e2e * scale)


def sample_trace(n: int, profiles=None, mix: Optional[Sequence[float]] = None,
                 *, rate: float = 0.0, process: str = "poisson",
                 seed: int = 0, slo_scale: float = 1.0,
                 max_input: Optional[int] = None,
                 max_output: Optional[int] = None,
                 arrival_kw: Optional[dict] = None) -> List[Request]:
    """Replay ``n`` requests shaped like the checked-in traces.

    ``profiles`` are :class:`TraceProfile` objects or names (default:
    both paper datasets, evenly mixed per ``mix``); lengths come from
    their histograms, SLOs from their tags (scaled by ``slo_scale`` —
    tiny test engines need proportionally tighter deadlines), arrivals
    from ``process`` at mean ``rate``.  ``max_input``/``max_output``
    clip lengths for small-context executors.  Deterministic in
    ``seed``: requests come back sorted by arrival with contiguous ids.
    """
    profs = [load_trace_profile(p)
             for p in (profiles or BUILTIN_TRACES)]
    p_mix = np.asarray(mix if mix is not None
                       else [1.0 / len(profs)] * len(profs), np.float64)
    if len(p_mix) != len(profs) or p_mix.sum() <= 0:
        raise ValueError("mix must give a positive mass per profile")
    p_mix = p_mix / p_mix.sum()
    rng = np.random.default_rng(seed)
    which = rng.choice(len(profs), size=n, p=p_mix)
    arrivals = make_arrivals(n, rate, process, rng=rng,
                             **(arrival_kw or {}))
    lins = np.stack([p.input.sample(rng, n) for p in profs])
    louts = np.stack([p.output.sample(rng, n) for p in profs])
    reqs = []
    for i in range(n):
        prof = profs[which[i]]
        lin = int(lins[which[i], i])
        lout = int(louts[which[i], i])
        if max_input is not None:
            lin = min(lin, max_input)
        if max_output is not None:
            lout = min(lout, max_output)
        reqs.append(Request(
            req_id=i, task_type=prof.task_type, input_len=max(lin, 1),
            output_len=max(lout, 1), slo=_scale_slo(prof.slo, slo_scale),
            arrival_time=float(arrivals[i])))
    return reqs


def sample_trace_workload(n: int, vocab: int, profiles=None,
                          mix: Optional[Sequence[float]] = None, *,
                          rate: float = 0.0, process: str = "poisson",
                          seed: int = 0, slo_scale: float = 1.0,
                          max_input: Optional[int] = None,
                          max_output: Optional[int] = None,
                          arrival_kw: Optional[dict] = None):
    """Token-level twin of :func:`sample_trace` for engine-backed runs:
    ``[(Request, prompt_tokens)]`` — the convention
    ``Engine.run_policy`` (via ``RuntimeRequest``) and
    ``ServeLoop.submit_trace`` consume.  The request stream is
    *identical* to ``sample_trace(...)`` at the same seed; prompt token
    ids are drawn afterwards so they never perturb the shared draws.
    """
    reqs = sample_trace(n, profiles, mix, rate=rate, process=process,
                        seed=seed, slo_scale=slo_scale,
                        max_input=max_input, max_output=max_output,
                        arrival_kw=arrival_kw)
    tok_rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    return [(r, tok_rng.integers(0, vocab, r.input_len).astype(np.int32))
            for r in reqs]
