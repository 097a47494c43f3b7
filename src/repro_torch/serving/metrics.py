"""Serving observability for the streaming loop: measured per-request
timelines, per-step gauges, and wall-clock SLO/goodput summaries.

Everything here is *measured* on the serving loop's wall clock — TTFT is
the delivery time of the first streamed token, TBT the gaps between
deliveries — as opposed to :mod:`repro_torch.core.metrics`, which summarizes
modelled/engine-clock results after a batch run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.slo import Request, meets_slo


@dataclasses.dataclass
class RequestTimeline:
    """Measured wall-clock record of one served request."""
    req_id: int
    task_type: str
    arrival: float              # requested arrival (trace time)
    submit: float               # ingestion into the waiting queue
    first_token: Optional[float]   # wall clock of first delivery
    finish: Optional[float]        # wall clock of last delivery
    n_tokens: int
    tbt: List[float]            # gaps between consecutive deliveries
    preemptions: int = 0
    cached_tokens: int = 0
    rejected: bool = False

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token is None:
            return None
        return self.first_token - self.submit

    @property
    def e2e(self) -> Optional[float]:
        if self.finish is None:
            return None
        return self.finish - self.submit

    @property
    def tpot(self) -> Optional[float]:
        """(e2e - ttft) / n_tokens — the engine's accounting definition,
        so wall-clock attainment is judged on the same quantity."""
        if self.finish is None or self.first_token is None:
            return None
        return (self.finish - self.first_token) / max(self.n_tokens, 1)


@dataclasses.dataclass
class StepGauge:
    """Loop-state sample taken once per serving tick."""
    t: float
    queue_depth: int            # requests waiting for admission
    active: int                 # occupied slots
    free_blocks: int            # KV pool occupancy (-1: unpaged)
    dispatch_width: int         # pow-2 batch bucket of the tick (0: idle)
    overlapped: bool            # a step was in flight during this tick
    prefill_tokens: int = 0     # prompt tokens computed this tick (plan)
    prefilling: int = 0         # slots mid-prefill after this tick

    @property
    def mixed(self) -> bool:
        """The tick carried prefill work AND dispatched decodes — the
        chunk-as-tick batch composition."""
        return self.prefill_tokens > 0 and self.dispatch_width > 0


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if len(xs) else 0.0


class ServingMetrics:
    """Sink the :class:`~repro_torch.serving.loop.ServeLoop` feeds.

    Collects per-request :class:`RequestTimeline`\\ s (from the token
    streams' delivery timestamps), per-step :class:`StepGauge` samples,
    and SLO-attainment bookkeeping; ``summary()`` reduces them to the
    numbers a load test reports."""

    def __init__(self):
        self.timelines: Dict[int, RequestTimeline] = {}
        self.gauges: List[StepGauge] = []
        self._met: Dict[int, bool] = {}

    # ------------------------------------------------------------- feeds
    def on_finish(self, req: Request, tl: RequestTimeline):
        self.timelines[tl.req_id] = tl
        if not tl.rejected and tl.e2e is not None:
            self._met[tl.req_id] = meets_slo(
                req, tl.e2e, tl.ttft if tl.ttft is not None else 0.0,
                tl.tpot if tl.tpot is not None else 0.0)
        else:
            self._met[tl.req_id] = False

    def on_gauge(self, g: StepGauge):
        self.gauges.append(g)

    @classmethod
    def aggregate(cls, parts: "List[ServingMetrics]") -> "ServingMetrics":
        """Fleet-wide view: merge per-loop sinks into one.  Request ids
        are disjoint across fleet members (``ServeLoop(id_base=...)``),
        so timelines/attainment merge by union; gauges interleave by
        tick time.  ``summary()`` on the result reports fleet
        attainment/goodput over every request and sums token
        throughput."""
        out = cls()
        for p in parts:
            out.timelines.update(p.timelines)
            out._met.update(p._met)
            out.gauges.extend(p.gauges)
        out.gauges.sort(key=lambda g: g.t)
        return out

    # ----------------------------------------------------------- reports
    def met(self, req_id: int) -> bool:
        return self._met.get(req_id, False)

    def summary(self) -> Dict[str, float]:
        done = [tl for tl in self.timelines.values() if not tl.rejected
                and tl.finish is not None]
        rejected = sum(tl.rejected for tl in self.timelines.values())
        ttfts = [tl.ttft for tl in done if tl.ttft is not None]
        tbts = [g for tl in done for g in tl.tbt]
        e2es = [tl.e2e for tl in done]
        n_tokens = sum(tl.n_tokens for tl in done)
        met = sum(self._met.get(tl.req_id, False) for tl in done)
        wall = max((tl.finish for tl in done), default=0.0)
        out = {
            "n": len(done),
            "rejected": rejected,
            "attainment": met / len(done) if done else 0.0,
            # Eq. 2 goodput on measured e2e: met count per unit latency
            "G": met / sum(e2es) if e2es and sum(e2es) > 0 else 0.0,
            "tokens": n_tokens,
            "tokens_per_s": n_tokens / wall if wall > 0 else 0.0,
            "ttft_mean": float(np.mean(ttfts)) if ttfts else 0.0,
            "ttft_p90": _pct(ttfts, 90),
            "tbt_mean": float(np.mean(tbts)) if tbts else 0.0,
            "tbt_p50": _pct(tbts, 50),
            "tbt_p90": _pct(tbts, 90),
            "e2e_mean": float(np.mean(e2es)) if e2es else 0.0,
            "preemptions": sum(tl.preemptions for tl in done),
        }
        if self.gauges:
            out["queue_depth_mean"] = float(
                np.mean([g.queue_depth for g in self.gauges]))
            out["queue_depth_max"] = max(g.queue_depth for g in self.gauges)
            out["occupancy_mean"] = float(
                np.mean([g.active for g in self.gauges]))
            out["overlap_frac"] = float(
                np.mean([g.overlapped for g in self.gauges]))
            out["prefill_tokens"] = sum(
                g.prefill_tokens for g in self.gauges)
            # fraction of ticks mixing prefill spans with decode
            # dispatch — 0.0 under StallingPrefill unless a prefill
            # shares its tick with an in-flight decode's delivery
            out["mixed_tick_frac"] = float(
                np.mean([g.mixed for g in self.gauges]))
        return out

    def rows(self, prefix: str = "serve"):
        """Benchmark-harness rows (``name, us_per_call, derived``)."""
        s = self.summary()
        derived = (f"att={s['attainment']:.3f};G={s['G']:.4f};"
                   f"n={s['n']};tok={s['tokens']};"
                   f"ttft_mean={s['ttft_mean']:.4f};"
                   f"tbt_mean={s['tbt_mean']:.5f};"
                   f"tbt_p90={s['tbt_p90']:.5f};"
                   f"tok_s={s['tokens_per_s']:.1f}")
        return [[f"{prefix}_summary", round(s["e2e_mean"] * 1e6, 1),
                 derived]]
