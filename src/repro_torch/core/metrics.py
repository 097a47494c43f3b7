"""Serving observability: latency percentiles, per-task SLO attainment,
and G over sliding windows — the counters an operator actually watches.

Consumes either engine result dicts ({req_id: {e2e, ttft, tpot, met}}) or
simulator ``SimResult``s; exports CSV rows compatible with the benchmark
harness format.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.simulator import SimResult
from repro_torch.core.slo import Request


@dataclasses.dataclass
class ServingReport:
    count: int
    attainment: float
    G: float
    e2e_p50: float
    e2e_p90: float
    e2e_p99: float
    ttft_p50: float
    ttft_p90: float
    tpot_p50: float
    tpot_p90: float
    per_task: Dict[str, dict]

    def rows(self, prefix: str = "serving"):
        out = [[f"{prefix}_summary", 0.0,
                f"n={self.count};att={self.attainment:.3f};G={self.G:.4f};"
                f"e2e_p50={self.e2e_p50:.3f};e2e_p99={self.e2e_p99:.3f};"
                f"ttft_p90={self.ttft_p90:.3f};tpot_p90={self.tpot_p90:.4f}"]]
        for task, d in self.per_task.items():
            out.append([f"{prefix}_{task}", 0.0,
                        f"n={d['n']};att={d['att']:.3f};"
                        f"e2e_p90={d['e2e_p90']:.3f}"])
        return out


def _pct(xs, p):
    return float(np.percentile(np.asarray(xs), p)) if len(xs) else 0.0


def report(results, requests: Optional[Sequence[Request]] = None
           ) -> ServingReport:
    """results: SimResult or engine dict."""
    if isinstance(results, SimResult):
        e2e = results.e2e
        ttft = results.ttft
        tpot = results.tpot
        met = results.met
    else:
        e2e = {k: v["e2e"] for k, v in results.items()}
        ttft = {k: v["ttft"] for k, v in results.items()}
        tpot = {k: v["tpot"] for k, v in results.items()}
        met = {k: v["met"] for k, v in results.items()}
    n = len(e2e)
    total = sum(e2e.values())
    g = sum(met.values()) / total if total else 0.0
    per_task: Dict[str, dict] = {}
    if requests:
        by_task: Dict[str, List[int]] = {}
        for r in requests:
            by_task.setdefault(r.task_type, []).append(r.req_id)
        for task, ids in by_task.items():
            ids = [i for i in ids if i in e2e]
            per_task[task] = {
                "n": len(ids),
                "att": (sum(met[i] for i in ids) / len(ids)) if ids else 0.0,
                "e2e_p90": _pct([e2e[i] for i in ids], 90),
            }
    es, ts, ps = list(e2e.values()), list(ttft.values()), list(tpot.values())
    return ServingReport(
        count=n,
        attainment=sum(met.values()) / max(n, 1),
        G=g,
        e2e_p50=_pct(es, 50), e2e_p90=_pct(es, 90), e2e_p99=_pct(es, 99),
        ttft_p50=_pct(ts, 50), ttft_p90=_pct(ts, 90),
        tpot_p50=_pct(ps, 50), tpot_p90=_pct(ps, 90),
        per_task=per_task,
    )
