"""Request / SLO data model (paper §3.1, Eqs. 5 and 7).

Two streaming task classes:
  * ``h = 1`` — e2e-latency SLO (e.g. code completion: "a code is useful
    only when completed").
  * ``h = 0`` — interactivity SLO: TTFT and TPOT (e.g. chatbots).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SLO:
    """All times in seconds. Unused fields are None ('/' in the paper)."""
    e2e: Optional[float] = None
    ttft: Optional[float] = None
    tpot: Optional[float] = None

    @property
    def h(self) -> int:
        """Eq. 5: 1 if the task prioritizes e2e latency."""
        return 1 if self.e2e is not None else 0


@dataclasses.dataclass
class Request:
    req_id: int
    task_type: str                 # e.g. "code", "chat"
    input_len: int
    slo: SLO
    # actual output length (known post-hoc; used by the simulator)
    output_len: Optional[int] = None
    # predicted output length (filled by the output-length predictor)
    predicted_output_len: Optional[int] = None
    arrival_time: float = 0.0
    # stamped by the executor (event core or engine) on *its* clock when
    # the request is submitted; SLO-budget shifting uses this so waited
    # time is never computed across two different clocks
    submit_time: Optional[float] = None
    prompt: Optional[object] = None   # raw payload for engine-backed runs
    # prompt tokens whose KV is already cached (shared-prefix reuse):
    # prefill computes only input_len - cached_prefix tokens, while
    # decode still attends the full context — every pricing layer
    # (objective, latency model, policies, event core) discounts prefill
    # by this, so cached-prefix requests rank by their true cost
    cached_prefix: int = 0

    @property
    def h(self) -> int:
        return self.slo.h

    def planning_output_len(self) -> int:
        if self.predicted_output_len is not None:
            return int(self.predicted_output_len)
        if self.output_len is not None:
            return int(self.output_len)
        raise ValueError(f"request {self.req_id} has no output length estimate")


def meets_slo(req: Request, t_e2e: float, t_ttft: float,
              t_tpot: float) -> bool:
    """Eq. 7: the x_i flag."""
    if req.h == 1:
        return t_e2e <= req.slo.e2e
    ok = True
    if req.slo.ttft is not None:
        ok &= t_ttft <= req.slo.ttft
    if req.slo.tpot is not None:
        ok &= t_tpot <= req.slo.tpot
    return bool(ok)


def as_arrays(requests) -> dict:
    """Columnar view used by the vectorized objective/annealer."""
    n = len(requests)
    big = 1e18
    return {
        "input_len": np.array([r.input_len for r in requests], np.float64),
        "output_len": np.array([r.planning_output_len() for r in requests],
                               np.float64),
        "h": np.array([r.h for r in requests], np.int32),
        "slo_e2e": np.array([r.slo.e2e if r.slo.e2e is not None else big
                             for r in requests], np.float64),
        "slo_ttft": np.array([r.slo.ttft if r.slo.ttft is not None else big
                              for r in requests], np.float64),
        "slo_tpot": np.array([r.slo.tpot if r.slo.tpot is not None else big
                              for r in requests], np.float64),
        # clipped below input_len: at least one prompt token is always
        # computed (prefill must produce true last-token logits)
        "cached_prefix": np.array(
            [min(max(int(getattr(r, "cached_prefix", 0) or 0), 0),
                 r.input_len - 1) for r in requests], np.float64),
    }
