"""Runtime request state machine for the serving engine."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np

from repro_torch.core.slo import SLO, Request


class Phase(enum.Enum):
    WAITING = 0
    RUNNING = 1
    FINISHED = 2
    # holds a slot and KV blocks, but its prefill is still advancing
    # chunk-by-chunk across ticks (no sampled token yet) — excluded
    # from decode rounds and from the policies' active view
    PREFILLING = 3


@dataclasses.dataclass
class RuntimeRequest:
    """A request being executed by the engine."""
    request: Request
    prompt_tokens: np.ndarray            # [l_in] int32
    max_new_tokens: int
    phase: Phase = Phase.WAITING
    slot: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    submit_time: float = 0.0
    ttft_time: Optional[float] = None
    finish_time: Optional[float] = None
    preemptions: int = 0                 # times evicted (KV recomputed)
    # prompt tokens served from the prefix cache at the last prefill
    # (aliased pages — skipped, not computed); 0 without a prefix hit
    cached_tokens: int = 0
    # block reservation made at admission, consumed by the next prefill
    # (engine-internal; None outside the admit -> prefill window)
    block_ids: Optional[List[int]] = None
    # context positions already computed of an in-progress prefill
    # (starts at the cached-prefix length; meaningful while PREFILLING)
    prefill_pos: int = 0

    @property
    def req_id(self) -> int:
        return self.request.req_id

    @property
    def input_len(self) -> int:
        return len(self.prompt_tokens)

    def metrics(self):
        """(e2e, ttft, tpot) in seconds relative to submit."""
        e2e = (self.finish_time or 0.0) - self.submit_time
        ttft = (self.ttft_time or 0.0) - self.submit_time
        ngen = max(len(self.generated), 1)
        tpot = (e2e - ttft) / ngen
        return e2e, ttft, tpot
