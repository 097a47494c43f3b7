"""Async streaming serving: a long-running loop over the slot-pool
engine with arrival-timed ingestion, per-request token streams, and
overlapped host-scheduling / device-execution.  Wall-clock TTFT / TBT /
e2e are *measured* at the token-delivery boundary rather than modelled.
:class:`EngineFleet` scales the same loop data-parallel: N engines
behind one submission queue, routed by an
:class:`~repro_torch.core.policies.InstanceMapper`.
"""
from repro_torch.serving.fleet import EngineFleet
from repro_torch.serving.loop import ServeLoop, UnsupportedDisciplineError
from repro_torch.serving.metrics import (RequestTimeline,
                                         ServingMetrics, StepGauge)
from repro_torch.serving.stream import TokenEvent, TokenStream

__all__ = ["EngineFleet", "ServeLoop", "UnsupportedDisciplineError",
           "ServingMetrics", "RequestTimeline", "StepGauge", "TokenEvent",
           "TokenStream"]
