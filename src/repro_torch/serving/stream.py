"""Per-request token streams with wall-clock timestamps.

A :class:`TokenStream` is the serving loop's delivery channel for one
request: every generated token is pushed as a :class:`TokenEvent`
stamped with the wall clock at delivery, so TTFT / time-between-tokens
/ e2e are *measured* quantities — what a streaming client would see —
rather than modelled ones.  Consumers can attach a callback
(``on_token``), iterate the stream (a blocking iterator backed by a
queue, safe to drain from another thread), or read the accumulated
events after the fact.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, List, NamedTuple, Optional


class TokenEvent(NamedTuple):
    """One delivered token: id, wall-clock delivery time (seconds on the
    serving loop's clock), and its 0-based position in the output."""
    token: int
    t: float
    index: int


_SENTINEL = object()


class TokenStream:
    """Token delivery channel for one request.

    States: open -> closed (finished) | failed (rejected/errored).
    ``push``/``close``/``fail`` are called by the serving loop; all
    reader APIs are safe from other threads.
    """

    def __init__(self, req_id: int,
                 on_token: Optional[Callable[[TokenEvent], None]] = None):
        self.req_id = req_id
        self.submit_time: Optional[float] = None   # stamped at ingestion
        self._events: List[TokenEvent] = []
        self._on_token = on_token
        self._q: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._done = False
        self._error: Optional[str] = None
        self.close_time: Optional[float] = None

    # ------------------------------------------------------------ writer
    def push(self, token: int, t: float):
        with self._lock:
            if self._done:
                raise RuntimeError(f"stream {self.req_id} is closed")
            ev = TokenEvent(int(token), float(t), len(self._events))
            self._events.append(ev)
        self._q.put(ev)
        if self._on_token is not None:
            self._on_token(ev)

    def close(self, t: float):
        with self._lock:
            self._done = True
            self.close_time = float(t)
        self._q.put(_SENTINEL)

    def fail(self, reason: str, t: float):
        with self._lock:
            self._done = True
            self._error = reason
            self.close_time = float(t)
        self._q.put(_SENTINEL)

    # ------------------------------------------------------------ reader
    def __iter__(self):
        """Blocking iterator over events (cross-thread safe): yields
        every :class:`TokenEvent` until the stream closes."""
        replayed = 0
        while True:
            with self._lock:
                if replayed < len(self._events):
                    ev = self._events[replayed]
                    replayed += 1
                    yielded = True
                else:
                    yielded = False
                    if self._done:
                        return
            if yielded:
                yield ev
                continue
            item = self._q.get()
            if item is _SENTINEL:
                return
            # the queue may replay events already yielded from the
            # backlog above — skip those
            if item.index >= replayed:
                replayed = item.index + 1
                yield item

    @property
    def events(self) -> List[TokenEvent]:
        with self._lock:
            return list(self._events)

    @property
    def tokens(self) -> List[int]:
        return [ev.token for ev in self.events]

    @property
    def done(self) -> bool:
        return self._done

    @property
    def error(self) -> Optional[str]:
        return self._error

    # --------------------------------------------------- measured metrics
    def ttft(self) -> Optional[float]:
        """Wall-clock time to first token, from submission."""
        evs = self.events
        if not evs or self.submit_time is None:
            return None
        return evs[0].t - self.submit_time

    def tbts(self) -> List[float]:
        """Wall-clock gaps between consecutive token deliveries."""
        evs = self.events
        return [b.t - a.t for a, b in zip(evs, evs[1:])]

    def e2e(self) -> Optional[float]:
        """Submission -> last token delivery (wall clock)."""
        evs = self.events
        if not evs or self.submit_time is None:
            return None
        return evs[-1].t - self.submit_time
