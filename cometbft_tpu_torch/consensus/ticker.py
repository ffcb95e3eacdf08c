"""Timeout scheduling for consensus steps.

Behavior parity: reference internal/consensus/ticker.go — one pending
timeout at a time; scheduling a new one replaces the old (timeoutRoutine
drops stale timers for older height/round/step). Two implementations:

- TimeoutTicker: real wall-clock threading.Timer, fires into a callback.
- ManualTicker: test double — records schedules; tests fire explicitly
  (the reference's scripted state tests replace the ticker the same way).

The port's own copy of `cometbft_tpu/consensus/ticker.py`, unchanged.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class TimeoutInfo:
    duration_s: float
    height: int
    round: int
    step: int  # RoundStep value

    def _key(self):
        return (self.height, self.round, self.step)


def _newer(a: TimeoutInfo, b: TimeoutInfo) -> bool:
    """True when a is for a later (height, round, step) than b."""
    return a._key() > b._key()


class TimeoutTicker:
    def __init__(self, on_timeout):
        self._on_timeout = on_timeout
        self._lock = threading.Lock()
        self._timer: threading.Timer | None = None
        self._pending: TimeoutInfo | None = None
        self._stopped = False

    def schedule(self, ti: TimeoutInfo) -> None:
        with self._lock:
            if self._stopped:
                return
            # Ignore schedules older than the pending one (reference
            # timeoutRoutine: newti must be >= for same HRS handling).
            if self._pending is not None and _newer(self._pending, ti):
                return
            if self._timer is not None:
                self._timer.cancel()
            self._pending = ti
            self._timer = threading.Timer(ti.duration_s, self._fire, (ti,))
            self._timer.daemon = True
            self._timer.start()

    def _fire(self, ti: TimeoutInfo) -> None:
        with self._lock:
            if self._stopped or self._pending is not ti:
                return
            self._pending = None
        self._on_timeout(ti)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            if self._timer is not None:
                self._timer.cancel()


class ManualTicker:
    """Deterministic ticker for scripted tests."""

    def __init__(self, on_timeout=None):
        self._on_timeout = on_timeout
        self.scheduled: list[TimeoutInfo] = []

    def schedule(self, ti: TimeoutInfo) -> None:
        self.scheduled.append(ti)

    def fire_last(self) -> TimeoutInfo:
        ti = self.scheduled[-1]
        if self._on_timeout:
            self._on_timeout(ti)
        return ti

    def stop(self) -> None:
        pass
