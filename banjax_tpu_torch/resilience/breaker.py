"""Circuit breaker around the matcher's device batch path (a copy of
`banjax_tpu/resilience/breaker.py`'s `CircuitBreaker`).

States: CLOSED (device path runs), OPEN (every batch is refused),
HALF_OPEN (one probe batch is allowed through the device path; success
closes the breaker, failure re-opens it).

Trips after `failure_threshold` consecutive failures — a device dispatch
raising, or a batch breaching the latency budget.  The clock is
injectable for deterministic recovery tests.  Where the JAX matcher
reruns a batch the open breaker refuses on its host reference matcher,
the port refuses it (`TorchMatcher` raises `BreakerOpen` and counts it):
nothing moves from the card to the host.

Optionally (`window_size > 0`) a rolling failure-rate window runs
alongside the consecutive counter: the breaker also trips when
`failure_threshold` failures land within the last `window_size`
recorded outcomes, even when successes are interleaved.  The window
clears on every trip so a recovered breaker starts from a clean history.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    """Thread-safe; `allow()` + `record_success()`/`record_failure()`
    bracket each protected call."""

    def __init__(
        self,
        failure_threshold: int = 3,
        recovery_seconds: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        name: str = "",
        on_trip: Optional[Callable[[str], None]] = None,
        window_size: int = 0,
    ):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got {failure_threshold}")
        if window_size < 0:
            raise ValueError(f"window_size must be >= 0, got {window_size}")
        self.failure_threshold = failure_threshold
        self.recovery_seconds = recovery_seconds
        self.window_size = window_size
        self.name = name
        self._clock = clock
        self._on_trip = on_trip
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        # rolling outcome window (True = failure); None when disabled
        self._window: Optional[deque] = (
            deque(maxlen=window_size) if window_size > 0 else None
        )
        self._opened_at = 0.0
        self._probe_in_flight = False
        self.trip_count = 0
        # cumulative seconds spent OPEN (closed intervals only; the
        # current open stretch is added at read time)
        self._open_seconds_accum = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def open_seconds_total(self) -> float:
        """Cumulative wall seconds the breaker has been OPEN, including
        the in-progress stretch — monotone, safe for windowed deltas."""
        with self._lock:
            total = self._open_seconds_accum
            if self._state == OPEN:
                total += max(0.0, self._clock() - self._opened_at)
            return total

    def allow(self) -> bool:
        """True: caller may take the protected (device) path. False:
        the caller refuses the batch."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.recovery_seconds:
                    self._open_seconds_accum += max(
                        0.0, self._clock() - self._opened_at
                    )
                    self._state = HALF_OPEN
                    self._probe_in_flight = True
                    return True
                return False
            # HALF_OPEN: exactly one probe at a time
            if not self._probe_in_flight:
                self._probe_in_flight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state == OPEN:
                # a straggler success landing while OPEN closes the
                # breaker; bank the open stretch before leaving the state
                self._open_seconds_accum += max(
                    0.0, self._clock() - self._opened_at
                )
            self._failures = 0
            self._probe_in_flight = False
            self._state = CLOSED
            if self._window is not None:
                self._window.append(False)

    def record_failure(self) -> None:
        tripped = False
        with self._lock:
            self._probe_in_flight = False
            if self._state == HALF_OPEN:
                self._state = OPEN
                self._opened_at = self._clock()
                self.trip_count += 1
                tripped = True
            else:
                self._failures += 1
                if self._window is not None:
                    self._window.append(True)
                window_failures = (
                    sum(self._window) if self._window is not None else 0
                )
                if self._state == CLOSED and (
                    self._failures >= self.failure_threshold
                    or window_failures >= self.failure_threshold
                ):
                    self._state = OPEN
                    self._opened_at = self._clock()
                    self.trip_count += 1
                    tripped = True
            if tripped and self._window is not None:
                self._window.clear()
        if tripped and self._on_trip is not None:
            self._on_trip(self.name)
