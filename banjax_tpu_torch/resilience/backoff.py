"""Capped exponential backoff with jitter (a copy of
`banjax_tpu/resilience/backoff.py`).

Replaces the fixed `RETRY_SECONDS`/`RECONNECT_SECONDS` sleeps of the
ingest loops (kafka.go:169 / regex_rate_limiter.go:47 retried on a flat
5 s clock): a dead broker shared by a fleet of banjax edges would get a
synchronized reconnect stampede every 5 s, and a transient blip would
still wait the full period.  Delays grow `base * factor**attempt` up to
`cap`, each multiplied by a jitter factor drawn uniformly from
`[1 - jitter, 1]`, and `reset()` returns to `base` after sustained
success.

Both the RNG and the sleep are injectable so fault tests can count exact
intervals without real sleeping.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Optional


def reconnect_backoff(
    cap: float = 30.0,
    base: float = 0.5,
    rng: Optional[random.Random] = None,
    sleep: Optional[Callable[[float], bool]] = None,
) -> "Backoff":
    """The ONE reconnect policy every retry loop shares — kafka reader/
    writer, log tailer, fabric peer sockets.  Half-jittered exponential
    from `base` to `cap`; callers tune only the cap (how stale a dead
    endpoint may go) so a fleet never synchronizes its reconnects the
    way the reference's flat 5 s clocks (kafka.go:169,
    regex_rate_limiter.go:47) would."""
    return Backoff(base=base, cap=cap, factor=2.0, jitter=0.5,
                   rng=rng, sleep=sleep)


class Backoff:
    """Per-loop backoff state (not thread-safe across loops: each
    reconnect loop owns its own instance)."""

    def __init__(
        self,
        base: float = 0.5,
        cap: float = 30.0,
        factor: float = 2.0,
        jitter: float = 0.5,
        rng: Optional[random.Random] = None,
        sleep: Optional[Callable[[float], bool]] = None,
    ):
        if base <= 0 or cap < base or factor < 1 or not 0 <= jitter < 1:
            raise ValueError(
                f"bad backoff parameters base={base} cap={cap} "
                f"factor={factor} jitter={jitter}"
            )
        self.base = base
        self.cap = cap
        self.factor = factor
        self.jitter = jitter
        self._rng = rng or random.Random()
        self._sleep = sleep  # tests: records the delay, returns stop flag
        self.attempt = 0

    def next_delay(self) -> float:
        """The next jittered delay; advances the attempt counter."""
        raw = min(self.cap, self.base * (self.factor ** self.attempt))
        self.attempt += 1
        if self.jitter:
            raw *= 1.0 - self.jitter * self._rng.random()
        return raw

    def reset(self) -> None:
        self.attempt = 0

    def wait(self, stop: threading.Event) -> bool:
        """Sleep the next delay; True means `stop` fired (caller exits).
        An injected `sleep` callable replaces the event wait (but an
        already-set stop still short-circuits, so shutdown never burns an
        attempt or a fake sleep)."""
        if stop.is_set():
            return True
        delay = self.next_delay()
        if self._sleep is not None:
            return bool(self._sleep(delay)) or stop.is_set()
        return stop.wait(delay)
