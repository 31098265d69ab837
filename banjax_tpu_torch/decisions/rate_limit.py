"""Fixed-window result types and the unbounded failed-challenge states
(copies from `banjax_tpu/decisions/rate_limit.py`). The regex rate-limit
window counters live on the device in `banjax_tpu_torch/matcher/
windows.py`; the failed-challenge counters stay on the host (request
path, low volume), bounded by `challenge/failures.py` when
`challenge_failure_state_max` is set."""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Dict


class RateLimitMatchType(enum.IntEnum):
    FIRST_TIME = 0
    OUTSIDE_INTERVAL = 1
    INSIDE_INTERVAL = 2

    def __str__(self) -> str:
        return {
            RateLimitMatchType.FIRST_TIME: "FirstTime",
            RateLimitMatchType.OUTSIDE_INTERVAL: "OutsideInterval",
            RateLimitMatchType.INSIDE_INTERVAL: "InsideInterval",
        }[self]


@dataclasses.dataclass
class RateLimitResult:
    match_type: RateLimitMatchType = RateLimitMatchType.FIRST_TIME
    exceeded: bool = False


@dataclasses.dataclass
class NumHitsAndIntervalStart:
    num_hits: int
    interval_start_time_ns: int


class FailedChallengeRateLimitStates:
    """ip → (num_hits, interval_start) keyed by wall clock —
    rate_limit.go:106-163."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._states: Dict[str, NumHitsAndIntervalStart] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._states)

    def apply(self, ip: str, config) -> RateLimitResult:
        """Port of FailedChallengeRateLimitStates.Apply (rate_limit.go:125-156):
        the window restarts when `now - start > interval` (strictly), and
        an exceed resets the count to 0, not 1 (a reference quirk)."""
        result = RateLimitResult()
        timestamp_ns = time.time_ns()
        interval_ns = config.too_many_failed_challenges_interval_seconds * 1_000_000_000
        with self._lock:
            state = self._states.get(ip)
            if state is not None:
                if timestamp_ns - state.interval_start_time_ns > interval_ns:
                    result.match_type = RateLimitMatchType.OUTSIDE_INTERVAL
                    state.num_hits = 1
                    state.interval_start_time_ns = timestamp_ns
                else:
                    result.match_type = RateLimitMatchType.INSIDE_INTERVAL
                    state.num_hits += 1
            else:
                result.match_type = RateLimitMatchType.FIRST_TIME
                state = NumHitsAndIntervalStart(1, timestamp_ns)
                self._states[ip] = state

            if state.num_hits > config.too_many_failed_challenges_threshold:
                state.num_hits = 0
                result.exceeded = True
            else:
                result.exceeded = False

        return result

    def format_states(self) -> str:
        with self._lock:
            return "".join(
                f"{ip},: interval_start: {s.interval_start_time_ns}, num hits: {s.num_hits}\n"
                for ip, s in self._states.items()
            )
