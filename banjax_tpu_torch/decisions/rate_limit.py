"""Fixed-window result types and the host states (copies from
`banjax_tpu/decisions/rate_limit.py`). The regex rate-limit window
counters live on the device in `banjax_tpu_torch/matcher/windows.py` when
`matcher_device_windows` is on; otherwise they are `RegexRateLimitStates`
here, stepped on the host by `CpuMatcher` (`matcher: cpu`) and by
`TorchMatcher`'s host windows. The failed-challenge counters stay on the
host (request path, low volume), bounded by `challenge/failures.py` when
`challenge_failure_state_max` is set.

Both windows follow the reference (rate_limit.go): the window restarts
when `timestamp - start > interval` (strictly, in nanoseconds), and an
exceed resets the hit count to 0, not 1 (the reference's own "XXX should
it be 1?" at rate_limit.go:71)."""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Dict, Tuple


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


class RegexRateLimitStates:
    """ip -> rule name -> (num_hits, interval_start) — rate_limit.go:18-103.
    Timestamps are integer nanoseconds, as Go compares time.Time."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._states: Dict[str, Dict[str, NumHitsAndIntervalStart]] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._states)

    def apply(self, ip: str, rule, timestamp_ns: int) -> Tuple[bool, RateLimitResult]:
        """Port of RegexRateLimitStates.Apply (rate_limit.go:37-78): step
        `rule`'s window (a RegexWithRate) for `ip`; returns (seen_ip,
        result), seen_ip False for an IP with no state yet."""
        result = RateLimitResult()
        with self._lock:
            states = self._states.get(ip)
            if states is None:
                seen_ip = False
                state = NumHitsAndIntervalStart(1, timestamp_ns)
                self._states[ip] = {rule.rule: state}
            else:
                seen_ip = True
                state = states.get(rule.rule)
                if state is not None:
                    if timestamp_ns - state.interval_start_time_ns > rule.interval_ns:
                        result.match_type = RateLimitMatchType.OUTSIDE_INTERVAL
                        state.num_hits = 1
                        state.interval_start_time_ns = timestamp_ns
                    else:
                        result.match_type = RateLimitMatchType.INSIDE_INTERVAL
                        state.num_hits += 1
                else:
                    result.match_type = RateLimitMatchType.FIRST_TIME
                    state = NumHitsAndIntervalStart(1, timestamp_ns)
                    states[rule.rule] = state

            if state.num_hits > rule.hits_per_interval:
                state.num_hits = 0
                result.exceeded = True
            else:
                result.exceeded = False
        return seen_ip, result

    def get(self, ip: str) -> Tuple[Dict[str, NumHitsAndIntervalStart], bool]:
        """A copy of the IP's states (rate_limit.go:81-96)."""
        with self._lock:
            states = self._states.get(ip)
            if states is None:
                return {}, False
            return {
                rule: NumHitsAndIntervalStart(s.num_hits, s.interval_start_time_ns)
                for rule, s in states.items()
            }, True

    def format_states(self) -> str:
        with self._lock:
            lines = []
            for ip, states in self._states.items():
                lines.append(f"{ip}:")
                for rule, s in states.items():
                    lines.append(f"\t{rule}:")
                    lines.append(
                        f"\t\tNumHitsAndIntervalStart({s.num_hits}, {s.interval_start_time_ns})"
                    )
                lines.append("")
            return "\n".join(lines) + ("\n" if lines else "")


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
