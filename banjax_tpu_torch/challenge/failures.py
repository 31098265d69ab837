"""Bounded failed-challenge state: LRU exact tier + sketch-gated spill.

The reference's FailedChallengeRateLimitStates (decisions/rate_limit.py)
is an unbounded per-IP dict — under a challenge storm every first-time
visitor to a BLOCK-mode challenge creates an entry, so 1M+ distinct
challengers exhaust the host.  This class keeps the reference's exact
fixed-window transition semantics (the strictly-greater window restart
and the exceed-resets-to-0 quirk, rate_limit.go:125-156) while bounding
memory with the JAX package's mega-state tiering discipline:

  * **exact tier** — an LRU-ordered dict of at most ``max_entries``
    per-IP (num_hits, interval_start) states; every apply() on a held
    entry is bit-identical to the reference.
  * **spill tier** — a fixed-size open-addressed fingerprint table
    (numpy, one slot per fingerprint): an evicted entry's exact
    (hits, start) pair parks here and refills losslessly on the IP's
    next failure.  A slot collision keeps the entry with more hits
    (ties: the fresher window) and counts the loser in ``spill_drops``
    — bounded memory, never silent.
  * **sketch gate** — the traffic sketch's count-min discipline (same hash family:
    obs/sketch.hash_ip + fmix32 rows), conservatively counting failure
    events per IP over a rotating two-epoch window: an evictee spills
    only when the sketch says it has shown repeat pressure (estimate
    >= 2) or its exact hits already prove it.  One-shot churners — the
    1M-flood's whole population — never touch the spill table, so the
    few repeat offenders' parked state survives the flood.

Divergence from the unbounded oracle is possible only for an IP whose
state was evicted AND spill-dropped AND who then returns in-window —
every step of which is counted.  Dropped state always *under*-counts
(the IP restarts fresh, exactly like a new oracle IP), so a drop can
delay a ban, never conjure one out of a benign client within the
oracle's window.

A copy of `banjax_tpu/challenge/failures.py`: an eviction storm notifies
the flight recorder once per sketch epoch (`challenge-failure-storm`).
With no `now_ns_fn` the clock is read as `time.time_ns()` at each call,
so a caller can pin it.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np

from banjax_tpu_torch.challenge import stats as challenge_stats
from banjax_tpu_torch.decisions.rate_limit import (
    FailedChallengeRateLimitStates,
    NumHitsAndIntervalStart,
    RateLimitMatchType,
    RateLimitResult,
)
from banjax_tpu_torch.obs import flightrec
from banjax_tpu_torch.obs.sketch import _CM_SEEDS, _fmix32_np, hash_ip

_NS = 1_000_000_000


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class BoundedFailedChallengeStates:
    """Drop-in for FailedChallengeRateLimitStates (same apply/__len__/
    format_states surface) with bounded per-client memory."""

    def __init__(
        self,
        max_entries: int,
        *,
        spill_factor: int = 2,
        sketch_depth: int = 4,
        sketch_width: int = 0,
        now_ns_fn: Optional[Callable[[], int]] = None,
    ) -> None:
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self._max = int(max_entries)
        self._now_ns = now_ns_fn or (lambda: time.time_ns())
        self._lock = threading.Lock()
        self._states: "OrderedDict[str, NumHitsAndIntervalStart]" = OrderedDict()

        # spill tier: fingerprint-keyed single-slot table of exact
        # (hits, interval_start) pairs; fp 0 = empty
        size = _pow2(max(1024, spill_factor * self._max))
        self._sp_mask = size - 1
        self._sp_fp = np.zeros(size, dtype=np.uint64)
        self._sp_hits = np.zeros(size, dtype=np.int32)
        self._sp_start = np.zeros(size, dtype=np.int64)

        # count-min over failure events, two rotating epochs so any
        # reference window (whose start is per-IP) is covered by
        # current + previous
        self._cm_depth = max(1, min(int(sketch_depth), len(_CM_SEEDS)))
        width = int(sketch_width) or _pow2(max(1024, 4 * self._max))
        self._cm_width = _pow2(width)
        self._cm_cur = np.zeros((self._cm_depth, self._cm_width), np.int32)
        self._cm_prev = np.zeros_like(self._cm_cur)
        self._cm_epoch_start_ns = 0

        self.evictions_total = 0
        self.spill_writes = 0
        self.spill_refills = 0
        self.spill_drops = 0       # collision losses — the only lossy step
        self.gate_skips = 0        # one-shot evictees the sketch kept out
        self.stale_drops = 0       # evictees whose window had already passed
        self._notified_epoch = -1  # the sketch epoch of the last storm notice

    # ---- hashing ----

    def _fingerprint(self, ip: str) -> int:
        h = np.uint32(hash_ip(ip))
        hi = int(_fmix32_np(np.asarray([h], np.uint32))[0])
        lo = int(_fmix32_np(np.asarray([h ^ np.uint32(_CM_SEEDS[1])],
                                       np.uint32))[0])
        return ((hi << 32) | lo) | 1  # never 0 (the empty-slot marker)

    def _cm_cols(self, ip: str) -> np.ndarray:
        base = np.full(self._cm_depth, hash_ip(ip), np.uint32)
        seeds = np.asarray(_CM_SEEDS[: self._cm_depth], np.uint32)
        return (_fmix32_np(base ^ seeds) & np.uint32(self._cm_width - 1)).astype(
            np.int64
        )

    # ---- sketch (caller holds the lock) ----

    def _cm_tick(self, now_ns: int, interval_ns: int) -> None:
        epoch_ns = max(1, interval_ns)
        if now_ns - self._cm_epoch_start_ns > epoch_ns:
            self._cm_prev, self._cm_cur = self._cm_cur, self._cm_prev
            self._cm_cur[:] = 0
            self._cm_epoch_start_ns = now_ns

    def _cm_add(self, ip: str) -> None:
        cols = self._cm_cols(ip)
        rows = np.arange(self._cm_depth)
        counts = self._cm_cur[rows, cols]
        # conservative update: only the min buckets advance, so the
        # estimate (min over rows, cur + prev) never undercounts and
        # rarely overcounts
        m = counts.min()
        self._cm_cur[rows[counts == m], cols[counts == m]] = m + 1

    def _cm_estimate(self, ip: str) -> int:
        cols = self._cm_cols(ip)
        rows = np.arange(self._cm_depth)
        return int(
            (self._cm_cur[rows, cols] + self._cm_prev[rows, cols]).min()
        )

    # ---- spill tier (caller holds the lock) ----

    def _spill_take(self, ip: str) -> Optional[NumHitsAndIntervalStart]:
        fp = self._fingerprint(ip)
        slot = (fp >> 17) & self._sp_mask
        if int(self._sp_fp[slot]) != fp:
            return None
        state = NumHitsAndIntervalStart(
            int(self._sp_hits[slot]), int(self._sp_start[slot])
        )
        self._sp_fp[slot] = 0
        self.spill_refills += 1
        return state

    def _spill_put(self, ip: str, state: NumHitsAndIntervalStart) -> None:
        fp = self._fingerprint(ip)
        slot = (fp >> 17) & self._sp_mask
        occupied = int(self._sp_fp[slot]) not in (0, fp)
        if occupied:
            # keep whichever entry carries more evidence: more hits,
            # ties broken toward the fresher window
            held = (int(self._sp_hits[slot]), int(self._sp_start[slot]))
            cand = (state.num_hits, state.interval_start_time_ns)
            if held >= cand:
                self.spill_drops += 1
                return
            self.spill_drops += 1  # the displaced entry is the loss
        self._sp_fp[slot] = np.uint64(fp)
        self._sp_hits[slot] = np.int32(state.num_hits)
        self._sp_start[slot] = np.int64(state.interval_start_time_ns)
        self.spill_writes += 1

    # ---- eviction (caller holds the lock) ----

    def _evict_one(self, now_ns: int, interval_ns: int) -> None:
        ip, state = self._states.popitem(last=False)
        self.evictions_total += 1
        if now_ns - state.interval_start_time_ns > interval_ns:
            self.stale_drops += 1  # window already over: nothing to keep
        elif state.num_hits >= 2 or self._cm_estimate(ip) >= 2:
            self._spill_put(ip, state)
        else:
            self.gate_skips += 1  # one-shot churner: sketch remembers it
        # one storm notice a sketch epoch (the recorder debounces further)
        epoch = self._cm_epoch_start_ns
        if self._notified_epoch != epoch:
            self._notified_epoch = epoch
            flightrec.notify(
                "challenge-failure-storm",
                f"evictions={self.evictions_total} entries={len(self._states)} max={self._max}",
            )

    # ---- the reference surface ----

    def __len__(self) -> int:
        with self._lock:
            return len(self._states)

    def apply(self, ip: str, config) -> RateLimitResult:
        """Reference transitions (rate_limit.go:125-156) over the exact
        tier, with spill refill on re-entry and LRU eviction past the
        bound."""
        result = RateLimitResult()
        timestamp_ns = self._now_ns()
        interval_ns = (
            config.too_many_failed_challenges_interval_seconds * _NS
        )
        with self._lock:
            self._cm_tick(timestamp_ns, interval_ns)
            self._cm_add(ip)
            state = self._states.get(ip)
            if state is not None:
                self._states.move_to_end(ip)
            else:
                state = self._spill_take(ip)
                if state is not None:
                    self._states[ip] = state
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
                state.num_hits = 0  # same reference quirk: reset to 0
                result.exceeded = True
            else:
                result.exceeded = False

            while len(self._states) > self._max:
                self._evict_one(timestamp_ns, interval_ns)

            entries = len(self._states)
            evictions = self.evictions_total
        challenge_stats.get_stats().note_failure_state(entries, evictions)
        return result

    def format_states(self) -> str:
        with self._lock:
            return "".join(
                f"{ip},: interval_start: {s.interval_start_time_ns}, "
                f"num hits: {s.num_hits}\n"
                for ip, s in self._states.items()
            )

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "entries": len(self._states),
                "evictions_total": self.evictions_total,
                "spill_writes": self.spill_writes,
                "spill_refills": self.spill_refills,
                "spill_drops": self.spill_drops,
                "gate_skips": self.gate_skips,
                "stale_drops": self.stale_drops,
            }


def make_failed_challenge_states(config):
    """Bounded when challenge_failure_state_max is set, the reference's
    unbounded dict otherwise."""
    if config.challenge_failure_state_max > 0:
        return BoundedFailedChallengeStates(config.challenge_failure_state_max)
    return FailedChallengeRateLimitStates()
