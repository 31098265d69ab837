"""Adaptive batch sizing for the streaming pipeline (a copy of
`banjax_tpu/pipeline/sizer.py`'s `AdaptiveBatchSizer`).

The fixed `matcher_batch_lines` knob is the wrong control for a latency
budget: the right batch size depends on the card, the ruleset width and
the traffic mix, all of which the scheduler can only observe at runtime.
AdaptiveBatchSizer picks the batch target from observed per-stage
timings instead:

  * batches are sized in power-of-two buckets;
  * per-stage (encode / device / drain) per-batch timings feed EWMAs;
    the per-batch TOTAL is compared against `pipeline_latency_budget_ms`;
  * AIMD within the buckets: comfortably under budget (below half) the
    bucket doubles, over budget it halves;
  * an efficiency guard on top of AIMD: per-bucket EWMA of ms/line is
    remembered, growth into a bucket previously measured per-line WORSE
    is blocked, and a bucket that turns out less efficient than the one
    below shrinks back even when its latency fits the budget.  Blocked
    growth is retried after `_RETRY_BLOCKED` decisions so that a stale
    measurement (one polluted by a first-visit build) cannot pin the size;
  * a bucket change resets the EWMA and requires `settle` fresh samples
    before the next move, so one noisy batch cannot oscillate the size.

Thread-safety: observe()/target() take a lock; both are called from
different pipeline stage threads.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

_STAGES = ("encode", "device", "drain")
# a bucket must be at least this much per-line worse than its lower
# neighbor before the efficiency guard acts (EWMA noise tolerance)
_EFFICIENCY_SLACK = 1.05
# decisions after which a blocked grow forgets the upper bucket's stale
# per-line record and probes again
_RETRY_BLOCKED = 50


def _pow2_at_most(n: int) -> int:
    b = 1
    while b * 2 <= n:
        b <<= 1
    return b


class AdaptiveBatchSizer:
    def __init__(
        self,
        budget_ms: float,
        min_batch: int = 64,
        max_batch: int = 16384,
        start_batch: int = 1024,
        alpha: float = 0.3,
        settle: int = 2,
        command_max: int = 1024,
    ):
        if budget_ms <= 0:
            raise ValueError(f"budget_ms must be positive, got {budget_ms}")
        if not (0 < min_batch <= max_batch):
            raise ValueError(
                f"bad batch bounds [{min_batch}, {max_batch}]"
            )
        if command_max < 1:
            raise ValueError(
                f"command_max must be >= 1, got {command_max}"
            )
        self.budget_ms = budget_ms
        self.command_max = command_max
        self.min_batch = _pow2_at_most(min_batch)
        self.max_batch = _pow2_at_most(max_batch)
        self._alpha = alpha
        self._settle = settle
        self._lock = threading.Lock()
        self._bucket = min(
            max(_pow2_at_most(start_batch), self.min_batch), self.max_batch
        )
        self._total_ewma_ms: Optional[float] = None
        self._samples_at_bucket = 0
        # efficiency guard state: last EWMA ms/line seen at each bucket,
        # and how many grow decisions the upper bucket's record has blocked
        self._per_line_at: Dict[int, float] = {}
        self._blocked_grows = 0
        # the first full batch after a bucket change pays that bucket's
        # one-time program build; learning from it would poison both the
        # latency EWMA and the per-line efficiency record
        self._skip_first = True
        # per-stage EWMA ms at the current bucket — metrics surface only;
        # the grow/shrink decision uses the total
        self.stage_ewma_ms: Dict[str, Optional[float]] = {
            s: None for s in _STAGES
        }

    def target(self) -> int:
        """Current batch-size cap for the encode stage."""
        with self._lock:
            return self._bucket

    def command_target(self) -> int:
        """Take-size bound for COMMAND batches.
        Commands bypass the device, so they produce no stage timings for
        AIMD to learn from; instead of riding the adaptive line bucket
        (which a command flood would stretch to max_batch) they get a
        fixed cap, chopping a Kafka command flood into bounded batches
        that interleave with line batches at the admission-order kind
        boundary rather than starving line batching."""
        return self.command_max

    def observe(self, n_lines: int, stage_ms: Dict[str, float]) -> None:
        """One drained batch's per-stage wall times (ms).  Batches far
        below the current bucket (a trickle, not a full batch) update the
        stage EWMAs for metrics but don't drive sizing — their latency
        says nothing about the bucket's."""
        total = float(sum(stage_ms.values()))
        with self._lock:
            for s, ms in stage_ms.items():
                prev = self.stage_ewma_ms.get(s)
                self.stage_ewma_ms[s] = (
                    ms if prev is None
                    else prev + self._alpha * (ms - prev)
                )
            if n_lines * 2 < self._bucket and total <= self.budget_ms:
                return
            if self._skip_first:
                self._skip_first = False
                return
            self._total_ewma_ms = (
                total if self._total_ewma_ms is None
                else self._total_ewma_ms
                + self._alpha * (total - self._total_ewma_ms)
            )
            per_line = total / max(1, n_lines)
            prev_pl = self._per_line_at.get(self._bucket)
            cur_pl = self._per_line_at[self._bucket] = (
                per_line if prev_pl is None
                else prev_pl + self._alpha * (per_line - prev_pl)
            )
            self._samples_at_bucket += 1
            if self._samples_at_bucket < self._settle:
                return
            ewma = self._total_ewma_ms
            lower_pl = self._per_line_at.get(self._bucket >> 1)
            upper_pl = self._per_line_at.get(self._bucket << 1)
            if ewma > self.budget_ms and self._bucket > self.min_batch:
                self._bucket >>= 1
                self._reset_locked()
            elif (
                lower_pl is not None
                and cur_pl > lower_pl * _EFFICIENCY_SLACK
                and self._bucket > self.min_batch
            ):
                # latency fits, but this bucket is per-line WORSE than the
                # one below: larger batches are not paying here — go back
                self._bucket >>= 1
                self._reset_locked()
            elif ewma < self.budget_ms * 0.5 and self._bucket < self.max_batch:
                if (
                    upper_pl is not None
                    and upper_pl > cur_pl * _EFFICIENCY_SLACK
                ):
                    # the bucket above was measured per-line worse; retry
                    # eventually in case that record is stale
                    self._blocked_grows += 1
                    if self._blocked_grows >= _RETRY_BLOCKED:
                        self._per_line_at.pop(self._bucket << 1, None)
                        self._blocked_grows = 0
                    return
                self._bucket <<= 1
                self._reset_locked()

    def _reset_locked(self) -> None:
        self._total_ewma_ms = None
        self._samples_at_bucket = 0
        self._skip_first = True

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {
                "PipelineBatchTarget": self._bucket,
                "PipelineCommandBatchTarget": self.command_max,
            }
            for s in _STAGES:
                v = self.stage_ewma_ms.get(s)
                out[f"PipelineStage{s.capitalize()}EwmaMs"] = (
                    None if v is None else round(v, 3)
                )
            return out
