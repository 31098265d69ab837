"""Matcher and pipeline counters (copies of `MatcherStats` and
`PipelineStats` from `banjax_tpu/obs/stats.py`).

`MatcherStats` counts what the matcher's batch path did (lines, batches,
batch latency percentiles); `PipelineStats` is the streaming scheduler's
accounting (`pipeline/scheduler.py`), which the breaker's derived latency
budget reads.

The JAX package also keeps interval maxima for its 29 s metrics line and
fixed-bucket histograms for its Prometheus exposition; the port has
neither yet, so in their place it keeps the sums the chip smoke run
reports: busy seconds per pipeline stage and per encode worker, and the
recent tailer-read -> drain latencies.
"""

from __future__ import annotations

import threading
from collections import defaultdict, deque
from typing import Dict, List, Optional

_LATENCY_RING = 512  # recent batch latencies kept for the percentiles
_DEVICE_RING = 256   # recent device-stage latencies for the pipeline p99
_E2E_RING = 4096     # recent read -> drain latencies


def _pct(sorted_xs: List[float], q: float) -> Optional[float]:
    n = len(sorted_xs)
    return sorted_xs[min(n - 1, int(n * q))] if n else None


class MatcherStats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.lines_total = 0
        self.batches_total = 0
        self._latencies = [0.0] * _LATENCY_RING
        self._lat_n = 0

    def record_batch(self, n_lines: int, elapsed_s: float) -> None:
        with self._lock:
            self.lines_total += n_lines
            self.batches_total += 1
            self._latencies[self._lat_n % _LATENCY_RING] = elapsed_s
            self._lat_n += 1

    def peek(self) -> Dict[str, object]:
        """Totals and the batch-latency percentiles (the JAX keys)."""
        with self._lock:
            n = min(self._lat_n, _LATENCY_RING)
            lats = sorted(self._latencies[:n])
            p50, p99 = _pct(lats, 0.5), (lats[min(n - 1, (n * 99) // 100)] if n else None)
            return {
                "MatcherLinesTotal": self.lines_total,
                "MatcherBatchesTotal": self.batches_total,
                "MatcherBatchLatencyP50Ms": None if p50 is None else round(p50 * 1e3, 3),
                "MatcherBatchLatencyP99Ms": None if p99 is None else round(p99 * 1e3, 3),
            }


class PipelineStats:
    """Thread-safe counters of the streaming pipeline scheduler.

    The accounting invariant: after a flush, admitted_lines ==
    processed_lines + shed_lines + drain_error_lines, where
    processed_lines includes the stale_dropped_lines the drain marked
    old_line. In the port a batch that fails (its drain raised, or the
    open breaker refused it) counts in drain_error_lines: every admitted
    item is processed, shed or failed; nothing is silent.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.admitted_lines = 0
        self.processed_lines = 0
        self.shed_lines = 0         # oldest-first overload shed
        self.drain_error_lines = 0  # failed batches (drain raised or refused)
        self.stale_dropped_lines = 0  # aged past cutoff inside the pipeline
        self.batches = 0
        self.fallback_batches = 0   # drained generically via consume_lines_serial
        self.command_items = 0      # commands drained in admission order
        self.command_batches = 0
        self.probe_ok = 0
        self.probe_failed = 0
        self.max_inflight = 0       # greatest number of batches in the ring
        self._device_ring = [0.0] * _DEVICE_RING
        self._device_n = 0
        self._device_p99_ewma: Optional[float] = None
        # sharded encode fan-out (scheduler._begin_state)
        self.encode_sharded_batches = 0
        self._encode_util_ewma: Optional[float] = None
        self._worker_busy_ewma: List[float] = []
        self._shard_skew_ewma: Optional[float] = None
        # busy seconds per stage thread and per encode worker
        self.stage_seconds: Dict[str, float] = defaultdict(float)
        self.worker_seconds: List[float] = []
        # tailer read -> effector commit
        self._e2e: deque = deque(maxlen=_E2E_RING)

    def note_admitted(self, n: int) -> None:
        with self._lock:
            self.admitted_lines += n

    def note_processed(self, n: int) -> None:
        with self._lock:
            self.processed_lines += n

    def note_shed(self, n: int) -> None:
        with self._lock:
            self.shed_lines += n

    def note_drain_error(self, n: int) -> None:
        with self._lock:
            self.drain_error_lines += n

    def note_stale(self, n: int) -> None:
        with self._lock:
            self.stale_dropped_lines += n

    def note_batch(self, fallback: bool) -> None:
        with self._lock:
            self.batches += 1
            if fallback:
                self.fallback_batches += 1

    def note_commands(self, n: int) -> None:
        with self._lock:
            self.command_items += n
            self.command_batches += 1

    def note_inflight(self, n: int) -> None:
        with self._lock:
            self.max_inflight = max(self.max_inflight, n)

    def note_encode_shards(self, shard_ms: List[float], wall_ms: float) -> None:
        """One sharded encode fan-out's timing: per-shard wall times plus
        the fan-out's total wall."""
        n_shards = len(shard_ms)
        if not n_shards:
            return
        wall = max(wall_ms, 1e-9)
        mean = sum(shard_ms) / n_shards
        skew = (max(shard_ms) / mean) if mean > 0 else 1.0
        util = min(1.0, max(0.0, sum(shard_ms) / (wall * n_shards)))
        with self._lock:
            self.encode_sharded_batches += 1
            self._encode_util_ewma = (
                util if self._encode_util_ewma is None
                else self._encode_util_ewma + 0.3 * (util - self._encode_util_ewma)
            )
            self._shard_skew_ewma = (
                skew if self._shard_skew_ewma is None
                else self._shard_skew_ewma + 0.3 * (skew - self._shard_skew_ewma)
            )
            while len(self._worker_busy_ewma) < n_shards:
                self._worker_busy_ewma.append(0.0)
                self.worker_seconds.append(0.0)
            for k, ms in enumerate(shard_ms):
                frac = min(1.0, ms / wall)
                prev = self._worker_busy_ewma[k]
                self._worker_busy_ewma[k] = (
                    frac if self.encode_sharded_batches == 1
                    else prev + 0.3 * (frac - prev)
                )
                self.worker_seconds[k] += ms / 1e3

    def worker_busy_fractions(self) -> List[float]:
        """Per-shard-index EWMA busy fraction of the fan-out wall."""
        with self._lock:
            return [round(v, 3) for v in self._worker_busy_ewma]

    def note_probe(self, ok: bool) -> None:
        with self._lock:
            if ok:
                self.probe_ok += 1
            else:
                self.probe_failed += 1

    def observe_device(self, elapsed_s: float) -> None:
        """One device-stage (submit + collect) wall time; feeds the p99 the
        breaker's derived latency budget reads."""
        with self._lock:
            self._device_ring[self._device_n % _DEVICE_RING] = elapsed_s
            self._device_n += 1
            n = min(self._device_n, _DEVICE_RING)
            lats = sorted(self._device_ring[:n])
            p99 = lats[min(n - 1, (n * 99) // 100)]
            self._device_p99_ewma = (
                p99 if self._device_p99_ewma is None
                else self._device_p99_ewma + 0.2 * (p99 - self._device_p99_ewma)
            )

    def observe_stages(self, stage_ms: Dict[str, float]) -> None:
        """Per-stage wall times of one drained batch, summed per stage."""
        with self._lock:
            for stage, ms in stage_ms.items():
                self.stage_seconds[stage] += ms / 1e3

    def observe_e2e(self, seconds: float) -> None:
        """One batch's oldest tailer-read stamp -> effector commit."""
        with self._lock:
            self._e2e.append(max(0.0, seconds))

    def reset_e2e(self) -> None:
        with self._lock:
            self._e2e.clear()

    def e2e_percentiles(self) -> Dict[str, Optional[float]]:
        with self._lock:
            xs = sorted(self._e2e)
        return {"n": len(xs), "p50_s": _pct(xs, 0.5), "p99_s": _pct(xs, 0.99)}

    def suggested_latency_budget_s(self) -> float:
        """Derived breaker budget: 3x the EWMA device p99, floored at
        50 ms; 0.0 (no budget) until a p99 exists."""
        with self._lock:
            if self._device_p99_ewma is None:
                return 0.0
            return max(0.05, 3.0 * self._device_p99_ewma)

    def peek(self) -> Dict[str, object]:
        """The JAX scheduler's totals and EWMAs (its Prometheus view)."""
        with self._lock:
            return {
                "EncodeShardedBatches": self.encode_sharded_batches,
                "EncodeWorkerUtilization": (
                    None if self._encode_util_ewma is None
                    else round(self._encode_util_ewma, 3)
                ),
                "EncodeShardSkewMax": (
                    None if self._shard_skew_ewma is None
                    else round(self._shard_skew_ewma, 3)
                ),
                "PipelineAdmittedLines": self.admitted_lines,
                "PipelineProcessedLines": self.processed_lines,
                "PipelineShedLines": self.shed_lines,
                "PipelineDrainErrorLines": self.drain_error_lines,
                "PipelineStaleDroppedLines": self.stale_dropped_lines,
                "PipelineBatches": self.batches,
                "PipelineFallbackBatches": self.fallback_batches,
                "PipelineCommandItems": self.command_items,
                "PipelineCommandBatches": self.command_batches,
                "PipelineProbeFailures": self.probe_failed,
                "PipelineDeviceP99Ms": (
                    None if self._device_p99_ewma is None
                    else round(self._device_p99_ewma * 1e3, 3)
                ),
            }
