"""Matcher and pipeline counters (copies of `MatcherStats` and
`PipelineStats` from `banjax_tpu/obs/stats.py`).

`MatcherStats` counts what the matcher's batch path did (lines, batches,
batch latency percentiles and histogram); `PipelineStats` is the
streaming scheduler's accounting (`pipeline/scheduler.py`), which the
breaker's derived latency budget reads. Two views, as in JAX:

  * `snapshot()`: the 29 s metrics line's view (`obs/metrics.py`), with
    the interval keys (lines/sec, eviction delta, the encode shard
    maxima), which it resets in the same lock section that reads them;
  * `peek()`: the Prometheus exposition's view (`obs/exposition.py`):
    totals and gauges only, never touching the interval state, so
    scrapes at any cadence cannot steal the line's deltas.

Neither view touches the card: they read host counters, and the traffic
sketch through its throttled `pull`. Besides the JAX counters the port
keeps the sums `chip_smoke.py` reports: busy seconds per pipeline stage
and per encode worker, and the recent tailer-read -> drain latencies.
Every key either view emits is declared in `obs/registry.py`.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

from banjax_tpu_torch.obs.registry import Histogram, StageHistograms

_LATENCY_RING = 512  # recent batch latencies kept for the percentiles
_DEVICE_RING = 256   # recent device-stage latencies for the pipeline p99
_E2E_RING = 4096     # recent read -> drain latencies


def _r3(v):
    return None if v is None else round(v, 3)


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
        self._window_lines = 0
        self._window_start = time.monotonic()
        self._last_evictions = 0
        # fixed-bucket batch latency for /metrics (the same observations
        # as the percentile ring)
        self.batch_latency_hist = Histogram()

    def record_batch(self, n_lines: int, elapsed_s: float) -> None:
        self.batch_latency_hist.observe(elapsed_s)
        with self._lock:
            self.lines_total += n_lines
            self.batches_total += 1
            self._latencies[self._lat_n % _LATENCY_RING] = elapsed_s
            self._lat_n += 1
            self._window_lines += n_lines

    def _percentiles_locked(self) -> Dict[str, object]:
        n = min(self._lat_n, _LATENCY_RING)
        lats = sorted(self._latencies[:n])
        p50, p99 = _pct(lats, 0.5), (lats[min(n - 1, (n * 99) // 100)] if n else None)
        return {
            "MatcherBatchLatencyP50Ms": None if p50 is None else round(p50 * 1e3, 3),
            "MatcherBatchLatencyP99Ms": None if p99 is None else round(p99 * 1e3, 3),
        }

    @staticmethod
    def _derived(device_windows=None, matcher=None) -> Dict[str, object]:
        """The keys read off other objects (the device windows, the fused
        pipeline, the sketch, the breaker): no stats lock, no reset, so
        both views share it."""
        out: Dict[str, object] = {}
        if device_windows is not None:
            out["DeviceWindowsOccupancy"] = device_windows.occupancy
            out["DeviceWindowsCapacity"] = device_windows.capacity
            # one read: an eviction between two reads must not be lost
            # from the next interval's delta
            out["DeviceWindowsEvictions"] = device_windows.eviction_count
            out["DeviceWindowsGrows"] = device_windows.grow_count
            out["SlotMgrNative"] = bool(device_windows.slotmgr_native)
            out["DeviceWindowsShadowedIps"] = len(device_windows)
            out["SlotRefusals"] = device_windows.slot_refusals
            out["SketchAdmissions"] = device_windows.sketch_admissions
            if device_windows._warm is not None:
                out["WarmTierSpills"] = device_windows.warm_spills
                out["WarmTierRefills"] = device_windows.warm_refills
                out["WarmTierDropped"] = device_windows.warm_dropped
                out["WarmTierOccupancy"] = device_windows.warm_occupancy
                out["WarmTierCapacity"] = device_windows.warm_capacity
        if matcher is not None:
            mm = getattr(matcher, "_mesh_matcher", None)
            if mm is not None:
                out["MeshFusedBatches"] = mm.fused_batches
                out["MeshFallbackBatches"] = mm.fallback_batches
                # sharded submit and collect: the dispatch wall time, the
                # per-row pulls and the line-order merge
                out["MeshSubmitMsEwma"] = _r3(mm.submit_ms_ewma)
                out["MeshMergeMsEwma"] = _r3(mm.merge_ms_ewma)
                shard_ms = mm.last_shard_merge_ms
                out["MeshShardMergeMsMax"] = _r3(max(shard_ms) if shard_ms else None)
            if getattr(matcher, "_prefilter", None) is not None:
                out["PrefilterActive"] = True
            fw = getattr(matcher, "_fw_pipeline", None)
            if fw is not None:
                out["PipelineFusedBatches"] = fw.fused_batches
                out["PipelineFallbackBatches"] = fw.fallback_batches
                out["PipelinedFusedChunks"] = matcher.pipelined_fused_chunks
                out["PipelinedFusedFallbacks"] = matcher.pipelined_fused_fallbacks
                out["DrainResolveAheadDepth"] = matcher.config.drain_resolve_depth
                # the wall time of the drain's event pulls and replays that
                # ran while the next chunk's program B was on the card: set
                # in two-program mode only (the single program leaves
                # nothing to overlap)
                out["DrainResolveOverlapMs"] = _r3(matcher.drain_resolve_overlap_ms_ewma)
                if fw.single_kernel:
                    out["SingleKernelChunks"] = fw.sk_chunks
                    out["SingleKernelFallbacks"] = fw.sk_fallbacks
                    # drain_resolve_depth configured but a no-op here
                    out["SingleKernelDepthIgnored"] = matcher.single_kernel_depth_ignored
            ts = getattr(matcher, "traffic_sketch", None)
            if ts is not None:
                try:
                    s = ts.pull()
                    out["TrafficSketchLines"] = ts.lines_total
                    out["TrafficDistinctIpsEst"] = s["distinct_ips_estimate"]
                    out["TrafficHeavyHitterShare"] = s["heavy_hitter_share"]
                    out["TrafficSketchPullBytes"] = ts.pull_bytes_total
                    age = ts.pull_age_seconds()
                    out["TrafficSketchPullAgeSeconds"] = None if age is None else round(age, 3)
                except Exception:  # noqa: BLE001 — telemetry must not break the metrics
                    pass
            br = getattr(matcher, "breaker", None)
            if br is not None:
                out["MatcherBreakerState"] = br.state
                out["MatcherBreakerTrips"] = br.trip_count
        return out

    def snapshot(self, device_windows=None, matcher=None) -> Dict[str, object]:
        """The 29 s line's keys; resets the interval window. The foreign
        reads happen outside the stats lock; every read-then-reset of the
        window state is one lock section."""
        derived = self._derived(device_windows, matcher)
        evictions = derived.get("DeviceWindowsEvictions")
        with self._lock:
            now = time.monotonic()
            dt = max(now - self._window_start, 1e-9)
            lps = self._window_lines / dt
            self._window_lines = 0
            self._window_start = now
            out: Dict[str, object] = {
                "MatcherLinesTotal": self.lines_total,
                "MatcherBatchesTotal": self.batches_total,
                "MatcherLinesPerSec": round(lps, 1),
                **self._percentiles_locked(),
            }
            if evictions is not None:
                out["DeviceWindowsEvictionsPerInterval"] = evictions - self._last_evictions
                self._last_evictions = evictions
        out.update(derived)
        return out

    def peek(self, device_windows=None, matcher=None) -> Dict[str, object]:
        """Totals, percentiles and derived gauges; no interval keys, no
        resets."""
        derived = self._derived(device_windows, matcher)
        with self._lock:
            out: Dict[str, object] = {
                "MatcherLinesTotal": self.lines_total,
                "MatcherBatchesTotal": self.batches_total,
                **self._percentiles_locked(),
            }
        out.update(derived)
        return out


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
        self._encode_shard_ms_max = 0.0  # interval max, reset by snapshot
        self._encode_util_ewma: Optional[float] = None
        self._worker_busy_ewma: List[float] = []
        self._shard_skew_max = 0.0       # interval max, reset by snapshot
        self._shard_skew_ewma: Optional[float] = None
        # fixed-bucket distributions for /metrics
        self.device_latency_hist = Histogram()
        self.stage_hists = StageHistograms()
        self.e2e_hists = StageHistograms()  # by hop: "local" or "fabric"
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
            self._encode_shard_ms_max = max(self._encode_shard_ms_max, max(shard_ms))
            self._shard_skew_max = max(self._shard_skew_max, skew)
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
        self.device_latency_hist.observe(elapsed_s)
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
        """Per-stage wall times of one drained batch: summed per stage, and
        into the labeled banjax_stage_duration_seconds histogram."""
        for stage, ms in stage_ms.items():
            self.stage_hists.observe(stage, ms / 1e3)
        with self._lock:
            for stage, ms in stage_ms.items():
                self.stage_seconds[stage] += ms / 1e3

    def observe_e2e(self, hop: str, seconds: float) -> None:
        """One batch's oldest tailer-read stamp of one hop -> effector
        commit (banjax_e2e_latency_seconds{hop}; the percentiles ring
        takes every hop)."""
        self.e2e_hists.observe(hop, max(0.0, seconds))
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

    def _totals_locked(self) -> Dict[str, object]:
        return {
            "EncodeShardedBatches": self.encode_sharded_batches,
            "EncodeWorkerUtilization": (
                None if self._encode_util_ewma is None
                else round(self._encode_util_ewma, 3)
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

    def snapshot(self) -> Dict[str, object]:
        """The 29 s line's view: totals plus the interval maxima, which
        reset here (read and reset in one lock section)."""
        with self._lock:
            out = self._totals_locked()
            out["EncodeShardMsMax"] = round(self._encode_shard_ms_max, 3)
            out["EncodeShardSkewMax"] = round(self._shard_skew_max, 3)
            self._encode_shard_ms_max = 0.0
            self._shard_skew_max = 0.0
            return out

    def peek(self) -> Dict[str, object]:
        """The Prometheus view: totals and EWMAs, no resets (the shard
        skew is its EWMA here)."""
        with self._lock:
            out = self._totals_locked()
            out["EncodeShardSkewMax"] = (
                None if self._shard_skew_ewma is None
                else round(self._shard_skew_ewma, 3)
            )
            return out
