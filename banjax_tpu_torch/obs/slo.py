"""SLO burn-rate engine: multi-window error-budget accounting (a copy of
`banjax_tpu/obs/slo.py`).

    burn_rate = (observed bad fraction over a window)
              / (the SLO's error-budget fraction)

evaluated over a fast (5 m) and a slow (1 h) window. 1.0 means the error
budget is consumed exactly at the sustainable rate; an SLO is
**breached** when every window burns >= 1.0.

Declared SLOs (config keys in parentheses):

  * `batch_latency`: fraction of matcher batches inside
    `pipeline_latency_budget_ms`, target `slo_batch_latency_target`, from
    the cumulative `banjax_batch_latency_seconds` buckets;
  * `shed_ratio`: (shed + drain-error) lines per admitted line vs
    `slo_shed_ratio_max`;
  * `stale_ratio`: staleness drops per processed line vs
    `slo_stale_ratio_max`;
  * `breaker_open`: breaker-open seconds per wall second vs
    `slo_breaker_open_ratio_max` (`CircuitBreaker.open_seconds_total`);
  * `budget_trips`: latency-budget breaches per batch vs
    `slo_budget_trip_ratio_max` (the matcher's `budget_trips`).

Every input is a non-destructive cumulative read (`peek()`-style), so the
engine samples at any cadence beside the 29 s line and any scraper; none
of them touches the card. On a breach transition the engine fires
`on_breach` (cli.BanjaxApp wires it to the flight recorder). In fleet
mode (`collect_fn`, `obs/fleet.py` `FleetScraper.fleet_collect`) the
engine burns the cluster's counter sums from the last federated scrape
with the same window mechanics.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

# (label, seconds): the classic fast/slow alerting pair
WINDOWS = (("5m", 300.0), ("1h", 3600.0))

SLO_BATCH_LATENCY = "batch_latency"
SLO_SHED = "shed_ratio"
SLO_STALE = "stale_ratio"
SLO_BREAKER_OPEN = "breaker_open"
SLO_BUDGET_TRIPS = "budget_trips"

SLO_NAMES = (
    SLO_BATCH_LATENCY,
    SLO_SHED,
    SLO_STALE,
    SLO_BREAKER_OPEN,
    SLO_BUDGET_TRIPS,
)


class SloEngine:
    """Samples cumulative counters and evaluates windowed burn rates.

    All inputs are injected getters so the engine never holds a stale
    matcher/pipeline across a SIGHUP swap; the clock is injectable for
    deterministic tests."""

    def __init__(
        self,
        matcher_getter: Optional[Callable[[], object]] = None,
        pipeline_getter: Optional[Callable[[], object]] = None,
        batch_budget_s_fn: Optional[Callable[[], float]] = None,
        batch_latency_target: float = 0.99,
        shed_ratio_max: float = 0.001,
        stale_ratio_max: float = 0.001,
        breaker_open_ratio_max: float = 0.01,
        budget_trip_ratio_max: float = 0.01,
        on_breach: Optional[Callable[[str, dict], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        max_samples: int = 512,
        collect_fn: Optional[Callable[[], Dict[str, float]]] = None,
    ):
        if not 0.0 < batch_latency_target < 1.0:
            raise ValueError(
                f"batch_latency_target must be in (0, 1), got "
                f"{batch_latency_target}"
            )
        for name, v in (
            ("shed_ratio_max", shed_ratio_max),
            ("stale_ratio_max", stale_ratio_max),
            ("breaker_open_ratio_max", breaker_open_ratio_max),
            ("budget_trip_ratio_max", budget_trip_ratio_max),
        ):
            if v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")
        self._matcher_getter = matcher_getter
        self._pipeline_getter = pipeline_getter
        self._batch_budget_s_fn = batch_budget_s_fn
        self._collect_fn = collect_fn
        self.batch_latency_target = batch_latency_target
        self.shed_ratio_max = shed_ratio_max
        self.stale_ratio_max = stale_ratio_max
        self.breaker_open_ratio_max = breaker_open_ratio_max
        self.budget_trip_ratio_max = budget_trip_ratio_max
        self._on_breach = on_breach
        self._clock = clock
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=max(8, int(max_samples)))
        self._burn: Dict[str, Dict[str, float]] = {}
        self._breached: Dict[str, bool] = {s: False for s in SLO_NAMES}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def from_config(cls, config, matcher_getter=None, pipeline_getter=None,
                    on_breach=None) -> "SloEngine":
        budget_ms = getattr(config, "pipeline_latency_budget_ms", 250.0)
        return cls(
            matcher_getter=matcher_getter,
            pipeline_getter=pipeline_getter,
            batch_budget_s_fn=lambda: budget_ms / 1e3,
            batch_latency_target=getattr(
                config, "slo_batch_latency_target", 0.99
            ),
            shed_ratio_max=getattr(config, "slo_shed_ratio_max", 0.001),
            stale_ratio_max=getattr(config, "slo_stale_ratio_max", 0.001),
            breaker_open_ratio_max=getattr(
                config, "slo_breaker_open_ratio_max", 0.01
            ),
            budget_trip_ratio_max=getattr(
                config, "slo_budget_trip_ratio_max", 0.01
            ),
            on_breach=on_breach,
        )

    # ---- collection (non-destructive reads only) ----

    def _collect(self) -> Dict[str, float]:
        # fleet mode: the injected collector replaces the local getters
        if self._collect_fn is not None:
            try:
                return {k: float(v) for k, v in (self._collect_fn() or {}).items()}
            except Exception:  # noqa: BLE001 — a collector bug must not stop sampling
                return {}
        vals: Dict[str, float] = {}
        matcher = self._matcher_getter() if self._matcher_getter else None
        if matcher is not None:
            stats = getattr(matcher, "stats", None)
            hist = getattr(stats, "batch_latency_hist", None)
            if hist is not None:
                bounds, cum, _sum, count = hist.snapshot()
                vals["batches_total"] = count
                budget_s = 0.0
                if self._batch_budget_s_fn is not None:
                    try:
                        budget_s = max(0.0, float(self._batch_budget_s_fn()))
                    except Exception:  # noqa: BLE001 — a budget bug must not stop sampling
                        budget_s = 0.0
                if budget_s > 0:
                    # good = observations ≤ the smallest bucket bound that
                    # covers the budget (cumulative counts, so one index)
                    idx = bisect.bisect_left(bounds, budget_s)
                    vals["batches_in_budget"] = (
                        cum[idx] if idx < len(bounds) else count
                    )
                else:
                    vals["batches_in_budget"] = count  # no budget = all good
            vals["budget_trips"] = float(getattr(matcher, "budget_trips", 0))
            breaker = getattr(matcher, "breaker", None)
            if breaker is not None and hasattr(breaker, "open_seconds_total"):
                vals["breaker_open_s"] = breaker.open_seconds_total()
        pipeline = self._pipeline_getter() if self._pipeline_getter else None
        if pipeline is not None:
            peek = pipeline.stats.peek()  # the non-destructive view
            vals["admitted"] = float(peek.get("PipelineAdmittedLines", 0))
            vals["shed"] = float(
                peek.get("PipelineShedLines", 0)
                + peek.get("PipelineDrainErrorLines", 0)
            )
            vals["processed"] = float(peek.get("PipelineProcessedLines", 0))
            vals["stale"] = float(peek.get("PipelineStaleDroppedLines", 0))
        return vals

    # ---- evaluation ----

    @staticmethod
    def _delta(cur: Dict[str, float], base: Dict[str, float],
               key: str) -> float:
        return max(0.0, cur.get(key, 0.0) - base.get(key, 0.0))

    def _burn_for(self, cur, base, span_s: float) -> Dict[str, float]:
        """One window's burn rate per SLO from (base → cur) deltas."""
        out: Dict[str, float] = {}
        d_batches = self._delta(cur, base, "batches_total")
        if "batches_total" in cur:
            if d_batches > 0:
                bad = d_batches - self._delta(cur, base, "batches_in_budget")
                bad_frac = min(1.0, max(0.0, bad / d_batches))
            else:
                bad_frac = 0.0
            out[SLO_BATCH_LATENCY] = bad_frac / (
                1.0 - self.batch_latency_target
            )
            d_trips = self._delta(cur, base, "budget_trips")
            trip_frac = d_trips / d_batches if d_batches > 0 else 0.0
            out[SLO_BUDGET_TRIPS] = min(1.0, trip_frac) / (
                self.budget_trip_ratio_max
            )
        if "breaker_open_s" in cur and span_s > 0:
            open_frac = min(
                1.0, self._delta(cur, base, "breaker_open_s") / span_s
            )
            out[SLO_BREAKER_OPEN] = open_frac / self.breaker_open_ratio_max
        if "admitted" in cur:
            d_adm = self._delta(cur, base, "admitted")
            shed_frac = (
                min(1.0, self._delta(cur, base, "shed") / d_adm)
                if d_adm > 0 else 0.0
            )
            out[SLO_SHED] = shed_frac / self.shed_ratio_max
            d_proc = self._delta(cur, base, "processed")
            stale_frac = (
                min(1.0, self._delta(cur, base, "stale") / d_proc)
                if d_proc > 0 else 0.0
            )
            out[SLO_STALE] = stale_frac / self.stale_ratio_max
        return {k: round(v, 4) for k, v in out.items()}

    def sample(self, now: Optional[float] = None) -> List[str]:
        """Take one sample and re-evaluate every window.  Returns the
        SLOs that newly transitioned into breach (the flight-recorder
        trigger list)."""
        t = self._clock() if now is None else now
        vals = self._collect()
        newly_breached: List[str] = []
        with self._lock:
            self._samples.append((t, vals))
            burn: Dict[str, Dict[str, float]] = {}
            for label, w_s in WINDOWS:
                base_t, base = self._oldest_within_locked(t, w_s)
                if base is None or base is vals:
                    continue
                span = max(1e-9, t - base_t)
                for slo, rate in self._burn_for(vals, base, span).items():
                    burn.setdefault(slo, {})[label] = rate
            self._burn = burn
            for slo in SLO_NAMES:
                windows = burn.get(slo)
                # breached = every evaluated window burning ≥ 1.0 (fast
                # catches the spike, slow keeps blips from paging); no
                # window data = not breached
                hit = bool(windows) and all(
                    v >= 1.0 for v in windows.values()
                )
                if hit and not self._breached[slo]:
                    newly_breached.append(slo)
                self._breached[slo] = hit
        if newly_breached and self._on_breach is not None:
            for slo in newly_breached:
                try:
                    self._on_breach(slo, self._burn.get(slo, {}))
                except Exception:  # noqa: BLE001 — a recorder bug must not stop sampling
                    pass
        return newly_breached

    def _oldest_within_locked(self, now: float, window_s: float):
        """(t, sample) of the oldest sample inside the window; the very
        oldest available when the engine is younger than the window."""
        base_t, base = None, None
        for t, vals in self._samples:
            if now - t <= window_s:
                if base is None or t < base_t:
                    base_t, base = t, vals
                break  # deque is time-ordered; first hit is the oldest
        if base is None and self._samples:
            base_t, base = self._samples[0]
        if base is not None and self._samples and (
            base is self._samples[-1][1] and len(self._samples) > 1
        ):
            # never diff a sample against itself when history exists
            base_t, base = self._samples[-2]
        return base_t, base

    # ---- views (exposition) ----

    def burn_rates(self) -> Dict[str, Dict[str, float]]:
        """{slo: {window_label: burn}} — banjax_slo_burn_rate."""
        with self._lock:
            return {k: dict(v) for k, v in self._burn.items()}

    def breached(self) -> Dict[str, bool]:
        """{slo: breached} — the one-hot banjax_slo_breached gauge."""
        with self._lock:
            return dict(self._breached)

    def snapshot(self) -> dict:
        """JSON-ready state for incident bundles / debugging."""
        return {
            "burn_rates": self.burn_rates(),
            "breached": self.breached(),
            "windows": {label: s for label, s in WINDOWS},
            "targets": {
                SLO_BATCH_LATENCY: self.batch_latency_target,
                SLO_SHED: self.shed_ratio_max,
                SLO_STALE: self.stale_ratio_max,
                SLO_BREAKER_OPEN: self.breaker_open_ratio_max,
                SLO_BUDGET_TRIPS: self.budget_trip_ratio_max,
            },
        }

    # ---- background sampling ----

    def start(self, interval_s: float = 15.0) -> None:
        if interval_s <= 0 or self._thread is not None:
            return

        def run():
            while not self._stop.wait(interval_s):
                try:
                    self.sample()
                except Exception:  # noqa: BLE001 — sampling must never die
                    pass

        self._thread = threading.Thread(
            target=run, name="slo-engine", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
