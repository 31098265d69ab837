"""Scenario-harness run summary for the /metrics exposition.

(A copy of `banjax_tpu/scenarios/stats.py`.)

A LEAF module (stdlib only): obs/exposition.py imports it lazily inside
render_prometheus, so a scrape on a process that never ran a scenario
pays one import and one lock — and declaring the banjax_scenario_*
families in obs/registry.py keeps the schema CI-locked like every other
surface.  ScenarioRunner publishes here after every run; totals are
process-lifetime counters, per-scenario gauges are last-run values.
"""

from __future__ import annotations

import threading
from typing import Dict


class ScenarioStats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.runs_total = 0
        self.episodes_total = 0
        self.invariant_failures_total = 0
        # scenario name -> {lines_per_sec, shed_ratio, precision, recall,
        #                   slo_burn_peak}
        self._last: Dict[str, Dict[str, float]] = {}

    def note_run(self, name: str, row: Dict[str, float],
                 episodes: int = 0, invariant_failures: int = 0) -> None:
        with self._lock:
            self.runs_total += 1
            self.episodes_total += episodes
            self.invariant_failures_total += invariant_failures
            self._last[name] = dict(row)

    def prom_snapshot(self) -> dict:
        with self._lock:
            return {
                "runs_total": self.runs_total,
                "episodes_total": self.episodes_total,
                "invariant_failures_total": self.invariant_failures_total,
                "scenarios": {k: dict(v) for k, v in self._last.items()},
            }

    def reset(self) -> None:
        """Test isolation only."""
        with self._lock:
            self.runs_total = 0
            self.episodes_total = 0
            self.invariant_failures_total = 0
            self._last.clear()


_stats = ScenarioStats()


def get_stats() -> ScenarioStats:
    return _stats
