"""Counters of the compiled serving path (a copy of
`banjax_tpu/httpapi/serve_stats.py`).

The fast path (`httpapi/fastpath.py`) counts hits by tier and misses by
reason; the dynamic lists count failed mirror writes; the servers count
fail-open responses (a handler crash answered with 500 and
`X-Accel-Redirect: @fail_open`). The table's entries, refusals and
session entries are read from the attached table when a snapshot is
taken.

One difference from the JAX module: the counters are an object each app
owns (on `ServerDeps.serve_stats`), not a process-wide singleton, so two
apps in one process (the card's and the CPU's) count apart. The
fail-open counter is the port's own: the JAX app counts fail-open
responses nowhere.
"""

from __future__ import annotations

import threading
from typing import Dict

# every terminal state of one fast-path consultation (the tier label)
HIT_TIERS = ("allow", "block", "challenge")
# why the consultation declined and the chain served instead
MISS_REASONS = ("disabled", "table", "expired", "ineligible", "password",
                "global_list", "session_guard", "baskerville")


class ServeFastpathStats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hits: Dict[str, int] = {}
        self._misses: Dict[str, int] = {}
        self.faults_total = 0          # unexpected lookup errors
        self.mirror_errors_total = 0   # failed dynamic-list mirror writes
        self.fail_open_total = 0       # handler crashes answered @fail_open
        self._table = None

    def set_table(self, table) -> None:
        with self._lock:
            self._table = table

    def note_hit(self, tier: str, n: int = 1) -> None:
        with self._lock:
            self._hits[tier] = self._hits.get(tier, 0) + n

    def note_miss(self, reason: str, n: int = 1) -> None:
        with self._lock:
            self._misses[reason] = self._misses.get(reason, 0) + n

    def note_fault(self, n: int = 1) -> None:
        with self._lock:
            self.faults_total += n

    def note_mirror_error(self, n: int = 1) -> None:
        with self._lock:
            self.mirror_errors_total += n

    def note_fail_open(self, n: int = 1) -> None:
        with self._lock:
            self.fail_open_total += n

    def active(self) -> bool:
        """True once the fast path was consulted or a table attached (the
        render gate of the metrics line and /metrics)."""
        with self._lock:
            return bool(
                self._hits or self._misses or self.faults_total
                or self.mirror_errors_total or self._table is not None
            )

    def snapshot(self) -> dict:
        with self._lock:
            table = self._table
            hits = dict(self._hits)
            misses = dict(self._misses)
            faults = self.faults_total
            mirror_errors = self.mirror_errors_total
            fail_open = self.fail_open_total
        entries = dropped = sessions = 0
        if table is not None:
            entries = len(table)
            dropped = int(table.dropped)
            sessions = int(table.session_count())
        return {
            "hits": hits,
            "hits_total": sum(hits.values()),
            "misses": misses,
            "misses_total": sum(misses.values()),
            "faults_total": faults,
            "mirror_errors_total": mirror_errors,
            "fail_open_total": fail_open,
            "table_entries": entries,
            "table_dropped_total": dropped,
            "table_session_entries": sessions,
        }
