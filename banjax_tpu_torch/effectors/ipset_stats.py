"""Kernel-edge ban counters (a copy of `banjax_tpu/effectors/ipset_stats.py`).

Publishers: the netlink batch writer (`effectors/ipset_netlink.py`) and
the Banner's subprocess path. Every failure is counted
(`banjax_ipset_errors_total{path}`) and routed: a netlink failure falls
back to per-entry subprocess adds (`fallback_total`), and an over-full
queue sheds its oldest entries (`queue_shed_total`) instead of blocking
the ban path.

One difference from the JAX module: the counters are an object each app
owns (`BanjaxApp.ipset_stats`), not a process-wide singleton, as the
serving counters are (`httpapi/serve_stats.py`).
"""

from __future__ import annotations

import threading
from typing import Dict


class IpsetStats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.batch_sends_total = 0     # netlink sendmsg calls that acked clean
        self.batch_entries_total = 0   # entries carried by those sends
        self._errors: Dict[str, int] = {}  # by path: "netlink" or "subprocess"
        self.fallback_total = 0        # entries re-routed netlink -> subprocess
        self.queue_shed_total = 0      # oldest entries dropped on overflow
        self._depth_fn = None          # live queue depth, sampled at scrape

    def set_depth_fn(self, fn) -> None:
        with self._lock:
            self._depth_fn = fn

    def note_batch(self, entries: int) -> None:
        with self._lock:
            self.batch_sends_total += 1
            self.batch_entries_total += entries

    def note_error(self, path: str, n: int = 1) -> None:
        with self._lock:
            self._errors[path] = self._errors.get(path, 0) + n

    def note_fallback(self, n: int = 1) -> None:
        with self._lock:
            self.fallback_total += n

    def note_shed(self, n: int = 1) -> None:
        with self._lock:
            self.queue_shed_total += n

    def prom_snapshot(self) -> dict:
        with self._lock:
            depth_fn = self._depth_fn
            out = {
                "batch_sends_total": self.batch_sends_total,
                "batch_entries_total": self.batch_entries_total,
                "errors": dict(self._errors),
                "errors_total": sum(self._errors.values()),
                "fallback_total": self.fallback_total,
                "queue_shed_total": self.queue_shed_total,
            }
        depth = 0
        if depth_fn is not None:
            try:
                depth = int(depth_fn())
            except Exception:  # noqa: BLE001 — a closed writer reads as 0
                depth = 0
        out["queue_depth"] = depth
        return out

    def active(self) -> bool:
        """True once the batch writer exists or anything was counted (the
        render gate: subprocess-only deployments stay clean)."""
        with self._lock:
            return bool(
                self.batch_sends_total or self._errors or self.fallback_total
                or self.queue_shed_total or self._depth_fn is not None
            )
