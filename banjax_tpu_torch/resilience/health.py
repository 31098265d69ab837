"""Component health registry (a copy of `banjax_tpu/resilience/health.py`).

Every long-lived loop (log tailer, Kafka reader/writer, matcher runner,
device mesh, worker supervisor) registers a component and either
heartbeats it (`beat`) or sets an explicit status (`set_status`).  The
registry's `snapshot()` is the single source for the /healthz route and
the additive health keys on the 29 s metrics line.

Staleness: a component registered with `stale_after > 0` that has not
beaten within that window is reported DEGRADED (FAILED after three
windows) regardless of its last explicit status — a wedged thread that
can't even complain still shows up.

The clock is injectable so fault tests can advance time deterministically.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable, Dict, Optional


class HealthStatus(enum.IntEnum):
    """Ordered worst-last so aggregate status is a max()."""

    HEALTHY = 0
    DEGRADED = 1
    FAILED = 2

    def __str__(self) -> str:
        return self.name.lower()


class ComponentHealth:
    """One registered component; all methods are thread-safe and cheap
    enough for per-message call sites (a lock around a few stores)."""

    def __init__(self, name: str, stale_after: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.stale_after = stale_after
        self._clock = clock
        self._lock = threading.Lock()
        self._status = HealthStatus.HEALTHY
        self._detail = ""
        self._last_beat = clock()

    def beat(self) -> None:
        """Heartbeat: refreshes liveness without changing the status."""
        with self._lock:
            self._last_beat = self._clock()

    def set_status(self, status: HealthStatus, detail: str = "") -> None:
        with self._lock:
            self._status = HealthStatus(status)
            self._detail = detail
            self._last_beat = self._clock()

    def ok(self, detail: str = "") -> None:
        self.set_status(HealthStatus.HEALTHY, detail)

    def degraded(self, detail: str = "") -> None:
        self.set_status(HealthStatus.DEGRADED, detail)

    def failed(self, detail: str = "") -> None:
        self.set_status(HealthStatus.FAILED, detail)

    def effective_status(self) -> "tuple[HealthStatus, str, float]":
        """(status, detail, seconds_since_beat) with staleness applied."""
        with self._lock:
            status, detail = self._status, self._detail
            age = max(0.0, self._clock() - self._last_beat)
        if self.stale_after > 0 and age > self.stale_after:
            stale = (HealthStatus.FAILED if age > 3 * self.stale_after
                     else HealthStatus.DEGRADED)
            if stale > status:
                status = stale
                detail = f"no heartbeat for {age:.0f}s"
        return status, detail, age


class HealthRegistry:
    """Process-wide component table; one per BanjaxApp (not a global, so
    in-process integration tests don't cross-contaminate)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._components: Dict[str, ComponentHealth] = {}

    def register(self, name: str, stale_after: float = 0.0) -> ComponentHealth:
        """Idempotent: re-registering returns the existing component (a
        hot-reloaded matcher keeps its history)."""
        with self._lock:
            comp = self._components.get(name)
            if comp is None:
                comp = ComponentHealth(name, stale_after, self._clock)
                self._components[name] = comp
            return comp

    def get(self, name: str) -> Optional[ComponentHealth]:
        with self._lock:
            return self._components.get(name)

    def snapshot(self) -> dict:
        """JSON-ready aggregate: overall status is the worst component."""
        with self._lock:
            comps = list(self._components.values())
        overall = HealthStatus.HEALTHY
        out: Dict[str, dict] = {}
        for comp in comps:
            status, detail, age = comp.effective_status()
            overall = max(overall, status)
            entry = {"status": str(status), "age_seconds": round(age, 1)}
            if detail:
                entry["detail"] = detail
            out[comp.name] = entry
        return {"status": str(overall), "components": out}
