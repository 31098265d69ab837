"""Dynamic (runtime) expiring decision lists.

Reference behavior (Go banjax): internal/decision.go:379-604 — two
mutex-protected maps (ip → ExpiringDecision, session_id → ExpiringDecision)
with: monotonic-severity updates (a new decision ≤ the existing one is a
no-op), lazy expiry on read and a 9-second background sweep.

A copy of `banjax_tpu/decisions/dynamic_lists.py` without its provenance
records, without the mirror into the shared-memory decision table (the
serving fast path) and without the removals of Kafka commands and hot
reloads, none of which the port has yet. The Banner writes
bans here; `/auth_request` (the decision chain, step 7) reads them.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

from banjax_tpu_torch.decisions.model import Decision

SWEEP_INTERVAL_SECONDS = 9  # decision.go:396


@dataclasses.dataclass
class ExpiringDecision:
    """decision.go:60-66."""

    decision: Decision
    expires: float  # unix seconds
    ip_address: str
    from_baskerville: bool
    domain: str


class DynamicDecisionLists:
    def __init__(self, start_sweeper: bool = True):
        self._lock = threading.Lock()
        self._by_ip: Dict[str, ExpiringDecision] = {}
        self._by_session_id: Dict[str, ExpiringDecision] = {}
        self._stop = threading.Event()
        if start_sweeper:
            t = threading.Thread(target=self._sweep_loop, name="dynamic-lists-sweeper", daemon=True)
            t.start()

    def close(self) -> None:
        self._stop.set()

    def update(
        self,
        ip: str,
        expires: float,
        new_decision: Decision,
        from_baskerville: bool,
        domain: str,
    ) -> None:
        """Monotonic-severity insert (decision.go:404-439)."""
        with self._lock:
            existing = self._by_ip.get(ip)
            if existing is not None and new_decision <= existing.decision:
                return
            self._by_ip[ip] = ExpiringDecision(
                new_decision, expires, ip, from_baskerville, domain
            )

    def update_by_session_id(
        self,
        ip: str,
        session_id: str,
        expires: float,
        new_decision: Decision,
        from_baskerville: bool,
        domain: str,
    ) -> None:
        """decision.go:441-472."""
        with self._lock:
            existing = self._by_session_id.get(session_id)
            if existing is not None and new_decision <= existing.decision:
                return
            self._by_session_id[session_id] = ExpiringDecision(
                new_decision, expires, ip, from_baskerville, domain
            )

    def check(self, session_id: str, client_ip: str) -> Tuple[Optional[ExpiringDecision], bool]:
        """Session id first, then IP; lazy expiry on read (decision.go:474-500).

        Quirk preserved: a *found-but-expired* session entry returns
        (entry, False) without falling through to the IP lookup, exactly as
        the Go early-return at decision.go:487 does.
        """
        now = time.time()
        with self._lock:
            if session_id:
                ed = self._by_session_id.get(session_id)
                if ed is not None:
                    if now - ed.expires > 0:
                        del self._by_session_id[session_id]
                        return ed, False
                    return ed, True
            ed = self._by_ip.get(client_ip)
            if ed is not None:
                if now - ed.expires > 0:
                    del self._by_ip[client_ip]
                    return ed, False
                return ed, True
        return None, False

    def format_ip_entries(self) -> Dict[str, ExpiringDecision]:
        with self._lock:
            return dict(self._by_ip)

    def _remove_expired(self) -> None:
        now = time.time()
        with self._lock:
            for ip in [ip for ip, ed in self._by_ip.items() if now - ed.expires > 0]:
                del self._by_ip[ip]

    def _sweep_loop(self) -> None:
        while not self._stop.wait(SWEEP_INTERVAL_SECONDS):
            self._remove_expired()
