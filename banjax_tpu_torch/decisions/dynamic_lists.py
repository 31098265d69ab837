"""Dynamic (runtime) expiring decision lists.

Reference behavior (Go banjax): internal/decision.go:379-604 — two
mutex-protected maps (ip → ExpiringDecision, session_id → ExpiringDecision)
with: monotonic-severity updates (a new decision ≤ the existing one is a
no-op), lazy expiry on read, a 9-second background sweep, per-domain
listing for /banned, and Clear() on a hot reload.

A copy of `banjax_tpu/decisions/dynamic_lists.py`: every expiry (lazy on
read, or by the sweep) is recorded in the provenance ledger
(`obs/provenance.py`, source `expiry`). `set_mirror` attaches the serving fast path's
decision table (`native/decisiontable.py`): every insert, expiry and
removal is mirrored into it under this list's lock, and the session-id
entries as a count. The mirror is an accelerator, never an authority: a
failed mirror call is counted on the serving stats
(`httpapi/serve_stats.py`) and the fast path then misses, so the chain
serves the request from this dict.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from banjax_tpu_torch.decisions.model import Decision
from banjax_tpu_torch.obs import provenance

SWEEP_INTERVAL_SECONDS = 9  # decision.go:396


@dataclasses.dataclass
class ExpiringDecision:
    """decision.go:60-66."""

    decision: Decision
    expires: float  # unix seconds
    ip_address: str
    from_baskerville: bool
    domain: str


@dataclasses.dataclass
class BannedEntry:
    """One entry of the /banned response (config.go:133-148)."""

    ip_or_session_id: str
    domain: str
    decision: str
    expires: float
    from_baskerville: bool


class DynamicDecisionLists:
    def __init__(self, start_sweeper: bool = True):
        self._lock = threading.Lock()
        self._by_ip: Dict[str, ExpiringDecision] = {}
        self._by_session_id: Dict[str, ExpiringDecision] = {}
        self._mirror = None  # the decision table (set_mirror)
        self._mirror_stats = None
        self._stop = threading.Event()
        self._sweeper: Optional[threading.Thread] = None
        if start_sweeper:
            self._sweeper = threading.Thread(
                target=self._sweep_loop, name="dynamic-lists-sweeper", daemon=True
            )
            self._sweeper.start()

    def close(self) -> None:
        self._stop.set()
        if self._sweeper is not None:
            self._sweeper.join(timeout=5)

    def set_mirror(self, table, stats=None) -> None:
        """Attach the decision table; `stats` (a ServeFastpathStats) counts
        failed mirror calls."""
        with self._lock:
            self._mirror = table
            self._mirror_stats = stats

    def _mirror_call(self, fn, *args) -> None:
        try:
            fn(*args)
        except Exception:  # noqa: BLE001 — counted; the chain serves from this dict
            if self._mirror_stats is not None:
                self._mirror_stats.note_mirror_error()

    def _mirror_put(self, ed: ExpiringDecision) -> None:
        if self._mirror is not None:
            self._mirror_call(
                self._mirror.put, ed.ip_address, int(ed.decision), ed.expires,
                ed.from_baskerville, ed.domain,
            )

    def _mirror_del(self, ip: str) -> None:
        if self._mirror is not None:
            self._mirror_call(self._mirror.delete, ip)

    def _mirror_session(self, delta: int) -> None:
        if self._mirror is not None:
            self._mirror_call(self._mirror.session_add, delta)

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
            ed = ExpiringDecision(new_decision, expires, ip, from_baskerville, domain)
            self._by_ip[ip] = ed
            self._mirror_put(ed)

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
            if existing is None:
                # the fast path needs only to know that session entries
                # exist (it then defers every cookie bearer to the chain)
                self._mirror_session(1)

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
                        self._mirror_session(-1)
                        provenance.record(provenance.SOURCE_EXPIRY, ed.ip_address,
                                          ed.decision, rule="session-lazy")
                        return ed, False
                    return ed, True
            ed = self._by_ip.get(client_ip)
            if ed is not None:
                if now - ed.expires > 0:
                    del self._by_ip[client_ip]
                    self._mirror_del(client_ip)
                    provenance.record(provenance.SOURCE_EXPIRY, client_ip, ed.decision,
                                      rule="lazy")
                    return ed, False
                return ed, True
        return None, False

    def peek(self, ip: str) -> Optional[ExpiringDecision]:
        """Lookup without the lazy expiry: an introspection read does not
        change the list."""
        with self._lock:
            return self._by_ip.get(ip)

    def check_by_domain(self, domain: str) -> List[BannedEntry]:
        """decision.go:502-530 — entries of severity ≥ Challenge for a domain."""
        out: List[BannedEntry] = []
        with self._lock:
            for key, ed in list(self._by_ip.items()) + list(self._by_session_id.items()):
                if ed.domain == domain and ed.decision >= Decision.CHALLENGE:
                    out.append(BannedEntry(key, ed.domain, str(ed.decision), ed.expires,
                                           ed.from_baskerville))
        return out

    def remove_by_ip(self, ip: str) -> None:
        with self._lock:
            self._by_ip.pop(ip, None)
            self._mirror_del(ip)

    def clear(self) -> None:
        with self._lock:
            self._by_ip.clear()
            self._by_session_id.clear()
            if self._mirror is not None:
                self._mirror_call(self._mirror.clear)

    def metrics(self) -> Tuple[int, int]:
        """(expiring challenges, expiring blocks) — decision.go:548-564."""
        challenges = blocks = 0
        with self._lock:
            for ed in self._by_ip.values():
                if ed.decision == Decision.CHALLENGE:
                    challenges += 1
                elif ed.decision in (Decision.NGINX_BLOCK, Decision.IPTABLES_BLOCK):
                    blocks += 1
        return challenges, blocks

    def format_ip_entries(self) -> Dict[str, ExpiringDecision]:
        with self._lock:
            return dict(self._by_ip)

    def _remove_expired(self) -> None:
        now = time.time()
        with self._lock:
            for ip in [ip for ip, ed in self._by_ip.items() if now - ed.expires > 0]:
                ed = self._by_ip.pop(ip)
                self._mirror_del(ip)
                provenance.record(provenance.SOURCE_EXPIRY, ip, ed.decision, rule="sweep")

    def _sweep_loop(self) -> None:
        while not self._stop.wait(SWEEP_INTERVAL_SECONDS):
            self._remove_expired()
