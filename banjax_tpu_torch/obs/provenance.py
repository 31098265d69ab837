"""Decision provenance ledger: why did banjax ban or challenge this IP?
(a copy of `banjax_tpu/obs/provenance.py`).

Every decision insertion, and every expiry, appends one fixed-size
record into a lock-cheap per-source ring, queryable by IP through
`GET /decisions/explain?ip=...`. The sources are the reference's:
static config lists, UA lists, the regex rate limiter, Kafka commands
(`ingest/kafka_io.py`, replicated fabric decisions included) and
repeated challenge failures, plus the ledger-only `expiry`.

  * **Off = free.** `provenance_enabled` gates every record path on one
    attribute check. On is the default: records fire on decision events
    (bans, list hits, expiries), not on log lines.
  * **On = lock-cheap.** One lock acquisition a record, a tuple store
    into a preallocated per-source ring (oldest overwritten) and one
    counter bump for `banjax_decision_inserts_total{source,decision}`;
    `explain()` pays the formatting.
  * **Passive.** Recording reads its inputs and writes only the ledger's
    own state: the ban log is the same bytes with it on or off.

Record fields (one tuple an insertion): ip, decision (its string),
source, rule name, rule index, window hit count at fire, trace id of the
admitting batch (the ambient span's, when the insert happens on a traced
drain thread), monotonic and wall timestamps, and the fleet fields:
the origin node and origin trace id of a line another fabric shard
tailed and forwarded here, resolved at record time through the
installed origin resolver (`set_origin_resolver`, the fabric's
`obs/fleet.py` OriginIndex); `explain()` shows them when set.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from banjax_tpu_torch.obs import trace

DEFAULT_RING_SIZE = 2048

SOURCE_STATIC = "static_list"
SOURCE_UA = "ua_list"
SOURCE_RATE_LIMIT = "rate_limit"
SOURCE_KAFKA = "kafka"
SOURCE_CHALLENGE = "challenge_failure"
SOURCE_EXPIRY = "expiry"

SOURCES = (
    SOURCE_STATIC,
    SOURCE_UA,
    SOURCE_RATE_LIMIT,
    SOURCE_KAFKA,
    SOURCE_CHALLENGE,
    SOURCE_EXPIRY,
)


class ProvenanceLedger:
    """Process-wide decision ledger; every method is thread-safe, and when
    `enabled` is False each one is a single attribute check."""

    def __init__(self, enabled: bool = True, ring_size: int = DEFAULT_RING_SIZE):
        self.enabled = bool(enabled)
        self.ring_size = max(16, int(ring_size))
        # a ring and a lock per source: sources fire from different
        # threads (drain, request handlers, the sweeper)
        self._rings: Dict[str, List[Optional[tuple]]] = {
            s: [None] * self.ring_size for s in SOURCES
        }
        self._ns: Dict[str, int] = {s: 0 for s in SOURCES}
        self._locks: Dict[str, threading.Lock] = {s: threading.Lock() for s in SOURCES}
        self._counter_lock = threading.Lock()
        # (source, decision string) -> monotone insert count
        self._counters: Dict[Tuple[str, str], int] = {}

    # ---- recording ----

    def record(self, source: str, ip: str, decision, rule: str = "",
               rule_index: int = -1, hits: Optional[int] = None,
               trace_id: Optional[int] = None) -> None:
        """Append one decision record. `decision` may be a Decision or a
        string (stored as a string). `trace_id` defaults to the ambient
        span's: a ban fired on a traced drain thread is attributed to the
        admitting batch with no plumbing at the call site."""
        if not self.enabled:
            return
        if source not in self._rings:
            source = SOURCE_STATIC  # never raise from a record path
        if trace_id is None:
            trace_id = trace.current_trace_id()
        decision_s = str(decision)
        origin_node, origin_trace = "", 0
        resolver = _origin_resolver
        if resolver is not None:
            try:
                origin = resolver(ip)
                if origin:
                    origin_node, origin_trace = str(origin[0]), int(origin[1])
            except Exception:  # noqa: BLE001 — resolution must never break a record path
                pass
        rec = (ip, decision_s, source, rule, int(rule_index), hits,
               int(trace_id), time.monotonic(), time.time(), origin_node, origin_trace)
        with self._locks[source]:
            n = self._ns[source]
            self._rings[source][n % self.ring_size] = rec
            self._ns[source] = n + 1
        key = (source, decision_s)
        with self._counter_lock:
            self._counters[key] = self._counters.get(key, 0) + 1

    # ---- queries ----

    def _source_records(self, source: str) -> List[tuple]:
        """One source's ring, oldest first."""
        with self._locks[source]:
            n = self._ns[source]
            ring = self._rings[source]
            if n <= self.ring_size:
                recs = list(ring[:n])
            else:
                cut = n % self.ring_size
                recs = ring[cut:] + ring[:cut]
        return [r for r in recs if r is not None]

    @staticmethod
    def _to_dict(rec: tuple) -> dict:
        (ip, decision, source, rule, rule_index, hits, tid, t_mono, t_wall,
         origin_node, origin_trace) = rec
        out = {
            "ip": ip,
            "decision": decision,
            "source": source,
            "rule": rule,
            "rule_index": rule_index,
            "hits": hits,
            "trace_id": tid,
            "t_monotonic": round(t_mono, 6),
            "time_unix": round(t_wall, 6),
        }
        if origin_node:
            out["origin_node"] = origin_node
            out["origin_trace_id"] = origin_trace
        return out

    def explain(self, ip: str) -> List[dict]:
        """The ledger's history of one IP across every source, oldest
        first (the /decisions/explain payload)."""
        out = []
        for source in SOURCES:
            out.extend(r for r in self._source_records(source) if r[0] == ip)
        out.sort(key=lambda r: r[7])  # monotonic timestamp
        return [self._to_dict(r) for r in out]

    def tail(self, n: int = 256) -> List[dict]:
        """The newest `n` records across all sources, oldest first (the
        flight recorder's capture)."""
        recs: List[tuple] = []
        for source in SOURCES:
            recs.extend(self._source_records(source))
        recs.sort(key=lambda r: r[7])
        return [self._to_dict(r) for r in recs[-max(0, int(n)):]]

    def counters(self) -> Dict[Tuple[str, str], int]:
        """{(source, decision): total inserts}: the exposition family."""
        with self._counter_lock:
            return dict(self._counters)

    def total_records(self) -> int:
        return sum(self._ns[s] for s in SOURCES)


# ---- the process-wide ledger ----------------------------------------------

_ledger = ProvenanceLedger(enabled=True)

# ip -> (origin node id, origin trace id) or None: installed by the fabric
# (obs/fleet.py OriginIndex.resolve); it outlives a configure() swap
_origin_resolver: Optional[Callable[[str], Optional[Tuple[str, int]]]] = None


def set_origin_resolver(fn: Optional[Callable[[str], Optional[Tuple[str, int]]]]) -> None:
    global _origin_resolver
    _origin_resolver = fn


def get_ledger() -> ProvenanceLedger:
    return _ledger


def configure(enabled: bool = True, ring_size: int = DEFAULT_RING_SIZE) -> ProvenanceLedger:
    """(Re)configure the process ledger: called by cli.BanjaxApp from the
    config (`provenance_enabled`, `provenance_ring_size`) and by tests.
    Swaps the singleton, so a disabled ledger keeps its one-check path."""
    global _ledger
    _ledger = ProvenanceLedger(enabled=enabled, ring_size=ring_size)
    return _ledger


# module-level delegates: call sites read the current singleton each time

def enabled() -> bool:
    return _ledger.enabled


def record(source: str, ip: str, decision, rule: str = "", rule_index: int = -1,
           hits: Optional[int] = None, trace_id: Optional[int] = None) -> None:
    _ledger.record(source, ip, decision, rule, rule_index, hits, trace_id)
