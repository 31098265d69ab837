"""Fleet observability plane: the cluster as one observable system.

(A copy of `banjax_tpu/obs/fleet.py`.)

The fabric makes N banjax nodes act as one *decision* plane — a line
tailed on shard A can ban an IP owned by shard B — but observability
stayed per-process: B's ledger said "fabric told me", A's trace ring
showed a forwarded chunk vanishing over the wire, and an operator
debugging a cross-shard ban had to correlate two /metrics scrapes and
two trace rings by wall clock.  This module closes that gap with four
cooperating layers:

  * **Cross-host trace propagation.**  The forwarding router allocates
    an origin trace id per admission chunk (fabric/router.py); the wire
    carries ``(origin_node_id, origin_trace_id)`` per contiguous run of
    lines (fabric/wire.py T_LINES_V2 origin section, JSON ``origin``
    key); the owner's chunk handler opens a linked ``fabric.
    remote-drain`` span under the *origin* trace id and feeds the
    ``OriginIndex`` here, which the provenance ledger consults at
    record time (obs/provenance.py ``set_origin_resolver``) — so
    ``/decisions/explain?ip=`` on the owner answers with the origin
    node and the trace id of the admission batch tailed over there.

  * **Federated metrics.**  ``FleetScraper`` fans a T_STATS
    ``{"metrics": true}`` pull out to every ALIVE member, and
    ``merge_expositions`` renders ONE strictly-parseable text payload:
    counters summed across instances, gauges re-emitted per instance
    with an added ``instance`` label, histograms merged on the union
    of bucket bounds with each instance's cumulative counts carried
    forward.  A dead peer mid-scrape degrades to its cached snapshot
    (or drops out entirely) and is flagged via
    ``banjax_fleet_peer_unreachable`` / ``…_staleness_seconds`` —
    partial but honest, never a 500.

  * **Cluster SLO + fleet health.**  ``fleet_collect`` turns the last
    merged scrape into the counter dict obs/slo.py burns over (a
    fleet-mode SloEngine via its ``collect_fn`` seam), and
    ``compute_health_bits`` packs (slo_breached, breaker open/half-
    open) into the compact health word the SWIM digests piggyback
    (fabric/membership.py), surfaced as ``banjax_fabric_peer_health``.

  * **Cluster incident capture.**  ``local_capture_files`` builds the
    per-node snapshot a peer returns for T_FLIGHTREC, and
    ``capture_fleet`` fans the request out to ALIVE members so the
    origin node's incident bundle grows a ``peers/<node_id>/`` tree
    (obs/flightrec.py ``fleet_capture_fn``).

Failpoints: ``obs.fleet.pull`` (per peer, metrics fan-out) and
``obs.fleet.capture`` (per peer, incident fan-out) — both degrade to
the partial view, proven by tests/faults.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from banjax_tpu_torch.obs import registry
from banjax_tpu_torch.obs.exposition import (
    COUNTER,
    HISTOGRAM,
    _esc,
    parse_text_format,
)
from banjax_tpu_torch.resilience import failpoints
from banjax_tpu_torch.resilience.breaker import HALF_OPEN, OPEN

# ---------------------------------------------------------------------------
# health bits (gossip piggyback encoding — see fabric/stats.py peer_health)
# ---------------------------------------------------------------------------

HEALTH_SLO_BREACHED = 1      # any SLO currently breached
HEALTH_BREAKER_OPEN = 2      # matcher breaker OPEN
HEALTH_BREAKER_HALF_OPEN = 4  # matcher breaker HALF_OPEN


def compute_health_bits(slo=None, matcher=None) -> int:
    """Pack this node's health into the compact word SWIM digests carry.

    Reads are non-destructive and crash-proof: a health provider bug
    must never take down a gossip probe."""
    bits = 0
    if slo is not None:
        try:
            if any(slo.breached().values()):
                bits |= HEALTH_SLO_BREACHED
        except Exception:  # noqa: BLE001 — gossip must not die on a telemetry bug
            pass
    if matcher is not None:
        try:
            breaker = getattr(matcher, "breaker", None)
            state = getattr(breaker, "state", None)
            if state == OPEN:
                bits |= HEALTH_BREAKER_OPEN
            elif state == HALF_OPEN:
                bits |= HEALTH_BREAKER_HALF_OPEN
        except Exception:  # noqa: BLE001
            pass
    return bits


# ---------------------------------------------------------------------------
# origin index: ip -> (origin_node, origin_trace) for forwarded lines
# ---------------------------------------------------------------------------

class OriginIndex:
    """Bounded LRU mapping a forwarded line's IP to the node that tailed
    it and the trace id its router allocated at admission.

    Fed by the owner-side chunk handlers (fabric/service.py,
    the JAX package's fabric/worker.py) per line per origin run; consulted by the
    provenance ledger at record time (obs/provenance.py).  Bounded so a
    spray of distinct spoofed sources cannot grow it without limit —
    the oldest attribution is the right one to lose."""

    def __init__(self, max_entries: int = 8192,
                 clock: Callable[[], float] = time.monotonic):
        self.max_entries = max(16, int(max_entries))
        self._clock = clock
        self._lock = threading.Lock()
        # insertion-ordered dict as LRU: move_to_end on note, popitem
        # oldest on overflow
        self._map: Dict[str, Tuple[str, int, float]] = {}

    def note(self, ip: str, origin_node: str, origin_trace: int) -> None:
        if not origin_node:
            return
        with self._lock:
            m = self._map
            if ip in m:
                del m[ip]
            m[ip] = (origin_node, int(origin_trace), self._clock())
            while len(m) > self.max_entries:
                m.pop(next(iter(m)))

    def resolve(self, ip: str) -> Optional[Tuple[str, int]]:
        with self._lock:
            ent = self._map.get(ip)
        if ent is None:
            return None
        return ent[0], ent[1]

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)


# process-wide index, installed into provenance by the fabric wiring
_origin_index = OriginIndex()


def get_origin_index() -> OriginIndex:
    return _origin_index


# ---------------------------------------------------------------------------
# exposition merge (federated /metrics?fleet=1)
# ---------------------------------------------------------------------------

def _fmt_merged(v: float) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v) == int(v):
        return str(int(v))
    return repr(float(v))


def _label_str(pairs: Dict[str, str]) -> str:
    if not pairs:
        return ""
    inner = ",".join(
        f'{k}="{_esc(v)}"' for k, v in sorted(pairs.items())
    )
    return "{" + inner + "}"


def _labelset_key(labels: Dict[str, str],
                  drop: Tuple[str, ...] = ()) -> tuple:
    return tuple(sorted(
        (k, v) for k, v in labels.items() if k not in drop
    ))


def merge_expositions(texts: Dict[str, str]) -> str:
    """Merge per-instance Prometheus texts into one strict exposition.

    ``texts`` maps instance id (node id) -> that node's full /metrics
    payload.  Semantics, per family kind:

      * counter — summed across instances per label set (a fleet total;
        no ``instance`` label, so existing single-node alert rules keep
        firing on the cluster aggregate)
      * gauge (and summary/untyped) — point-in-time state is NOT
        summable; each sample re-emitted with an added ``instance``
        label
      * histogram — merged per label set on the UNION of bucket bounds;
        an instance's cumulative count at a bound it never declared is
        carried forward from its largest declared bound below it
        (conservative undercount, preserves monotonicity); +Inf and
        _count are exact sums

    Output parses under obs/exposition.parse_text_format — the strict
    round-trip is a test invariant, not a hope."""
    parsed: Dict[str, Dict[str, dict]] = {
        inst: parse_text_format(text) for inst, text in sorted(texts.items())
    }
    # family -> (type, help) from the first instance declaring it
    fam_meta: Dict[str, Tuple[str, str]] = {}
    for inst in sorted(parsed):
        for fam, ent in parsed[inst].items():
            fam_meta.setdefault(fam, (ent["type"], ent["help"]))

    lines: List[str] = []
    for fam in sorted(fam_meta):
        kind, help_text = fam_meta[fam]
        declared = False

        def head():
            nonlocal declared
            if not declared:
                lines.append(f"# HELP {fam} {help_text}")
                lines.append(f"# TYPE {fam} {kind}")
                declared = True

        if kind == COUNTER:
            sums: Dict[tuple, float] = {}
            for inst in sorted(parsed):
                ent = parsed[inst].get(fam)
                if not ent:
                    continue
                for name, labels, value in ent["samples"]:
                    key = _labelset_key(labels)
                    sums[key] = sums.get(key, 0.0) + value
            for key in sorted(sums):
                head()
                lines.append(
                    f"{fam}{_label_str(dict(key))} {_fmt_merged(sums[key])}"
                )
        elif kind == HISTOGRAM:
            # labelset (sans le/instance) -> per-instance bucket maps
            merged: Dict[tuple, dict] = {}
            for inst in sorted(parsed):
                ent = parsed[inst].get(fam)
                if not ent:
                    continue
                per: Dict[tuple, dict] = {}
                for name, labels, value in ent["samples"]:
                    key = _labelset_key(labels, drop=("le",))
                    slot = per.setdefault(
                        key, {"buckets": {}, "sum": 0.0, "count": 0.0}
                    )
                    if name.endswith("_bucket"):
                        le = labels["le"]
                        bound = math.inf if le == "+Inf" else float(le)
                        slot["buckets"][bound] = value
                    elif name.endswith("_sum"):
                        slot["sum"] = value
                    elif name.endswith("_count"):
                        slot["count"] = value
                for key, slot in per.items():
                    merged.setdefault(key, {"series": [], "sum": 0.0,
                                            "count": 0.0})
                    merged[key]["series"].append(slot["buckets"])
                    merged[key]["sum"] += slot["sum"]
                    merged[key]["count"] += slot["count"]
            for key in sorted(merged, key=str):
                slot = merged[key]
                bounds = sorted({b for s in slot["series"] for b in s})
                if not bounds or bounds[-1] != math.inf:
                    bounds.append(math.inf)
                base = dict(key)
                head()
                for b in bounds:
                    total = 0.0
                    for series in slot["series"]:
                        # carry the instance's cumulative count forward
                        # from its largest declared bound <= b
                        at = [sb for sb in series if sb <= b]
                        total += series[max(at)] if at else 0.0
                    le = "+Inf" if b == math.inf else _fmt_bound(b)
                    lines.append(
                        f"{fam}_bucket{_label_str({**base, 'le': le})} "
                        f"{_fmt_merged(total)}"
                    )
                lines.append(
                    f"{fam}_sum{_label_str(base)} "
                    f"{repr(float(slot['sum']))}"
                )
                lines.append(
                    f"{fam}_count{_label_str(base)} "
                    f"{_fmt_merged(slot['count'])}"
                )
        else:  # gauge / summary / untyped: label per instance
            for inst in sorted(parsed):
                ent = parsed[inst].get(fam)
                if not ent:
                    continue
                for name, labels, value in ent["samples"]:
                    head()
                    out = dict(labels)
                    out["instance"] = inst
                    lines.append(
                        f"{name}{_label_str(out)} {_fmt_merged(value)}"
                    )
    return "\n".join(lines) + "\n" if lines else "\n"


def _fmt_bound(b: float) -> str:
    # bucket bounds render like the single-node writer (_fmt on floats)
    return repr(float(b))


# ---------------------------------------------------------------------------
# fleet scraper (the /metrics?fleet=1 backend)
# ---------------------------------------------------------------------------

class FleetScraper:
    """Fan-out + merge for the federated scrape.

    ``peers_fn()`` returns ``{node_id: pull}`` for every ALIVE remote
    member, where ``pull()`` fetches that node's full metrics text over
    the peer wire (T_STATS ``{"metrics": true}``) and raises on any
    failure.  Per-peer failures degrade to the last cached snapshot
    (flagged stale) or drop the instance (flagged unreachable) — the
    merged payload is always a valid 200."""

    def __init__(
        self,
        node_id: str,
        local_text_fn: Callable[[], str],
        peers_fn: Optional[Callable[[], Dict[str, Callable[[], str]]]] = None,
        timeout_s: float = 0.75,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.node_id = node_id or "local"
        self._local_text_fn = local_text_fn
        self._peers_fn = peers_fn
        self.timeout_s = max(0.05, float(timeout_s))
        self._clock = clock
        self._lock = threading.Lock()
        # node_id -> (text, fetched_at): survives a peer dying mid-scrape
        self._cache: Dict[str, Tuple[str, float]] = {}
        # node_id -> parsed families from the last scrape (fleet SLO feed)
        self._last_parsed: Dict[str, Dict[str, dict]] = {}

    def scrape(self) -> str:
        """One federated scrape: local + every ALIVE peer, merged."""
        now = self._clock()
        texts: Dict[str, str] = {}
        unreachable: Dict[str, int] = {}
        staleness: Dict[str, float] = {}

        local_text = self._local_text_fn()
        texts[self.node_id] = local_text
        unreachable[self.node_id] = 0
        staleness[self.node_id] = 0.0

        peers = {}
        if self._peers_fn is not None:
            try:
                peers = dict(self._peers_fn())
            except Exception:  # noqa: BLE001 — a membership bug must not 500 the scrape
                peers = {}
        for nid in sorted(peers):
            if nid == self.node_id:
                continue
            try:
                failpoints.check("obs.fleet.pull")
                text = peers[nid]()
                if not isinstance(text, str):
                    raise TypeError("peer metrics payload is not text")
                parse_text_format(text)  # reject a corrupt peer payload
                with self._lock:
                    self._cache[nid] = (text, now)
                texts[nid] = text
                unreachable[nid] = 0
                staleness[nid] = 0.0
            except Exception:  # noqa: BLE001 — partial-but-honest, never a 500
                unreachable[nid] = 1
                with self._lock:
                    cached = self._cache.get(nid)
                if cached is not None:
                    texts[nid] = cached[0]
                    staleness[nid] = max(0.0, now - cached[1])

        try:
            merged = merge_expositions(texts)
        except Exception:  # noqa: BLE001 — one bad cached text must not 500
            merged = merge_expositions({self.node_id: local_text})
            for nid in list(texts):
                if nid != self.node_id:
                    unreachable[nid] = 1
                    staleness.pop(nid, None)

        with self._lock:
            self._last_parsed = {
                inst: parse_text_format(t) for inst, t in texts.items()
            }

        lines = [merged.rstrip("\n")] if merged.strip() else []
        fam = registry.PROM_FAMILIES["banjax_fleet_peer_unreachable"]
        lines.append(f"# HELP {fam.prom} {fam.help}")
        lines.append(f"# TYPE {fam.prom} {fam.kind}")
        for nid in sorted(unreachable):
            lines.append(
                f'{fam.prom}{{instance="{_esc(nid)}"}} {unreachable[nid]}'
            )
        fam = registry.PROM_FAMILIES["banjax_fleet_peer_staleness_seconds"]
        lines.append(f"# HELP {fam.prom} {fam.help}")
        lines.append(f"# TYPE {fam.prom} {fam.kind}")
        for nid in sorted(staleness):
            lines.append(
                f'{fam.prom}{{instance="{_esc(nid)}"}} '
                f"{_fmt_merged(staleness[nid])}"
            )
        return "\n".join(lines) + "\n"

    # ---- fleet SLO feed ----

    _SLO_COUNTERS = {
        "admitted": "banjax_pipeline_admitted_lines_total",
        "processed": "banjax_pipeline_processed_lines_total",
        "stale": "banjax_pipeline_stale_dropped_lines_total",
    }
    _SLO_SHED = (
        "banjax_pipeline_shed_lines_total",
        "banjax_pipeline_drain_error_lines_total",
    )

    def fleet_collect(self) -> Dict[str, float]:
        """Cluster-wide counter sums from the last scrape, shaped for
        obs/slo.py ``collect_fn`` — the fleet-mode SloEngine burns the
        merged shed/stale streams exactly like a node burns its own."""
        with self._lock:
            parsed = self._last_parsed
        if not parsed:
            return {}

        def total(fam_name: str) -> float:
            out = 0.0
            for fams in parsed.values():
                ent = fams.get(fam_name)
                if ent:
                    out += sum(v for _, _, v in ent["samples"])
            return out

        vals: Dict[str, float] = {
            key: total(fam) for key, fam in self._SLO_COUNTERS.items()
        }
        vals["shed"] = sum(total(f) for f in self._SLO_SHED)
        return vals


# ---------------------------------------------------------------------------
# cluster incident capture (T_FLIGHTREC fan-out + per-node snapshot)
# ---------------------------------------------------------------------------

PEER_CAPTURE_FILES = (
    "trace.json", "metrics.prom", "provenance.json", "fabric.json",
)


def local_capture_files(
    metrics_text_fn: Optional[Callable[[], str]] = None,
    fabric_fn: Optional[Callable[[], Optional[dict]]] = None,
    provenance_tail: int = 256,
) -> Dict[str, str]:
    """This node's contribution to a REMOTE incident bundle — the body
    of a T_FLIGHTREC_R reply.  Mirrors obs/flightrec.FlightRecorder.
    _capture's per-file shape so the ``peers/<nid>/`` tree reads like a
    miniature bundle; every read is guarded — a partial snapshot beats
    none."""
    from banjax_tpu_torch.obs import provenance, trace

    files: Dict[str, str] = {}
    try:
        files["trace.json"] = json.dumps(
            trace.get_tracer().export_chrome(), separators=(",", ":")
        )
    except Exception as e:  # noqa: BLE001 — partial snapshot beats none
        files["trace.json"] = json.dumps({"error": str(e)})
    if metrics_text_fn is not None:
        try:
            files["metrics.prom"] = metrics_text_fn()
        except Exception as e:  # noqa: BLE001
            files["metrics.prom"] = f"# capture failed: {e}\n"
    try:
        ledger = provenance.get_ledger()
        files["provenance.json"] = json.dumps(
            {
                "records": ledger.tail(provenance_tail),
                "counters": {
                    f"{src}/{dec}": v
                    for (src, dec), v in sorted(ledger.counters().items())
                },
            },
            indent=1,
        )
    except Exception as e:  # noqa: BLE001
        files["provenance.json"] = json.dumps({"error": str(e)})
    if fabric_fn is not None:
        try:
            fabric = fabric_fn()
        except Exception as e:  # noqa: BLE001
            fabric = {"enabled": False, "error": str(e)}
        files["fabric.json"] = json.dumps(
            fabric if fabric is not None else {"enabled": False},
            indent=1, default=str,
        )
    return files


def capture_fleet(
    incident_id: str,
    peers_fn: Callable[[], Dict[str, Callable[[str], Dict[str, str]]]],
) -> Dict[str, Dict[str, str]]:
    """Fan an incident capture out to every ALIVE peer.

    ``peers_fn()`` returns ``{node_id: capture}`` where
    ``capture(incident_id)`` performs the T_FLIGHTREC exchange and
    returns that peer's file map.  A failed peer contributes an
    ``error.txt`` instead of vanishing — the bundle records who could
    not answer, which during a shard failure is itself evidence."""
    out: Dict[str, Dict[str, str]] = {}
    try:
        peers = dict(peers_fn())
    except Exception:  # noqa: BLE001 — capture must never take down its trigger
        return out
    for nid in sorted(peers):
        try:
            failpoints.check("obs.fleet.capture")
            files = peers[nid](incident_id)
            if not isinstance(files, dict):
                raise TypeError("peer capture payload is not a file map")
            out[nid] = {
                str(fname): str(content)
                for fname, content in files.items()
                if str(fname) == str(fname).strip("/")
                and ".." not in str(fname)
            }
        except Exception as e:  # noqa: BLE001 — a dead peer is evidence, not an abort
            out[nid] = {"error.txt": f"capture failed: {e}\n"}
    return out
