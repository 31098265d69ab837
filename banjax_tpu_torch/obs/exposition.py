"""Prometheus text-format exposition for the /metrics route (a copy of
`banjax_tpu/obs/exposition.py`).

Pull-based exposition (format 0.0.4) over the accumulators the 29 s line
snapshots, read only through the non-destructive `peek()` views, so any
number of scrapers can pull at any cadence beside the line's single
periodic consumer. No read here synchronizes the card: the values are
host counters and mirrors, and the traffic sketch is read through its
throttled `pull` (one compact copy at most every
`traffic_sketch_pull_seconds`, counted in `banjax_traffic_sketch_pull_
bytes_total`).

Every family is declared in `obs/registry.py`; the renderer walks the
registry, so an undeclared family cannot be emitted. The serving and
kernel-edge counters are the app's (`serve_stats`, `ipset_stats`); the
worker families show when a supervisor runs; the fabric families
(scalars, per-peer gauges and the takeover, detection, frame-size and ack
RTT histograms) when a fabric runs. The federated `/metrics?fleet=1`
payload is `obs/fleet.py`'s merge of such texts. The scenario families
show once this process ran a scenario (`scenarios/stats.py`).

`parse_text_format()` is the strict parser the tests use: name and
label syntax, HELP/TYPE placement, histogram bucket monotonicity and
the `le="+Inf"` == count invariant.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional

from banjax_tpu_torch.challenge.stats import get_stats as challenge_stats
from banjax_tpu_torch.ingest import kafka_wire
from banjax_tpu_torch.obs import provenance
from banjax_tpu_torch.obs import registry
from banjax_tpu_torch.obs.registry import COUNTER, FAMILIES, GAUGE, HISTOGRAM, Histogram
from banjax_tpu_torch.resilience.breaker import CLOSED, HALF_OPEN, OPEN
from banjax_tpu_torch.scenarios.stats import get_stats as scenario_stats

_HEALTH_LEVELS = {"healthy": 0, "degraded": 1, "failed": 2, "unknown": 1}
_BREAKER_STATES = (CLOSED, OPEN, HALF_OPEN)


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def _esc(label_value: str) -> str:
    return (str(label_value).replace("\\", "\\\\")
            .replace("\n", "\\n").replace('"', '\\"'))


def _labels(pairs: Dict[str, object]) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in pairs.items()) + "}"


class _Writer:
    def __init__(self):
        self.lines: List[str] = []
        self._declared = set()

    def head(self, fam) -> None:
        if fam.prom in self._declared:
            return
        self._declared.add(fam.prom)
        self.lines.append(f"# HELP {fam.prom} {fam.help}")
        self.lines.append(f"# TYPE {fam.prom} {fam.kind}")

    def sample(self, fam, value, labels: Optional[dict] = None) -> None:
        self.head(fam)
        self.lines.append(f"{fam.prom}{_labels(labels or {})} {_fmt(value)}")

    def histogram(self, fam, hist: Histogram, labels: Optional[dict] = None) -> None:
        self.head(fam)
        bounds, cum, total_sum, count = hist.snapshot()
        base = dict(labels or {})
        for b, c in zip(bounds, cum):
            self.lines.append(f"{fam.prom}_bucket{_labels({**base, 'le': _fmt(float(b))})} {c}")
        self.lines.append(f"{fam.prom}_bucket{_labels({**base, 'le': '+Inf'})} {count}")
        self.lines.append(f"{fam.prom}_sum{_labels(base)} {_fmt(total_sum)}")
        self.lines.append(f"{fam.prom}_count{_labels(base)} {count}")

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def render_prometheus(
    dynamic_lists,
    regex_states,
    failed_challenge_states,
    matcher=None,
    pipeline=None,
    health=None,
    slo=None,
    flightrec=None,
    serve_stats=None,
    ipset_stats=None,
    supervisor=None,
    fabric=None,
) -> str:
    """The whole /metrics payload from the sources the metrics line reads
    (`obs/metrics.write_metrics_line`), through non-destructive reads."""
    values: Dict[str, object] = {}
    challenges, blocks = dynamic_lists.metrics()
    values["LenExpiringChallenges"] = challenges
    values["LenExpiringBlocks"] = blocks
    values["LenIpToRegexStates"] = len(regex_states)
    values["LenFailedChallengeStates"] = len(failed_challenge_states)
    if matcher is not None:
        values.update(matcher.stats.peek(getattr(matcher, "device_windows", None), matcher))
    if pipeline is not None:
        values.update(pipeline.prom_snapshot())
    values["KafkaSkippedBatches"] = kafka_wire.skipped_batch_count()
    if fabric is not None:
        values.update(fabric.peek())
    if supervisor is not None:
        values["HttpWorkers"] = supervisor.n_workers
        values["HttpWorkerRespawns"] = supervisor.respawn_count
        values["HttpFcDropped"] = getattr(failed_challenge_states, "dropped", 0)

    w = _Writer()
    breaker_state = values.pop("MatcherBreakerState", None)
    for fam in FAMILIES:
        if not fam.prom or fam.kind == HISTOGRAM or fam.labels:
            continue
        if fam.line_key and fam.line_key in values:
            v = values[fam.line_key]
            if v is not None:
                w.sample(fam, v)

    # the breaker state, one-hot by state label
    if breaker_state is not None:
        fam = registry.PROM_FAMILIES["banjax_matcher_breaker_state"]
        for s in _BREAKER_STATES:
            w.sample(fam, 1 if breaker_state == s else 0, {"state": s})

    if pipeline is not None:
        fracs = pipeline.stats.worker_busy_fractions()
        if fracs:
            fam = registry.PROM_FAMILIES["banjax_encode_worker_busy_fraction"]
            for k, frac in enumerate(fracs):
                w.sample(fam, frac, {"worker": str(k)})

    # per-rule match pressure from the sketch's last compact pull; only
    # rules with any pressure emit
    sketch = getattr(matcher, "traffic_sketch", None) if matcher else None
    if sketch is not None:
        try:
            pressure = sketch.pull().get("rule_pressure", ())
        except Exception:  # noqa: BLE001 — telemetry must not break a scrape
            pressure = ()
        if pressure:
            fam = registry.PROM_FAMILIES["banjax_traffic_rule_pressure"]
            for row in sorted(pressure, key=lambda r: r["rule"]):
                w.sample(fam, row["events"], {"rule": row["rule"]})

    prov_counters = provenance.get_ledger().counters()
    if prov_counters:
        fam = registry.PROM_FAMILIES["banjax_decision_inserts_total"]
        for (source, decision), v in sorted(prov_counters.items()):
            w.sample(fam, v, {"source": source, "decision": decision})

    if slo is not None:
        burn_fam = registry.PROM_FAMILIES["banjax_slo_burn_rate"]
        for slo_name, windows in sorted(slo.burn_rates().items()):
            for window, rate in sorted(windows.items()):
                w.sample(burn_fam, rate, {"slo": slo_name, "window": window})
        breach_fam = registry.PROM_FAMILIES["banjax_slo_breached"]
        for slo_name, hit in sorted(slo.breached().items()):
            w.sample(breach_fam, 1 if hit else 0, {"slo": slo_name})

    if flightrec is not None:
        w.sample(registry.PROM_FAMILIES["banjax_flightrec_incidents_total"],
                 flightrec.incident_count)

    # the scenario harness: last-run rows per attack shape, once this
    # process ran a scenario
    scen = scenario_stats().prom_snapshot()
    if scen["runs_total"]:
        w.sample(registry.PROM_FAMILIES["banjax_scenario_runs_total"], scen["runs_total"])
        w.sample(registry.PROM_FAMILIES["banjax_scenario_injected_episodes_total"],
                 scen["episodes_total"])
        w.sample(registry.PROM_FAMILIES["banjax_scenario_invariant_failures_total"],
                 scen["invariant_failures_total"])
        per_gauge = {
            "lines_per_sec": "banjax_scenario_lines_per_sec",
            "shed_ratio": "banjax_scenario_shed_ratio",
            "precision": "banjax_scenario_ban_precision",
            "recall": "banjax_scenario_ban_recall",
            "slo_burn_peak": "banjax_scenario_slo_burn_peak",
        }
        for name, row in sorted(scen["scenarios"].items()):
            for field, fam_name in per_gauge.items():
                if field in row:
                    w.sample(registry.PROM_FAMILIES[fam_name], row[field], {"scenario": name})

    # the challenge plane, once this process touched it
    chal = challenge_stats()
    if chal.active():
        snap = chal.prom_snapshot()
        w.sample(registry.PROM_FAMILIES["banjax_challenge_issued_total"], snap["issued_total"])
        fam = registry.PROM_FAMILIES["banjax_challenge_verifications_total"]
        for (result, path), v in sorted(snap["verifications"].items()):
            w.sample(fam, v, {"result": result, "path": path})
        w.sample(registry.PROM_FAMILIES["banjax_challenge_failure_state_entries"],
                 snap["failure_state_entries"])
        w.sample(registry.PROM_FAMILIES["banjax_challenge_failure_evictions_total"],
                 snap["failure_evictions_total"])
        w.histogram(registry.PROM_FAMILIES["banjax_challenge_verify_batch_size"],
                    chal.verify_batch_size)

    # the serving fast path, once consulted or with a table attached
    if serve_stats is not None and serve_stats.active():
        snap = serve_stats.snapshot()
        fam = registry.PROM_FAMILIES["banjax_serve_fastpath_hits_total"]
        for tier, v in sorted(snap["hits"].items()):
            w.sample(fam, v, {"tier": tier})
        fam = registry.PROM_FAMILIES["banjax_serve_fastpath_misses_total"]
        for reason, v in sorted(snap["misses"].items()):
            w.sample(fam, v, {"reason": reason})
        for key, name in (
            ("faults_total", "banjax_serve_fastpath_faults_total"),
            ("table_entries", "banjax_serve_fastpath_table_entries"),
            ("table_dropped_total", "banjax_serve_fastpath_table_dropped_total"),
            ("table_session_entries", "banjax_serve_fastpath_table_session_entries"),
            ("mirror_errors_total", "banjax_serve_fastpath_mirror_errors_total"),
        ):
            w.sample(registry.PROM_FAMILIES[name], snap[key])

    # the kernel edge, once the batch writer exists or anything counted
    if ipset_stats is not None and ipset_stats.active():
        snap = ipset_stats.prom_snapshot()
        w.sample(registry.PROM_FAMILIES["banjax_ipset_batch_sends_total"],
                 snap["batch_sends_total"])
        w.sample(registry.PROM_FAMILIES["banjax_ipset_batch_entries_total"],
                 snap["batch_entries_total"])
        fam = registry.PROM_FAMILIES["banjax_ipset_errors_total"]
        for path, v in sorted(snap["errors"].items()):
            w.sample(fam, v, {"path": path})
        w.sample(registry.PROM_FAMILIES["banjax_ipset_fallback_total"], snap["fallback_total"])
        w.sample(registry.PROM_FAMILIES["banjax_ipset_queue_shed_total"],
                 snap["queue_shed_total"])
        w.sample(registry.PROM_FAMILIES["banjax_ipset_queue_depth"], snap["queue_depth"])

    # the fabric: per-peer liveness and membership gauges, the wire's
    # frames by version and transport, the fleet health bits, and the
    # takeover, detection, frame-size and ack RTT histograms
    if fabric is not None:
        peers = fabric.peers_snapshot()
        if peers:
            fam = registry.PROM_FAMILIES["banjax_fabric_peer_up"]
            for pid, up in sorted(peers.items()):
                w.sample(fam, 1 if up else 0, {"peer": pid})
        w.histogram(registry.PROM_FAMILIES["banjax_fabric_takeover_duration_seconds"],
                    fabric.takeover_duration)
        states = fabric.member_states_snapshot()
        if states:
            fam = registry.PROM_FAMILIES["banjax_fabric_membership_state"]
            enc = {"alive": 0, "suspect": 1, "dead": 2, "left": 3}
            for pid, state in sorted(states.items()):
                w.sample(fam, enc.get(state, 2), {"peer": pid})
        w.histogram(registry.PROM_FAMILIES["banjax_fabric_membership_detection_seconds"],
                    fabric.detection_time)
        frames = fabric.frames_snapshot()
        if frames:
            fam = registry.PROM_FAMILIES["banjax_fabric_frames_total"]
            for (version, transport), n in sorted(frames.items()):
                w.sample(fam, n, {"version": version, "transport": transport})
        w.histogram(registry.PROM_FAMILIES["banjax_fabric_frame_bytes"], fabric.frame_bytes)
        w.histogram(registry.PROM_FAMILIES["banjax_fabric_ack_rtt_seconds"], fabric.ack_rtt)
        peer_health = fabric.peer_health_snapshot()
        if peer_health:
            fam = registry.PROM_FAMILIES["banjax_fabric_peer_health"]
            for nid, bits in sorted(peer_health.items()):
                w.sample(fam, bits, {"node": nid})

    # component health: the aggregate and one labeled gauge a component
    if health is not None:
        snap = health.snapshot()
        w.sample(registry.PROM_FAMILIES["banjax_health_status"],
                 _HEALTH_LEVELS.get(snap["status"], 1))
        comp_fam = registry.PROM_FAMILIES["banjax_health_component_status"]
        for name, comp in sorted(snap["components"].items()):
            w.sample(comp_fam, _HEALTH_LEVELS.get(comp["status"], 1), {"component": name})

    # histograms
    if matcher is not None:
        w.histogram(registry.PROM_FAMILIES["banjax_batch_latency_seconds"],
                    matcher.stats.batch_latency_hist)
    if pipeline is not None:
        w.histogram(registry.PROM_FAMILIES["banjax_device_stage_latency_seconds"],
                    pipeline.stats.device_latency_hist)
        stage_fam = registry.PROM_FAMILIES["banjax_stage_duration_seconds"]
        for stage, hist in pipeline.stats.stage_hists.items():
            w.histogram(stage_fam, hist, {"stage": stage})
        e2e_fam = registry.PROM_FAMILIES["banjax_e2e_latency_seconds"]
        for hop, hist in pipeline.stats.e2e_hists.items():
            w.histogram(e2e_fam, hist, {"hop": hop})
    return w.text()


# ---- the strict text-format parser (tests, scrape debugging) ----

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>\S+)(?: (?P<ts>-?\d+))?$"
)
_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(?:,|$)'
)


class ExpositionError(ValueError):
    pass


def _family_of(sample_name: str, types: Dict[str, str]) -> str:
    """Map a sample name to its family (histogram samples use the
    _bucket/_sum/_count suffixes)."""
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if types.get(base) == HISTOGRAM:
                return base
    return sample_name


def parse_text_format(text: str) -> Dict[str, dict]:
    """Parse + validate Prometheus text format strictly.

    Returns {family: {"type", "help", "samples": [(name, labels, value)]}}.
    Raises ExpositionError on: missing trailing newline, samples without
    a preceding TYPE, bad metric/label syntax, unparsable values,
    histogram buckets that are non-monotone / missing +Inf / +Inf !=
    count, or a family declared twice.
    """
    if not text.endswith("\n"):
        raise ExpositionError("exposition must end with a newline")
    helps: Dict[str, str] = {}
    types: Dict[str, str] = {}
    fams: Dict[str, dict] = {}
    for ln, raw in enumerate(text.split("\n")[:-1], 1):
        if not raw:
            continue
        if raw.startswith("# HELP "):
            rest = raw[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            if not _NAME_RE.match(name):
                raise ExpositionError(f"line {ln}: bad HELP name {name!r}")
            if name in helps:
                raise ExpositionError(f"line {ln}: duplicate HELP {name}")
            helps[name] = help_text
            continue
        if raw.startswith("# TYPE "):
            rest = raw[len("# TYPE "):]
            name, _, kind = rest.partition(" ")
            if not _NAME_RE.match(name):
                raise ExpositionError(f"line {ln}: bad TYPE name {name!r}")
            if kind not in (COUNTER, GAUGE, HISTOGRAM, "summary", "untyped"):
                raise ExpositionError(f"line {ln}: bad TYPE kind {kind!r}")
            if name in types:
                raise ExpositionError(f"line {ln}: duplicate TYPE {name}")
            types[name] = kind
            fams[name] = {"type": kind, "help": helps.get(name, ""),
                          "samples": []}
            continue
        if raw.startswith("#"):
            continue  # plain comment
        m = _SAMPLE_RE.match(raw)
        if not m:
            raise ExpositionError(f"line {ln}: unparsable sample {raw!r}")
        name = m.group("name")
        labels: Dict[str, str] = {}
        label_text = m.group("labels")
        if label_text:
            pos = 0
            while pos < len(label_text):
                lm = _LABEL_RE.match(label_text, pos)
                if lm is None:
                    raise ExpositionError(
                        f"line {ln}: bad label syntax {label_text!r}"
                    )
                labels[lm.group(1)] = (
                    lm.group(2).replace('\\"', '"')
                    .replace("\\n", "\n").replace("\\\\", "\\")
                )
                pos = lm.end()
        vtext = m.group("value")
        try:
            value = float(vtext) if vtext not in ("+Inf", "-Inf", "NaN") else (
                math.inf if vtext == "+Inf"
                else (-math.inf if vtext == "-Inf" else math.nan)
            )
        except ValueError:
            raise ExpositionError(
                f"line {ln}: unparsable value {vtext!r}"
            ) from None
        family = _family_of(name, types)
        if family not in fams:
            raise ExpositionError(
                f"line {ln}: sample {name!r} precedes its TYPE declaration"
            )
        fams[family]["samples"].append((name, labels, value))

    # histogram invariants, per label set
    for family, ent in fams.items():
        if ent["type"] != HISTOGRAM:
            if ent["type"] == COUNTER:
                for name, labels, value in ent["samples"]:
                    if value < 0:
                        raise ExpositionError(
                            f"counter {name} negative: {value}"
                        )
            continue
        by_labelset: Dict[tuple, dict] = {}
        for name, labels, value in ent["samples"]:
            key = tuple(sorted(
                (k, v) for k, v in labels.items() if k != "le"
            ))
            slot = by_labelset.setdefault(
                key, {"buckets": [], "sum": None, "count": None}
            )
            if name.endswith("_bucket"):
                if "le" not in labels:
                    raise ExpositionError(f"{name}: bucket without le label")
                le = labels["le"]
                bound = math.inf if le == "+Inf" else float(le)
                slot["buckets"].append((bound, value))
            elif name.endswith("_sum"):
                slot["sum"] = value
            elif name.endswith("_count"):
                slot["count"] = value
        for key, slot in by_labelset.items():
            buckets = slot["buckets"]
            if not buckets or buckets[-1][0] != math.inf:
                raise ExpositionError(
                    f"{family}{dict(key)}: missing le=+Inf bucket"
                )
            bounds = [b for b, _ in buckets]
            if bounds != sorted(bounds):
                raise ExpositionError(
                    f"{family}{dict(key)}: bucket bounds out of order"
                )
            counts = [c for _, c in buckets]
            if any(b > a for a, b in zip(counts[1:], counts)):
                raise ExpositionError(
                    f"{family}{dict(key)}: bucket counts not monotone"
                )
            if slot["count"] is None or slot["sum"] is None:
                raise ExpositionError(
                    f"{family}{dict(key)}: missing _sum/_count"
                )
            if counts[-1] != slot["count"]:
                raise ExpositionError(
                    f"{family}{dict(key)}: +Inf bucket {counts[-1]} != "
                    f"count {slot['count']}"
                )
    return fams
