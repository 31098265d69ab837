"""The 29-second JSON metrics line (a copy of `banjax_tpu/obs/metrics.py`).

Reference behavior (Go banjax): banjax.go:231-275 and config.go:150-181:
every 29 s one JSON object {Time, LenExpiringChallenges,
LenExpiringBlocks, LenIpToRegexStates, LenFailedChallengeStates} is
written to `metrics_log_file` (or `list-metrics.log` in standalone
testing). The reference's five keys keep their names and meaning; the
matcher's, pipeline's, challenge plane's, serving fast path's, kernel
edge's and health keys are additive, each present when its source is.

Every key the line can emit is declared in `obs/registry.py`, the same
registry `/metrics` renders from. The line takes the resetting interval
views (`snapshot()`); `/metrics` reads only the non-destructive `peek()`
views. Neither touches the card: the values are host counters, and the
traffic sketch is read through its throttled `pull`. The serving and
kernel-edge counters belong to the app (`serve_stats`, `ipset_stats`),
not to process-wide singletons. `KafkaSkippedBatches` shows only when
nonzero (the wire client's module count), and the multi-process worker
keys only when a supervisor runs, as in JAX; the fabric's keys
(`fabric/stats.py` `FabricStats.peek`) when a fabric runs.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Optional, TextIO

from banjax_tpu_torch.challenge.stats import get_stats as challenge_stats
from banjax_tpu_torch.ingest import kafka_wire

REPORT_INTERVAL_SECONDS = 29  # banjax.go:196


def write_metrics_line(
    out: TextIO,
    dynamic_lists,
    regex_states,
    failed_challenge_states,
    matcher=None,
    health=None,
    pipeline=None,
    serve_stats=None,
    ipset_stats=None,
    supervisor=None,
    fabric=None,
) -> None:
    challenges, blocks = dynamic_lists.metrics()
    line = {
        "Time": time.strftime("%a, %d %b %Y %H:%M:%S %Z"),
        "LenExpiringChallenges": challenges,
        "LenExpiringBlocks": blocks,
        "LenIpToRegexStates": len(regex_states),
        "LenFailedChallengeStates": len(failed_challenge_states),
    }
    if matcher is not None:
        line.update(matcher.stats.snapshot(getattr(matcher, "device_windows", None), matcher))
    if pipeline is not None:
        line.update(pipeline.snapshot())
    if fabric is not None:
        # routed, forwarded and shed line counts, replication and takeovers
        line.update(fabric.peek())
    # the challenge plane: present once this process touched it, so the
    # reference's exact key set holds otherwise
    chal = challenge_stats()
    if chal.active():
        snap = chal.prom_snapshot()
        line["ChallengeIssued"] = snap["issued_total"]
        line["ChallengeVerifications"] = snap["verifications_total"]
        line["ChallengeFailureStateEntries"] = snap["failure_state_entries"]
        line["ChallengeFailureEvictions"] = snap["failure_evictions_total"]
    if serve_stats is not None and serve_stats.active():
        snap = serve_stats.snapshot()
        line["ServeFastpathHits"] = snap["hits_total"]
        line["ServeFastpathMisses"] = snap["misses_total"]
        line["ServeFastpathFaults"] = snap["faults_total"]
        line["ServeTableEntries"] = snap["table_entries"]
        line["ServeTableDropped"] = snap["table_dropped_total"]
        line["ServeMirrorErrors"] = snap["mirror_errors_total"]
    if ipset_stats is not None and ipset_stats.active():
        snap = ipset_stats.prom_snapshot()
        line["IpsetBatchSends"] = snap["batch_sends_total"]
        line["IpsetBatchEntries"] = snap["batch_entries_total"]
        line["IpsetErrors"] = snap["errors_total"]
        line["IpsetFallbacks"] = snap["fallback_total"]
        line["IpsetQueueShed"] = snap["queue_shed_total"]
    # Kafka batches skipped for an undecodable codec: only when nonzero,
    # so the reference's exact key set holds on clean streams
    skipped = kafka_wire.skipped_batch_count()
    if skipped:
        line["KafkaSkippedBatches"] = skipped
    if supervisor is not None:
        # multi-process serving: nonzero respawns = workers crashed and healed
        line["HttpWorkers"] = supervisor.n_workers
        line["HttpWorkerRespawns"] = supervisor.respawn_count
        line["HttpFcDropped"] = getattr(failed_challenge_states, "dropped", 0)
    if health is not None:
        # the /healthz aggregate, flattened onto the line
        snap = health.snapshot()
        line["HealthStatus"] = snap["status"]
        for name, comp in sorted(snap["components"].items()):
            line[f"Health_{name}"] = comp["status"]
    out.write(json.dumps(line) + "\n")
    out.flush()


class MetricsReporter:
    """Writes the line every `interval_seconds` from a thread of its own.
    The sources are getters where a reload swaps them (the matcher)."""

    def __init__(
        self,
        log_path: str,
        dynamic_lists,
        regex_states,
        failed_challenge_states,
        interval_seconds: float = REPORT_INTERVAL_SECONDS,
        matcher_getter: Optional[Callable[[], object]] = None,
        health=None,
        pipeline_getter: Optional[Callable[[], object]] = None,
        serve_stats=None,
        ipset_stats=None,
        supervisor_getter: Optional[Callable[[], object]] = None,
        fabric_getter: Optional[Callable[[], object]] = None,
    ):
        self.log_path = log_path
        self.dynamic_lists = dynamic_lists
        self.regex_states = regex_states
        self.failed_challenge_states = failed_challenge_states
        self.interval_seconds = interval_seconds
        self.matcher_getter = matcher_getter
        self.health = health
        self.pipeline_getter = pipeline_getter
        self.serve_stats = serve_stats
        self.ipset_stats = ipset_stats
        self.supervisor_getter = supervisor_getter
        self.fabric_getter = fabric_getter
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if not self.log_path:
            return
        self._thread = threading.Thread(target=self._run, name="metrics-reporter", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None

    def _run(self) -> None:
        with open(self.log_path, "w", encoding="utf-8") as out:
            while not self._stop.wait(self.interval_seconds):
                write_metrics_line(
                    out, self.dynamic_lists, self.regex_states, self.failed_challenge_states,
                    self.matcher_getter() if self.matcher_getter else None,
                    self.health,
                    self.pipeline_getter() if self.pipeline_getter else None,
                    self.serve_stats, self.ipset_stats,
                    self.supervisor_getter() if self.supervisor_getter else None,
                    self.fabric_getter() if self.fabric_getter else None,
                )
