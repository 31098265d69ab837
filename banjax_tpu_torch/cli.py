"""Entry points of the port: `build_matcher`, `build_decision_chain` and
the service around both, `BanjaxApp` (a copy of `banjax_tpu/cli.py`'s).

Reference behavior (Go banjax): banjax.go:66-275 — parse the three flags,
build the shared state, start the HTTP server and the log tailer,
reload the config on SIGHUP and stop on SIGINT/SIGTERM.

    python -m banjax_tpu_torch.cli -config-file <path> [-standalone-testing] [-debug]

The app runs on the card: the tailer feeds `TorchMatcher` (kernels A and
B), whose bans go to the ban-log files and, through the dynamic lists,
into the serving fast path's decision table; `/auth_request` answers
from that table or through the chain, whose PoW check is kernel C. With
`pipeline_enabled: true` the tailer submits to the streaming pipeline
(`pipeline/scheduler.py`: encode, device and drain threads) instead of
consuming each batch itself. The config's `failpoints` spec is armed at
start and re-armed on a reload that changes it.

The kernel edge: outside standalone testing the app creates the ipset
and its DROP rule (`effectors/ipset.py` `init_ipset`, through the `ipset`
and `iptables` binaries on `PATH`; a failure raises) and, with
`ipset_netlink_enabled`, an `IpsetBatchWriter` that the Banner's bans go
through. The observability plane: the span tracer and the provenance
ledger are configured from the config (process-wide, as in JAX), the
SLO engine samples every `slo_sample_seconds`, the flight recorder is
installed when `flightrec_dir` is set, and the metrics reporter writes
the 29 s line to `metrics_log_file` (`list-metrics.log` in standalone
testing). The kernel edge's and the serving path's counters are the
app's own. Pass `device="cpu"` to `BanjaxApp` to run the plain PyTorch
versions on the host, as the tests do.

The Kafka channel (`ingest/kafka_io.py`): unless `disable_kafka`, the app
runs the command reader (into the pipeline's command lane when
`pipeline_enabled` and `pipeline_kafka` are set, else inline), the report
writer (unless `disable_kafka_writer`) and the 19 s `status` heartbeat,
with health components `kafka-reader` and `kafka-writer`.

Multi-process serving (`httpapi/workers.py`): `http_workers` N > 0 (-1:
one per extra core; below -1 a warning and single-process serving) puts
the failed-challenge state and the decision table in named shared
memory, replicates the dynamic lists to the workers, and has a
`PrimarySupervisor` start N `SO_REUSEPORT` worker processes on the port
the primary bound. A table that cannot be created raises (the JAX app
falls back to single-process serving, or to the chain).

The decision fabric (`fabric/`): with `fabric_enabled: true` each shard
is one process of this app. Its `FabricService` listens on
`fabric_listen` before the tailer feeds; the tailer's lines go through
its router, which keeps the lines this shard owns on the consistent-hash
ring and forwards the rest to their owners; every decision is also
published to the Kafka command topic (the banner is wrapped before the
first matcher build) and the reader's dispatch goes through the fabric's
deduper. A dead shard's range is taken over by its ring successors,
which replay their forward journal through their matcher. With the
pipeline off, the tailer thread and the fabric's connection threads both
feed the matcher: the port serialises that entry with one lock (the JAX
runner takes none). Fleet observability: `/metrics?fleet=1`
(`fleet_metrics_enabled`), the fleet SLO engine, the flight recorder's
`fabric.json` and `peers/<node>/` capture (`flightrec_fleet_capture`),
and the origin resolver that puts a forwarded line's origin node and
trace id on its ban's provenance record.

    python -m banjax_tpu_torch.cli -config-file shard-a.yaml [-port 8082] [-device cpu]

(`-port` and `-device`, which the reference has not, give co-located
shards an HTTP port each, and let a rehearsal run the plain versions.)
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import logging
import os
import signal
import sys
import threading
import time
from typing import TYPE_CHECKING, Optional

from banjax_tpu_torch.effectors.ipset import init_ipset

if TYPE_CHECKING:
    from banjax_tpu_torch.device import DeviceLike

log = logging.getLogger(__name__)

KAFKA_STATUS_INTERVAL_SECONDS = 19  # banjax.go:204


def http_worker_count(configured: int) -> int:
    """The number of worker processes `http_workers` asks for: -1 is one
    per core past the first, below -1 warns and serves single-process
    (`banjax_tpu/cli.py:128-137`)."""
    if configured == -1:
        return max(0, (os.cpu_count() or 1) - 1)
    if configured < -1:
        log.warning("http_workers=%d is out of range (only -1 means auto); "
                    "serving single-process", configured)
        return 0
    return configured


def build_matcher(config, banner, static_lists, regex_states=None, device: DeviceLike = None,
                  health=None):
    """The Matcher seam flag: `matcher: cpu` (the schema's default) builds
    the host matcher (`CpuMatcher`: Python `re` and `regex_states`, no
    device); `matcher: tpu` the device matcher, which the port runs on the
    card (or on the CPU when `device="cpu"`) and which steps
    `regex_states` on the host when `matcher_device_windows` is off.
    `regex_states` (a RegexRateLimitStates) defaults to a fresh one.
    `health` (a HealthRegistry) gets the "matcher" component."""
    from banjax_tpu_torch.decisions.rate_limit import RegexRateLimitStates

    if regex_states is None:
        regex_states = RegexRateLimitStates()
    if config.matcher == "tpu":
        from banjax_tpu_torch.matcher.runner import TorchMatcher

        return TorchMatcher(config, banner, static_lists, regex_states, device=device,
                            health=health)
    from banjax_tpu_torch.matcher.cpu_ref import CpuMatcher

    if health is not None:
        # the host matcher has no device to fail; registered so that
        # /healthz still lists the component
        health.register("matcher")
    return CpuMatcher(config, banner, static_lists, regex_states)


def build_decision_chain(config, banner, static_lists, device: DeviceLike = None):
    """The `/auth_request` decision chain's state: the Banner's dynamic
    lists (so a TorchMatcher built on the same Banner feeds chain step 7),
    the password-protected paths, the failed-challenge state and the PoW
    verifier, which runs kernel C on the card (or its plain version when
    `device="cpu"`). `config` must carry the pages (`config.load_pages`).
    Raises without a GPU unless `device="cpu"` is passed."""
    from banjax_tpu_torch.challenge.failures import make_failed_challenge_states
    from banjax_tpu_torch.challenge.verifier import from_config
    from banjax_tpu_torch.decisions.protected_paths import PasswordProtectedPaths
    from banjax_tpu_torch.device import resolve_device
    from banjax_tpu_torch.httpapi.decision_chain import ChainState

    dev = resolve_device(device)
    return ChainState(
        config=config,
        static_lists=static_lists,
        dynamic_lists=banner.decision_lists,
        protected_paths=PasswordProtectedPaths(config),
        failed_challenge_states=make_failed_challenge_states(config),
        banner=banner,
        challenge_verifier=from_config(config, dev),
    )


class NoStates:
    """No window states: a serving worker's, whose /rate_limit_states is
    proxied to the primary."""

    def format_states(self) -> str:
        return ""

    def get(self, ip):
        return {}, False

    def __len__(self) -> int:
        return 0


class RegexStatesView:
    """/rate_limit_states and the metrics read the current matcher's
    device windows, or the app's host states when the matcher has none
    (`matcher: cpu`, host windows, or no matcher built yet)."""

    def __init__(self, app: "BanjaxApp"):
        self._app = app

    def _target(self):
        dw = getattr(self._app._matcher, "device_windows", None)
        return dw if dw is not None else self._app.regex_states

    def format_states(self) -> str:
        return self._target().format_states()

    def get(self, ip):
        return self._target().get(ip)

    def __len__(self) -> int:
        return len(self._target())


class BanjaxApp:
    """Builds the shared state and owns the workers' lifecycle (banjax.go main)."""

    def __init__(self, config_file: str, standalone_testing: bool = False,
                 debug: bool = False, device: DeviceLike = None):
        from banjax_tpu_torch.config_holder import ConfigHolder
        from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
        from banjax_tpu_torch.decisions.rate_limit import RegexRateLimitStates
        from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
        from banjax_tpu_torch.device import resolve_device
        from banjax_tpu_torch.effectors.banner import Banner
        from banjax_tpu_torch.effectors.ipset_stats import IpsetStats
        from banjax_tpu_torch.httpapi.serve_stats import ServeFastpathStats
        from banjax_tpu_torch.ingest.tailer import LogTailer
        from banjax_tpu_torch.obs import flightrec, provenance, trace
        from banjax_tpu_torch.obs.metrics import MetricsReporter
        from banjax_tpu_torch.resilience import failpoints
        from banjax_tpu_torch.resilience.health import HealthRegistry

        self.device = resolve_device(device)
        log.info("INIT: config file: %s", config_file)
        self.config_holder = ConfigHolder(config_file, standalone_testing, debug)
        config = self.config_holder.get()
        self.health = HealthRegistry()
        self._failpoints_spec = config.failpoints
        if self._failpoints_spec:
            failpoints.arm_from_spec(self._failpoints_spec)
        # the span tracer (off by default: its no-op fast path) and the
        # provenance ledger (on by default: it records decisions, not lines)
        trace.configure(enabled=config.trace_enabled, ring_size=config.trace_ring_size,
                        jax_annotations=config.trace_jax_annotations)
        provenance.configure(enabled=config.provenance_enabled,
                             ring_size=config.provenance_ring_size)
        self.static_lists = StaticDecisionLists(config)
        # the host window states: made once, so they outlive a reload's
        # matcher rebuild (the JAX app's)
        self.regex_states = RegexRateLimitStates()
        # multi-process serving: the workers' replicas follow these lists
        # through the supervisor's broadcast
        self._supervisor = None
        self._n_http_workers = http_worker_count(config.http_workers)
        if self._n_http_workers > 0:
            from banjax_tpu_torch.httpapi.workers import ReplicatedDynamicLists

            self.dynamic_lists = ReplicatedDynamicLists()
        else:
            self.dynamic_lists = DynamicDecisionLists()
        self.serve_stats = ServeFastpathStats()

        # the serving fast path: the dynamic lists mirror every insert and
        # expiry into the table, a named segment the workers attach when
        # there are workers. A table that cannot be built raises here (the
        # JAX app logs and serves through the chain)
        self.decision_table = None
        if config.serve_fastpath_enabled:
            from banjax_tpu_torch.native import decisiontable

            cap = config.serve_decision_table_capacity
            self.decision_table = (decisiontable.ShmDecisionTable(capacity=cap)
                                   if self._n_http_workers > 0
                                   else decisiontable.create_decision_table(cap))
            self.dynamic_lists.set_mirror(self.decision_table, self.serve_stats)

        # ban log files (banjax.go:124-138)
        self._banning_log_file = open(config.banning_log_file, "a", encoding="utf-8")
        temp_path = config.banning_log_file_temp or f"{config.banning_log_file}.tmp"
        self._banning_log_file_temp = open(temp_path, "a", encoding="utf-8")

        # the kernel edge: the set and its DROP rule (raises on failure),
        # and the netlink batch writer the bans ride
        self.ipset_stats = IpsetStats()
        ipset_instance = init_ipset(config.iptables_ban_seconds, config.standalone_testing)
        self.ipset_writer = None
        if ipset_instance is not None and config.ipset_netlink_enabled:
            from banjax_tpu_torch.effectors.ipset_netlink import IpsetBatchWriter

            self.ipset_writer = IpsetBatchWriter(ipset_instance, stats=self.ipset_stats)
        self.banner = Banner(self.dynamic_lists, self._banning_log_file,
                             self._banning_log_file_temp, ipset_instance=ipset_instance,
                             netlink_writer=self.ipset_writer)

        # the chain's state as build_decision_chain builds it: its PoW
        # verifier runs kernel C on this app's device
        chain = build_decision_chain(config, self.banner, self.static_lists, self.device)
        self.protected_paths = chain.protected_paths
        self.failed_challenge_states = chain.failed_challenge_states
        self.challenge_verifier = chain.challenge_verifier
        if self._n_http_workers > 0:
            # the one state the hot path writes, shared by every process
            # (raises when the native table cannot be built; the JAX app
            # falls back to single-process serving)
            from banjax_tpu_torch.native.shm import ShmFailedChallengeStates

            self.failed_challenge_states = ShmFailedChallengeStates()

        self._matcher = None
        self._matcher_generation = -1
        self._matcher_lock = threading.Lock()
        # with the pipeline off, one batch at a time enters the matcher:
        # the tailer and the fabric's connection threads both feed it, and
        # its native parse writes one scratch that a parsed batch aliases
        self._consume_lock = threading.Lock()
        # the streaming pipeline between the tailer and the matcher
        self.pipeline = None
        if config.pipeline_enabled:
            from banjax_tpu_torch.pipeline import PipelineScheduler

            self.pipeline = PipelineScheduler.from_config(
                lambda: self._current_matcher()[1], config,
                health=self.health.register("pipeline"),
            )
        self.tailer = LogTailer(
            config.server_log_file, self._consume_lines,
            health=self.health.register("tailer", stale_after=60.0),
        )

        # the decision fabric: shard the IP keyspace across N processes of
        # this app. The banner is wrapped before the first matcher build,
        # so every decision fans out from the start
        self.fabric = None
        if config.fabric_enabled:
            from banjax_tpu_torch.fabric.service import FabricService
            from banjax_tpu_torch.ingest.kafka_io import handle_command
            from banjax_tpu_torch.obs import fleet

            self.fabric = FabricService(
                config,
                local_submit=self._fabric_local_submit,
                apply_command=lambda cmd: handle_command(
                    self.config_holder.get(), cmd, self.dynamic_lists),
                health=self.health,
                # peers pull this shard's metrics (T_STATS), ask it to
                # explain an IP (T_EXPLAIN) and capture it (T_FLIGHTREC)
                metrics_text_fn=self.render_metrics_text,
                explain_fn=self._explain_local,
                health_bits_fn=lambda: fleet.compute_health_bits(
                    slo=getattr(self, "slo", None), matcher=self._matcher),
            )
            self.banner = self.fabric.wrap_banner(self.banner)
            # a forwarded line's ban carries its origin node and trace id
            provenance.set_origin_resolver(fleet.get_origin_index().resolve)
        # the federated /metrics?fleet=1: one merged exposition of every
        # alive shard, pulled over the fabric's peer wire
        self.fleet_scraper = None
        if self.fabric is not None and config.fleet_metrics_enabled:
            from banjax_tpu_torch.obs.fleet import FleetScraper

            self.fleet_scraper = FleetScraper(
                self.fabric.node_id, local_text_fn=self.render_metrics_text,
                peers_fn=self.fabric.fleet_pull_peers,
                timeout_s=config.fleet_scrape_timeout_ms / 1000.0,
            )

        # the flight recorder, installed as the module-level trigger target
        # so the breaker, scheduler, failure-state and SLO hooks stay one
        # None-check when it is off
        self.flightrec = None
        if config.flightrec_dir:
            self.flightrec = flightrec.FlightRecorder(
                config.flightrec_dir,
                min_interval_s=config.flightrec_min_interval_s,
                keep=config.flightrec_keep,
                provenance_tail=config.flightrec_provenance_records,
                metrics_text_fn=self.render_metrics_text,
                config_hash_fn=self._config_hash,
                health=self.health,
                slo_getter=lambda: self.slo,
                traffic_fn=self._traffic_snapshot,
                fabric_fn=self._fabric_snapshot if self.fabric is not None else None,
                # the cluster capture: every alive peer's snapshot under
                # peers/<node_id>/
                fleet_capture_fn=(
                    self._fleet_capture
                    if self.fabric is not None and config.flightrec_fleet_capture else None
                ),
            )
            flightrec.install(self.flightrec)
        # the SLO engine: burn rates from non-destructive reads; a breach
        # transition captures an incident bundle when the recorder is on
        self.slo = None
        if config.slo_enabled:
            from banjax_tpu_torch.obs.slo import SloEngine

            self.slo = SloEngine.from_config(
                config,
                matcher_getter=lambda: self._matcher,
                pipeline_getter=lambda: self.pipeline,
                on_breach=lambda name, burn: flightrec.notify(f"slo-{name}",
                                                              f"burn rates {burn}"),
            )
        # the fleet SLO: a second engine burning the cluster's counter sums
        # from the last federated scrape, with the same window mechanics
        self.fleet_slo = None
        if self.fleet_scraper is not None and config.slo_enabled:
            from banjax_tpu_torch.obs.slo import SloEngine

            self.fleet_slo = SloEngine(
                collect_fn=self.fleet_scraper.fleet_collect,
                on_breach=lambda name, burn: flightrec.notify(
                    f"fleet-slo-{name}", f"fleet burn rates {burn}"),
            )
        metrics_path = ("list-metrics.log" if config.standalone_testing
                        else config.metrics_log_file)
        self.metrics = MetricsReporter(
            metrics_path, self.dynamic_lists, RegexStatesView(self),
            self.failed_challenge_states,
            matcher_getter=lambda: self._matcher,
            health=self.health,
            pipeline_getter=lambda: self.pipeline,
            serve_stats=self.serve_stats,
            ipset_stats=self.ipset_stats,
            supervisor_getter=lambda: self._supervisor,
            fabric_getter=lambda: self.fabric.stats if self.fabric is not None else None,
        )
        self.kafka_reader = None
        self.kafka_writer = None

        gin_log_name = "gin.log" if config.standalone_testing else config.gin_log_file
        self._gin_log_file = None
        if gin_log_name and gin_log_name != "-":
            # truncate on start (the reference's os.Create), then append
            open(gin_log_name, "w", encoding="utf-8").close()
            self._gin_log_file = open(gin_log_name, "a", encoding="utf-8")
        self._server_log_file = None
        if config.standalone_testing:
            self._server_log_file = open(config.server_log_file, "a", encoding="utf-8")

        self.port: Optional[int] = None  # the bound TCP port, once serving
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._async_stop: Optional[asyncio.Event] = None
        self._server_thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._serve_error: Optional[BaseException] = None
        self._stop_event = threading.Event()

    # --- the SIGHUP body (banjax.go:101-117) ---
    def reload(self) -> None:
        log.info("HOT-RELOAD: reloading config")
        try:
            self.config_holder.reload()
        except Exception as e:  # noqa: BLE001 — keep serving on a bad reload
            log.error("failed to reload config: %s", e)
            return
        new_config = self.config_holder.get()
        self.static_lists.update_from_config(new_config)
        self.dynamic_lists.clear()
        self.protected_paths.update_from_config(new_config)
        # re-arm the failpoints only when the spec changed: a reload for
        # other keys keeps what /debug/failpoints armed
        from banjax_tpu_torch.resilience import failpoints

        if new_config.failpoints != self._failpoints_spec:
            failpoints.disarm()
            if new_config.failpoints:
                failpoints.arm_from_spec(new_config.failpoints)
            self._failpoints_spec = new_config.failpoints
        if self._supervisor is not None:
            self._supervisor.broadcast_reload()

    def render_metrics_text(self) -> str:
        """The whole /metrics text, as the route serves it (incident
        bundles take it too)."""
        from banjax_tpu_torch.obs.exposition import render_prometheus

        return render_prometheus(
            self.dynamic_lists, RegexStatesView(self), self.failed_challenge_states,
            matcher=self._matcher, pipeline=self.pipeline, health=self.health,
            slo=self.slo, flightrec=self.flightrec, serve_stats=self.serve_stats,
            ipset_stats=self.ipset_stats, supervisor=self._supervisor,
            fabric=self.fabric.stats if self.fabric is not None else None,
        )

    def _fabric_snapshot(self):
        """fabric.json of an incident bundle: the peer table, the ring's
        ownership and the last takeover."""
        return self.fabric.describe()

    def _fleet_capture(self, incident: str):
        from banjax_tpu_torch.obs import fleet

        return fleet.capture_fleet(incident, self.fabric.fleet_capture_peers)

    def _explain_local(self, ip: str) -> dict:
        """This shard's /decisions/explain payload, for a shard that
        proxies an explain of an IP this one owns (T_EXPLAIN)."""
        from banjax_tpu_torch.httpapi.server import explain_payload

        return explain_payload(self.dynamic_lists, ip)

    def _traffic_snapshot(self):
        """traffic.json of an incident bundle: a forced sketch pull."""
        sketch = getattr(self._matcher, "traffic_sketch", None)
        if sketch is None:
            return {"enabled": False}
        return sketch.incident_snapshot()

    def _config_hash(self) -> str:
        """sha256 of the config file on disk: ties a bundle to the rules
        and limits that were live."""
        import hashlib

        try:
            with open(self.config_holder.path, "rb") as f:
                return hashlib.sha256(f.read()).hexdigest()
        except OSError:
            return ""

    def _current_matcher(self):
        """The matcher of the current config generation, rebuilt when the
        generation moves (regex_rate_limiter.go:59). The old matcher is
        closed and dropped before the new one is built, so the card never
        holds two matchers' state; with the pipeline on, the rebuild first
        waits until no batch is in flight, so it happens between batches."""
        with self._matcher_lock:
            cfg = self.config_holder.get()
            generation = self.config_holder.generation
            if self._matcher_generation != generation:
                if self._matcher is not None and self.pipeline is not None:
                    if not self.pipeline.wait_idle():
                        raise RuntimeError("the pipeline did not drain before a matcher rebuild")
                old, self._matcher = self._matcher, None
                if old is not None:
                    old.close()
                    del old
                    gc.collect()
                self._matcher = build_matcher(cfg, self.banner, self.static_lists,
                                              self.regex_states, self.device,
                                              health=self.health)
                self._matcher_generation = generation
            return cfg, self._matcher

    def _fabric_local_submit(self, lines, t_read=None, hop="local") -> int:
        """The single-process consume path: what the fabric's router calls
        for the lines this shard owns, and what a forwarded chunk's drain
        calls. `t_read` and `hop` reach the pipeline's e2e histogram."""
        if self.pipeline is not None:
            self.pipeline.submit(lines, t_read=t_read, hop=hop)
            return len(lines)
        self._consume_serial(lines)
        return len(lines)

    def _consume_serial(self, lines):
        with self._consume_lock:
            cfg, matcher = self._current_matcher()
            results = matcher.consume_lines(lines)
        if cfg.debug:
            for result in results:
                log.debug("consumeLine: %s", result)
        return results

    def _consume_lines(self, lines):
        # the tailer-read stamp: the e2e histogram runs from here to the
        # effector commit, by hop
        t_read = time.monotonic()
        if self.fabric is not None:
            # owned lines stay here, the rest ride the peer wire
            self.fabric.submit(lines, t_read=t_read)
            return None
        if self.pipeline is not None:
            # asynchronous: the drain stage applies the results; submit
            # applies the bounded backpressure to the tailer
            self.pipeline.submit(lines, t_read=t_read)
            return None
        return self._consume_serial(lines)  # the tailer ignores this; tests read it

    def start_workers(self) -> None:
        """Start the pipeline's stage threads, if on, the SLO sampler, the
        tailer, the Kafka reader and writer, the metrics reporter and the
        Kafka status heartbeat (not the HTTP server)."""
        from banjax_tpu_torch.ingest.kafka_io import KafkaReader, KafkaWriter

        config = self.config_holder.get()
        if self.fabric is not None:
            # listen before the tailer feeds: peers may already forward
            # this shard's range
            self.fabric.start()
        if self.pipeline is not None:
            self.pipeline.start()
        if self.slo is not None:
            self.slo.start(config.slo_sample_seconds)
        if self.fleet_slo is not None:
            self.fleet_slo.start(config.slo_sample_seconds)
        self.tailer.start()
        # commands share the pipeline's admission buffer when it runs
        kafka_pipeline = self.pipeline if config.pipeline_kafka else None
        if config.disable_kafka:
            log.info("INIT: not running Kafka reader/writer due to disable_kafka")
        else:
            log.info("INIT: starting Kafka reader%s", " only due to disable_kafka_writer"
                     if config.disable_kafka_writer else "/writer")
            self.kafka_reader = KafkaReader(
                self.config_holder, self.dynamic_lists,
                health=self.health.register("kafka-reader"), pipeline=kafka_pipeline,
            )
            self.kafka_reader.start()
            if not config.disable_kafka_writer:
                self.kafka_writer = KafkaWriter(
                    self.config_holder, health=self.health.register("kafka-writer"))
                self.kafka_writer.start()
        if self.fabric is not None and self.kafka_reader is not None:
            # the fabric's deduper in front of the command dispatch: own
            # echoes and already-seen (origin, seq) pairs are dropped
            self.kafka_reader.dispatch_raw = self.fabric.dispatch_raw
        self.metrics.start()
        if not config.disable_kafka:
            threading.Thread(target=self._heartbeat, name="kafka-status", daemon=True).start()

    def _heartbeat(self) -> None:
        from banjax_tpu_torch.ingest.reports import report_status_message

        while not self._stop_event.wait(KAFKA_STATUS_INTERVAL_SECONDS):
            cfg = self.config_holder.get()
            if not cfg.disable_kafka:
                report_status_message(cfg)

    def server_deps(self):
        from banjax_tpu_torch.httpapi.server import ServerDeps

        return ServerDeps(
            config_holder=self.config_holder,
            static_lists=self.static_lists,
            dynamic_lists=self.dynamic_lists,
            protected_paths=self.protected_paths,
            regex_states=RegexStatesView(self),
            failed_challenge_states=self.failed_challenge_states,
            banner=self.banner,
            gin_log_file=self._gin_log_file,
            server_log_file=self._server_log_file,
            health=self.health,
            challenge_verifier=self.challenge_verifier,
            decision_table=self.decision_table,
            serve_stats=self.serve_stats,
            matcher_getter=lambda: self._matcher,
            pipeline_getter=lambda: self.pipeline,
            slo_getter=lambda: self.slo,
            flightrec_getter=lambda: self.flightrec,
            ipset_stats=self.ipset_stats,
            supervisor_getter=lambda: self._supervisor,
            fabric_getter=lambda: self.fabric.stats if self.fabric is not None else None,
            fleet_getter=lambda: self.fleet_scraper,
            fabric_service_getter=lambda: self.fabric,
        )

    async def _serve(self, install_signal_handlers: bool, port: int) -> None:
        from banjax_tpu_torch.httpapi.server import run_http_server

        try:
            if self._n_http_workers > 0:
                import tempfile

                from banjax_tpu_torch.httpapi.workers import PrimarySupervisor

                self._supervisor = PrimarySupervisor(
                    self, tempfile.mkdtemp(prefix="banjax-ctrl-"), self._n_http_workers,
                    health=self.health.register("worker-supervisor"),
                )
                self.dynamic_lists.set_broadcast(self._supervisor.control.broadcast)
                handle = await run_http_server(
                    self.server_deps(), port=port, reuse_port=True,
                    unix_path=self._supervisor.primary_http_sock(),
                )
                # the workers bind the port the primary bound
                self._supervisor.spawn_workers(handle.port)
            else:
                handle = await run_http_server(self.server_deps(), port=port)
        except BaseException as e:
            self._serve_error = e
            self._started.set()
            raise
        self.port = handle.port
        self._async_stop = asyncio.Event()
        if install_signal_handlers:
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, self._async_stop.set)
        self._started.set()
        try:
            await self._async_stop.wait()
        finally:
            await handle.cleanup()

    def run_forever(self, port: Optional[int] = None) -> None:
        """Blocking run for the CLI (main thread; installs the signal
        handlers); serves HTTP on `port`, the reference's 8081 by default."""
        from banjax_tpu_torch.httpapi.server import LISTEN_PORT

        signal.signal(signal.SIGHUP, lambda s, f: self.reload())
        self.start_workers()
        try:
            asyncio.run(self._serve(True, LISTEN_PORT if port is None else port))
        finally:
            self.shutdown()

    def start_background(self, port: Optional[int] = None, timeout: float = 10.0) -> None:
        """Non-blocking run: the tailer and a server thread; returns once the
        server listens (on `self.port`; pass port=0 for an ephemeral one)."""
        from banjax_tpu_torch.httpapi.server import LISTEN_PORT

        self.start_workers()
        bind = LISTEN_PORT if port is None else port

        def run():
            self._loop = asyncio.new_event_loop()
            try:
                self._loop.run_until_complete(self._serve(False, bind))
            except BaseException:  # noqa: BLE001 — kept in _serve_error, raised below
                pass
            finally:
                self._loop.close()

        self._server_thread = threading.Thread(target=run, name="http-server", daemon=True)
        self._server_thread.start()
        if not self._started.wait(timeout):
            raise RuntimeError("http server did not start in time")
        if self._serve_error is not None:
            raise RuntimeError(f"http server failed to start: {self._serve_error}")

    def stop_background(self) -> None:
        if self._loop is not None and self._async_stop is not None:
            self._loop.call_soon_threadsafe(self._async_stop.set)
        if self._server_thread is not None:
            self._server_thread.join(timeout=10)
        self.shutdown()

    def shutdown(self) -> None:
        """Stop the workers and release what the app holds, in the JAX order
        but for Kafka: the HTTP worker processes, the tailer and the Kafka
        loops (no new lines or commands; JAX stops Kafka last), the fabric
        (its peers take over this shard's range), the pipeline (it drains what was admitted, then its threads stop), then
        the lists' sweeper, the failed-challenge table and the decision
        table (a named segment is unlinked), the matcher, the kernel edge's
        writer (it drains its queue) and the files. The SLO sampler and the
        metrics reporter stop after the pipeline; the flight recorder is
        uninstalled, so a later app in the same process starts clean."""
        from banjax_tpu_torch.obs import flightrec, provenance

        self._stop_event.set()
        if self._supervisor is not None:
            self._supervisor.stop()
            self._supervisor = None
        tailer_stopped = self.tailer.stop()
        # the Kafka reader admits commands into the pipeline: it stops first too
        for loop in (self.kafka_reader, self.kafka_writer):
            if loop is not None:
                loop.stop()
        if self.fabric is not None:
            # after the tailer (no new routes), before the pipeline drains:
            # peers see the connection refused and take over
            self.fabric.stop()
        if self.pipeline is not None and tailer_stopped:
            self.pipeline.flush()
            tailer_stopped = self.pipeline.stop()
        if self.slo is not None:
            self.slo.stop()
        if self.fleet_slo is not None:
            self.fleet_slo.stop()
        if self.fabric is not None:
            # a later app in the same process starts without a resolver
            provenance.set_origin_resolver(None)
        if self.flightrec is not None and flightrec.installed() is self.flightrec:
            flightrec.install(None)
        self.metrics.stop()
        self.dynamic_lists.close()
        # the shared tables go only after the metrics loop stopped (it
        # reads them); the segments are unlinked by their creator
        fc = self.failed_challenge_states
        if hasattr(fc, "unlink"):
            fc.close()
            fc.unlink()
        dt = self.decision_table
        if dt is not None:
            self.dynamic_lists.set_mirror(None)
            self.decision_table = None
            dt.close()
            if hasattr(dt, "unlink"):
                dt.unlink()
        if not tailer_stopped:
            # a batch still runs on the matcher: leave it to the process's end
            log.warning("log tailer or pipeline did not stop; the matcher is left open")
        elif self._matcher is not None:
            self._matcher.close()
            self._matcher = None
        if self.ipset_writer is not None:
            # the final queue drain happens inside close(); its errors are
            # counted and logged, never raised
            self.ipset_writer.close()
            self.ipset_writer = None
        for f in (self._banning_log_file, self._banning_log_file_temp,
                  self._gin_log_file, self._server_log_file):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass


def main(argv: Optional[list] = None) -> int:
    # Go-style single-dash long flags (banjax.go:67-69)
    parser = argparse.ArgumentParser(prog="banjax-tpu-torch", prefix_chars="-")
    parser.add_argument("-standalone-testing", dest="standalone_testing",
                        action="store_true", help="makes it easy to test standalone")
    parser.add_argument("-config-file", dest="config_file",
                        default="/etc/banjax/banjax-config.yaml", help="config file")
    parser.add_argument("-debug", dest="debug", action="store_true",
                        help="debug mode with verbose logging")
    # not a flag of the reference: co-located shards of a fabric each
    # need a port of their own
    parser.add_argument("-port", dest="port", type=int, default=None,
                        help="HTTP port (default 8081)")
    parser.add_argument("-device", dest="device", default=None,
                        help="torch device (default: the card; cpu runs the plain versions)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    app = BanjaxApp(args.config_file, args.standalone_testing, args.debug, device=args.device)
    app.run_forever(args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
