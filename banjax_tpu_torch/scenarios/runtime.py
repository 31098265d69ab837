"""ScenarioRunner: feed a generated scenario through the real engine.

(A port of `banjax_tpu/scenarios/runtime.py`.)

One runner = one fresh engine stack (TorchMatcher with device windows,
PipelineScheduler, SLO engine, optional flight recorder) fed one
scenario's event stream, either by direct submit() (the default: fastest,
exercises the full pipeline), through a real temp file + LogTailer
(`via_tailer=True` — the mode where Rotation markers rotate an actual
inode and the tailer's no-drop/no-dup contract is on trial), or with the
commands produced into a broker and drained by a real KafkaReader
(`kafka_broker=`, e.g. `ingest/broker_standin.KafkaBrokerStandIn`).

The engine runs on the card unless `device` says otherwise ("cpu" runs
the kernels' plain versions). `single_kernel` is the matcher's
`pallas_single_kernel`: "auto" and "on" run the single-program chunk
commit, "off" the two-program mode (program A at submit, program B at
the drain).

What a run produces (ScenarioReport):

  * throughput + pressure: lines/s over the feed, shed/stale/drain-error
    counts (deltas over the run, warmup excluded), and the lines the
    matcher's open breaker refused;
  * correctness vs ground truth: multiset ban precision/recall against
    the oracle (scenarios/oracle.py) — 1.0/1.0 expected on clean runs,
    honestly degraded under chaos;
  * SLO evidence: per-SLO peak burn rate over the run (sampled on a
    virtual clock) and the final breached set;
  * structural invariants, each a named boolean:
      - accounting:      admitted == processed + shed + drain_errors
      - no_leaked_turns: the chunk pipeline is idle (every order turn
                         settled)
      - no_leaked_pins:  zero outstanding device-window slot pins
      - commands_drained (when the shape carries commands, clean runs)
      - benign_no_bans / benign_slo_clean (benign shapes, clean runs)
  * chaos evidence: per-episode fired counts and one flight-recorder
    bundle per episode (when a recorder directory is given).

Under chaos the port's accounting differs from the JAX runner's on
purpose: an open breaker refuses a batch (`BreakerOpen`), and the
pipeline counts its lines in drain_errors, where the JAX runner reruns
the batch on its host matcher and counts the lines processed. The
formula above is the same; the refused lines are lost to the window
state, so under chaos precision and recall are reported, not gated (a
lost hit can move a fixed window's start, and so add a ban as well as
lose one).

The matcher is warmed with rule-neutral traffic before the measured
feed so kernel build and first-use time land outside the SLO/throughput
window — the same discipline every bench mode uses.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

from banjax_tpu_torch.config import config_from_yaml_text
from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
from banjax_tpu_torch.decisions.rate_limit import FailedChallengeRateLimitStates
from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
from banjax_tpu_torch.device import DeviceLike
from banjax_tpu_torch.obs import flightrec as flightrec_mod
from banjax_tpu_torch.scenarios import oracle as oracle_mod
from banjax_tpu_torch.scenarios import stats as scen_stats
from banjax_tpu_torch.scenarios.shapes import (
    _HOSTS,
    RUN_NOW,
    T0,
    CommandBatch,
    LineChunk,
    Rotation,
    Scenario,
)

_WARM_IP = "9.254.254.254"  # outside every shape's IP space


class RecordingBanner:
    """Effect sink for scenario runs: records (ip, rule) ban events and
    decisions instead of touching ipset/dynamic lists."""

    def __init__(self) -> None:
        self.regex_ban_logs: List[Tuple[str, str]] = []
        self.failed_challenge_ban_logs: List[Tuple[str, str]] = []  # (ip, type)
        self.decisions: List[Tuple[str, str]] = []   # (ip, decision)
        self.ipset: set = set()

    def ban_or_challenge_ip(self, config, ip, decision, domain) -> None:
        self.decisions.append((ip, str(decision)))

    def log_regex_ban(self, config, log_time_unix, ip, rule_name,
                      log_line_rest, decision) -> None:
        self.regex_ban_logs.append((ip, rule_name))

    def log_failed_challenge_ban(self, config, ip, challenge_type, host,
                                 path, threshold, user_agent, decision,
                                 method) -> None:
        self.failed_challenge_ban_logs.append((ip, challenge_type))

    def ipset_add(self, config, ip) -> None:
        self.ipset.add(ip)

    def ipset_test(self, config, ip) -> bool:
        return ip in self.ipset

    def ipset_list(self) -> list:
        return sorted(self.ipset)

    def ipset_del(self, ip) -> None:
        self.ipset.discard(ip)


@dataclasses.dataclass
class EngineParts:
    """One assembled single-process engine stack — the unit the fabric
    replicates per shard.  Built by `build_engine` and shared between
    ScenarioRunner and fabric/worker so both drive the SAME assembly
    (matcher flags, scheduler knobs, pinned virtual clock).  The window
    state lives in `matcher.device_windows`."""

    cfg: object
    banner: object
    dynamic_lists: DynamicDecisionLists
    matcher: object
    sched: object


def build_engine(
    rules_yaml: str,
    *,
    device: DeviceLike = None,
    banner=None,
    single_kernel: str = "auto",
    breaker_recovery_s: float = 0.5,
    latency_budget_ms: float = 180.0,
    buffer_lines: int = 131072,
    max_block_ms: float = 50.0,
    kafka_broker_port: Optional[int] = None,
    kafka_command_topic: str = "scenario.commands",
    kafka_report_topic: str = "scenario.reports",
    cfg_overrides: Optional[Dict[str, object]] = None,
    now_fn=None,
) -> EngineParts:
    """Assemble the full engine (TorchMatcher with device windows +
    pipeline scheduler) on the scenario virtual clock, on `device` (None:
    the card, raising when there is none).  The banner is injectable so
    the fabric can wrap RecordingBanner with its replicating banner
    without re-stating the assembly."""
    from banjax_tpu_torch.matcher.runner import TorchMatcher
    from banjax_tpu_torch.pipeline import PipelineScheduler

    cfg = config_from_yaml_text(rules_yaml)
    cfg.matcher = "tpu"
    cfg.matcher_device_windows = True
    cfg.pallas_single_kernel = single_kernel
    cfg.breaker_recovery_seconds = breaker_recovery_s
    cfg.expiring_decision_ttl_seconds = 300
    if kafka_broker_port is not None:
        cfg.kafka_brokers = [f"127.0.0.1:{kafka_broker_port}"]
        cfg.kafka_command_topic = kafka_command_topic
        cfg.kafka_report_topic = kafka_report_topic
        cfg.kafka_max_wait_ms = 100
    if cfg_overrides:
        # harness-level knobs (slot admission, warm tier, fabric ids,
        # ...) the scenario's rules_yaml doesn't carry
        for k, v in cfg_overrides.items():
            setattr(cfg, k, v)
    dynamic_lists = DynamicDecisionLists(start_sweeper=False)
    banner = banner if banner is not None else RecordingBanner()
    matcher = TorchMatcher(cfg, banner, StaticDecisionLists(cfg), device=device)
    sched = PipelineScheduler(
        lambda: matcher,
        latency_budget_ms=latency_budget_ms,
        buffer_lines=buffer_lines,
        max_block_ms=max_block_ms,
        now_fn=now_fn if now_fn is not None else (lambda: RUN_NOW),
    )
    return EngineParts(
        cfg=cfg, banner=banner, dynamic_lists=dynamic_lists,
        matcher=matcher, sched=sched,
    )


@dataclasses.dataclass
class ScenarioReport:
    name: str
    seed: int
    scale: float
    mode: str                      # "direct" | "tailer" | "kafka"
    single_kernel: str
    n_lines: int
    n_commands: int
    feed_s: float
    lines_per_sec: float
    shed_lines: int
    drain_error_lines: int
    stale_lines: int
    shed_ratio: float
    fallback_batches: int
    # lines the matcher's open breaker refused (they are in
    # drain_error_lines too; the JAX runner reruns them on the host)
    refused_lines: int
    engine_bans: int
    oracle_bans: int
    true_positives: int
    precision: float
    recall: float
    device_p99_ms: Optional[float]
    slo_burn_peak: Dict[str, float]
    slo_breached: Dict[str, bool]
    invariants: Dict[str, bool]
    episodes: List[dict]
    incidents: int
    command_items: int
    # challenge-plane loop results (challenge_storm only, else None):
    # scripted issuance -> solve -> verify -> failure run with exact
    # precision/recall vs the scripted solver/attacker split
    challenge: Optional[dict] = None

    def ok(self) -> bool:
        return all(self.invariants.values())

    def row(self) -> dict:
        return dataclasses.asdict(self)


class ScenarioRunner:
    def __init__(
        self,
        scenario: Scenario,
        *,
        device: DeviceLike = None,
        single_kernel: str = "auto",
        chaos=None,
        via_tailer: bool = False,
        tmp_dir: Optional[str] = None,
        flightrec_dir: Optional[str] = None,
        latency_budget_ms: float = 180.0,
        buffer_lines: int = 131072,
        max_block_ms: float = 50.0,
        slo_budget_s: float = 2.0,
        slo_sample_every: int = 4,
        breaker_recovery_s: float = 0.5,
        cfg_overrides: Optional[Dict[str, object]] = None,
        kafka_broker=None,
    ):
        self.scenario = scenario
        self.device = device
        self.single_kernel = single_kernel
        self.chaos = chaos
        self.via_tailer = via_tailer
        self.tmp_dir = tmp_dir
        self.flightrec_dir = flightrec_dir
        self.latency_budget_ms = latency_budget_ms
        self.buffer_lines = buffer_lines
        self.max_block_ms = max_block_ms
        self.slo_budget_s = slo_budget_s
        self.slo_sample_every = max(1, slo_sample_every)
        self.breaker_recovery_s = breaker_recovery_s
        self.cfg_overrides = cfg_overrides
        # kafka-fed command mode: an in-process broker (.port / .append /
        # .log_end_offset — ingest/broker_standin.KafkaBrokerStandIn)
        # receives every CommandBatch and a REAL KafkaReader drains it
        # over the wire protocol into the pipeline's admission buffer,
        # with a KafkaWriter pushing one report per batch the other way
        # — the mode where kafka.read/kafka.send failpoints fire during
        # soak instead of only in the fault unit tests.
        self.kafka_broker = kafka_broker
        self._commands_handled = 0
        self._kafka_reports_sent = 0

    # ---- engine assembly ----

    def _build(self):
        from banjax_tpu_torch.obs.slo import SloEngine

        parts = build_engine(
            self.scenario.rules_yaml,
            device=self.device,
            single_kernel=self.single_kernel,
            breaker_recovery_s=self.breaker_recovery_s,
            latency_budget_ms=self.latency_budget_ms,
            buffer_lines=self.buffer_lines,
            max_block_ms=self.max_block_ms,
            kafka_broker_port=(
                self.kafka_broker.port
                if self.kafka_broker is not None else None
            ),
            cfg_overrides=self.cfg_overrides,
        )
        self.cfg = parts.cfg
        self.dynamic_lists = parts.dynamic_lists
        self.banner = parts.banner
        self.matcher = parts.matcher
        self.sched = parts.sched
        self._vnow = 0.0
        self.slo = SloEngine(
            matcher_getter=lambda: self.matcher,
            pipeline_getter=lambda: self.sched,
            batch_budget_s_fn=lambda: self.slo_budget_s,
            on_breach=lambda name, burn: flightrec_mod.notify(
                f"slo-{name}", f"burn rates {burn}"
            ),
            clock=lambda: self._vnow,
        )
        self.flightrec = None
        self._prev_recorder = flightrec_mod.installed()
        if self.flightrec_dir:
            from banjax_tpu_torch.obs.flightrec import FlightRecorder

            self.flightrec = FlightRecorder(
                self.flightrec_dir,
                min_interval_s=0.0,   # one bundle per episode, no debounce
                keep=256,
                metrics_text_fn=self._metrics_text,
                slo_getter=lambda: self.slo,
            )
            flightrec_mod.install(self.flightrec)

    def _metrics_text(self) -> str:
        from banjax_tpu_torch.obs.exposition import render_prometheus

        return render_prometheus(
            self.dynamic_lists, self.matcher.device_windows,
            FailedChallengeRateLimitStates(), matcher=self.matcher,
            pipeline=self.sched, slo=self.slo, flightrec=self.flightrec,
        )

    # ---- SLO sampling (virtual clock) ----

    def _slo_tick(self, peaks: Dict[str, float]) -> None:
        self._vnow += 30.0
        self.slo.sample()
        for slo_name, windows in self.slo.burn_rates().items():
            peak = max(windows.values()) if windows else 0.0
            peaks[slo_name] = max(peaks.get(slo_name, 0.0), peak)

    # ---- command dispatch (the kafka drain-stage handler) ----

    def _handle_command(self, raw: bytes) -> None:
        from banjax_tpu_torch.ingest.kafka_io import handle_command

        try:
            cmd = json.loads(raw)
        except ValueError:
            return
        handle_command(self.cfg, cmd, self.dynamic_lists)
        self._commands_handled += 1

    # ---- kafka-fed command mode ----

    def _kafka_dispatch(self, raw: bytes) -> None:
        """Reader drain-stage handler: readiness pings settle the tail-
        attach race (the reader consumes from latest; its attach moment
        is unobservable), everything else is a scenario command."""
        if b'"scenario_ping"' in raw:
            self._kafka_ready.set()
            return
        self._handle_command(raw)

    def _kafka_start(self) -> dict:
        import queue as queue_mod
        import threading

        from banjax_tpu_torch.ingest import reports
        from banjax_tpu_torch.ingest.kafka_io import KafkaReader, KafkaWriter
        from banjax_tpu_torch.ingest.kafka_wire import WireKafkaTransport
        from banjax_tpu_torch.resilience.backoff import Backoff

        class _Holder:
            def __init__(self, cfg):
                self._cfg = cfg

            def get(self):
                return self._cfg

        # other runs share the module-level report queue: drain it so
        # the produced-report settle counts only this run's reports
        q = reports.get_message_queue()
        while True:
            try:
                q.get_nowait()
            except queue_mod.Empty:
                break

        self._kafka_ready = threading.Event()
        holder = _Holder(self.cfg)
        fast = dict(base=0.05, cap=0.2, jitter=0.0)
        reader = KafkaReader(
            holder, self.dynamic_lists, transport=WireKafkaTransport(),
            backoff=Backoff(**fast), pipeline=self.sched,
        )
        reader.dispatch_raw = self._kafka_dispatch
        writer = KafkaWriter(
            holder, transport=WireKafkaTransport(), backoff=Backoff(**fast)
        )
        reader.start()
        writer.start()
        # the reader attaches at the log tail at an unobservable moment:
        # keep producing pings until one round-trips through the real
        # fetch path + pipeline drain (no fixed sleeps)
        deadline = time.monotonic() + 30
        while not self._kafka_ready.wait(0.05):
            if time.monotonic() > deadline:
                raise RuntimeError("kafka scenario reader never attached")
            self.kafka_broker.append(
                self.cfg.kafka_command_topic, [b'{"Name": "scenario_ping"}']
            )
        return {"reader": reader, "writer": writer, "queue": q}

    def _kafka_feed(self, ev: CommandBatch, ctx: dict) -> None:
        """One CommandBatch: produce every raw into the broker's command
        topic (the reader's fetch loop delivers them into the pipeline)
        and push one report the other way through the writer, so BOTH
        kafka failpoints sit on exercised code during the soak."""
        self.kafka_broker.append(self.cfg.kafka_command_topic, list(ev.raws))
        ctx["queue"].put_nowait(
            json.dumps({"name": "scenario_report",
                        "batch": self._kafka_reports_sent}).encode()
        )
        self._kafka_reports_sent += 1

    def _kafka_settle(self, n_cmds: int) -> None:
        """Wait for the async kafka legs to finish: every command drained
        (clean runs — a kafka.read episode loses the tail-attach window
        by design, exactly the reference's consume-from-latest contract)
        and every report produced (the writer never drops a dequeued
        report, so this converges even across kafka.send faults)."""
        deadline = time.monotonic() + 60
        topic = self.cfg.kafka_report_topic
        while time.monotonic() < deadline:
            self.sched.flush(60)
            cmds_ok = self._commands_handled >= n_cmds
            reports_ok = (
                self.kafka_broker.log_end_offset(topic)
                >= self._kafka_reports_sent
            )
            if cmds_ok and reports_ok:
                return
            time.sleep(0.05)
        if self.chaos is None:
            raise RuntimeError(
                f"kafka scenario did not settle: "
                f"{self._commands_handled}/{n_cmds} commands, "
                f"{self.kafka_broker.log_end_offset(topic)}"
                f"/{self._kafka_reports_sent} reports"
            )

    # ---- the run ----

    def run(self) -> ScenarioReport:
        self._build()
        try:
            return self._run_inner()
        finally:
            flightrec_mod.install(self._prev_recorder)
            self.matcher.close()

    def _warmup(self) -> None:
        """Push kernel builds + sizer settle outside the measured window
        with rule-neutral traffic (single sub-threshold hits from an IP no
        shape uses, so window state and the oracle are untouched)."""
        warm = [
            f"{T0:.6f} {_WARM_IP} GET warm.example GET /about "
            "HTTP/1.1 warm -"
            for _ in range(48)
        ]
        warm.append(
            f"{T0:.6f} {_WARM_IP} GET warm.example GET /index.html "
            "HTTP/1.1 warm -"
        )
        warm.append(
            f"{T0:.6f} {_WARM_IP} GET warm.example GET /checkout "
            "HTTP/1.1 warm -"
        )
        for _ in range(2):
            self.sched.submit(warm)
            if not self.sched.flush(600):
                raise RuntimeError("scenario warmup did not drain")

    def _run_inner(self) -> ScenarioReport:
        sc = self.scenario
        self.sched.start()
        tailer_ctx = self._tailer_start() if self.via_tailer else None
        kafka_ctx = (
            self._kafka_start() if self.kafka_broker is not None else None
        )
        try:
            self._warmup()

            base = self.sched.stats.peek()
            refused_before = self.matcher.refused_lines
            bans_before = len(self.banner.regex_ban_logs)
            peaks: Dict[str, float] = {}
            self.slo.sample()  # baseline AFTER warmup: deltas exclude it

            if self.chaos is not None:
                self.chaos.bind(lambda: self.sched.flush(600))
            t_feed = time.perf_counter()
            for i, ev in enumerate(sc.events):
                if self.chaos is not None:
                    self.chaos.before_event(i)
                if isinstance(ev, LineChunk):
                    if tailer_ctx is not None:
                        self._tailer_write(tailer_ctx, ev, i)
                    else:
                        self.sched.submit(list(ev.lines))
                elif isinstance(ev, CommandBatch):
                    if kafka_ctx is not None:
                        self._kafka_feed(ev, kafka_ctx)
                    else:
                        self.sched.submit_commands(
                            list(ev.raws), self._handle_command
                        )
                elif isinstance(ev, Rotation):
                    if tailer_ctx is not None:
                        self._tailer_rotate(tailer_ctx)
                if (i + 1) % self.slo_sample_every == 0:
                    self._slo_tick(peaks)
            if tailer_ctx is not None:
                self._tailer_settle(
                    tailer_ctx,
                    int(base["PipelineAdmittedLines"])
                    + len(sc.lines()) + sc.n_commands(),
                )
            if kafka_ctx is not None:
                self._kafka_settle(sc.n_commands())
            if not self.sched.flush(600):
                raise RuntimeError(f"scenario {sc.name} did not drain")
            feed_s = max(1e-9, time.perf_counter() - t_feed)
            self._slo_tick(peaks)
            if self.chaos is not None:
                self.chaos.finish()
        finally:
            if kafka_ctx is not None:
                kafka_ctx["reader"].stop()
                kafka_ctx["writer"].stop()
            if tailer_ctx is not None:
                tailer_ctx["tailer"].stop()
                tailer_ctx["writer"].close()
            self.sched.stop()

        challenge = self._challenge_loop()
        return self._report(base, bans_before, refused_before, peaks,
                            feed_s, challenge)

    # ---- challenge-plane loop (challenge_storm shape) ----

    def _challenge_loop(self) -> Optional[dict]:
        """Drive every storm client through the REAL challenge plane —
        decision_chain's send_or_validate_sha_challenge with the
        scenario banner as effect sink — not a simulation.  A seeded
        fraction of clients solve the PoW cookie they were issued and
        must pass; the rest present garbage cookies until the
        failed-challenge rate limit bans them.  The scripted oracle is
        exact (non-solvers ban, solvers never do), so precision/recall
        below 1.0/1.0 is an engine bug.  All of one client's failures
        land inside a single rate-limit interval — the regime where the
        bounded failure state's drops can only DELAY a ban
        (challenge/failures.py), never un-ban or misban.  With
        `challenge_device_verify: true` (cfg_overrides) the solvers'
        cookies are checked by kernel C on the runner's device."""
        sc = self.scenario
        n_storm = int(sc.notes.get("storm_ips") or 0)
        if not n_storm:
            return None
        import random as random_mod

        from banjax_tpu_torch.challenge import verifier as challenge_verifier_mod
        from banjax_tpu_torch.challenge.failures import make_failed_challenge_states
        from banjax_tpu_torch.crypto.challenge import solve_challenge_for_testing
        from banjax_tpu_torch.decisions.model import FailAction
        from banjax_tpu_torch.decisions.protected_paths import PasswordProtectedPaths
        from banjax_tpu_torch.httpapi.decision_chain import (
            ChainState,
            RequestInfo,
            ShaChallengeResult,
            send_or_validate_sha_challenge,
        )
        from banjax_tpu_torch.httpapi.rewrite import CHALLENGE_COOKIE_NAME

        cfg = self.cfg
        # the shared scenario ruleset carries no challenge-plane keys:
        # fill in deterministic storm defaults (cfg_overrides still wins
        # — build_engine applied them before we got here)
        if not cfg.hmac_secret:
            cfg.hmac_secret = f"scenario-secret-{sc.seed}"
        if cfg.sha_inv_expected_zero_bits <= 0:
            cfg.sha_inv_expected_zero_bits = 8  # ~256 hashes per solve
        if cfg.sha_inv_cookie_ttl_seconds <= 0:
            cfg.sha_inv_cookie_ttl_seconds = 60
        if cfg.too_many_failed_challenges_threshold <= 0:
            cfg.too_many_failed_challenges_threshold = 3
        if cfg.too_many_failed_challenges_interval_seconds <= 0:
            cfg.too_many_failed_challenges_interval_seconds = 30

        fc_states = make_failed_challenge_states(cfg)
        device = challenge_verifier_mod.from_config(cfg, self.matcher.device)
        state = ChainState(
            config=cfg,
            static_lists=StaticDecisionLists(cfg),
            dynamic_lists=self.dynamic_lists,
            protected_paths=PasswordProtectedPaths(cfg),
            failed_challenge_states=fc_states,
            banner=self.banner,
            challenge_verifier=device,
        )
        rng = random_mod.Random(sc.seed ^ 0x57012)
        solver_fraction = float(sc.notes.get("solver_fraction", 0.25))
        threshold = cfg.too_many_failed_challenges_threshold
        bans_before = len(self.banner.failed_challenge_ban_logs)
        solvers: set = set()
        attackers: set = set()
        solver_passes = 0
        for k in range(n_storm):
            ip = f"10.5.{(k >> 8) & 0xFF}.{k & 0xFF}"
            req = RequestInfo(
                client_ip=ip,
                requested_host=_HOSTS[1],
                requested_path="/checkout",
                client_user_agent=f"ChallengeBot-{k}/2.{k % 5}",
            )
            if rng.random() < solver_fraction:
                solvers.add(ip)
                # first visit has no cookie: the real 429 issuance path
                resp, _, _ = send_or_validate_sha_challenge(
                    state, req, FailAction.BLOCK
                )
                issued = next(
                    c.value for c in resp.cookies
                    if c.name == CHALLENGE_COOKIE_NAME
                )
                solved = solve_challenge_for_testing(
                    issued, cfg.sha_inv_expected_zero_bits
                )
                req2 = dataclasses.replace(
                    req, cookies={CHALLENGE_COOKIE_NAME: solved}
                )
                _, result, _ = send_or_validate_sha_challenge(
                    state, req2, FailAction.BLOCK
                )
                if result == ShaChallengeResult.PASSED:
                    solver_passes += 1
            else:
                attackers.add(ip)
                # garbage cookies until the rate limit trips the ban
                for _ in range(threshold + 1):
                    reqk = dataclasses.replace(
                        req, cookies={CHALLENGE_COOKIE_NAME: "!bogus!"}
                    )
                    _, _, rate = send_or_validate_sha_challenge(
                        state, reqk, FailAction.BLOCK
                    )
                    if rate.exceeded:
                        break
        banned = {
            ip for ip, _ in
            self.banner.failed_challenge_ban_logs[bans_before:]
        }
        tp = len(banned & attackers)
        precision = tp / len(banned) if banned else 1.0
        recall = tp / len(attackers) if attackers else 1.0
        limit = int(getattr(cfg, "challenge_failure_state_max", 0) or 0)
        return {
            "storm_clients": n_storm,
            "solvers": len(solvers),
            "solver_passes": solver_passes,
            "attackers": len(attackers),
            "banned": len(banned),
            "ban_precision": round(precision, 6),
            "ban_recall": round(recall, 6),
            "verify_path": "device" if device is not None else "cpu",
            "failure_state_entries": len(fc_states),
            "failure_state_max": limit,
            "failure_state_bounded": (
                limit == 0 or len(fc_states) <= limit
            ),
        }

    # ---- tailer-fed mode ----

    def _tailer_start(self) -> dict:
        from banjax_tpu_torch.ingest.tailer import LogTailer

        assert self.tmp_dir, "via_tailer needs tmp_dir"
        path = os.path.join(self.tmp_dir, "scenario-access.log")
        writer = open(path, "a", encoding="utf-8")
        tailer = LogTailer(path, self.sched.submit)
        tailer.start()
        if not tailer.opened.wait(10):
            raise RuntimeError("scenario tailer did not open the log")
        return {"path": path, "writer": writer, "tailer": tailer, "rot": 0}

    def _tailer_write(self, ctx: dict, ev: LineChunk, index: int) -> None:
        # write the chunk; when a Rotation marker is next, leave the
        # final line WITHOUT its newline — the rotation drain must still
        # deliver it (the partial-line half of the no-drop contract)
        nxt = (
            self.scenario.events[index + 1]
            if index + 1 < len(self.scenario.events) else None
        )
        text = "\n".join(ev.lines)
        if not isinstance(nxt, Rotation):
            text += "\n"
        ctx["writer"].write(text)
        ctx["writer"].flush()

    def _tailer_rotate(self, ctx: dict) -> None:
        # the tailer must have OPENED the current generation before it
        # disappears: rotating twice inside one poll interval would
        # orphan a whole file no follower can see (real log movers never
        # do that — the no-drop contract covers the file the tailer
        # holds, whose unread tail the rotation drain recovers)
        tailer = ctx["tailer"]
        deadline = time.monotonic() + 30
        while not tailer.opened.is_set():
            if time.monotonic() > deadline:
                raise RuntimeError("tailer never opened the rotated log")
            time.sleep(0.01)
        tailer.opened.clear()  # re-set by the tailer's reopen
        ctx["writer"].close()
        ctx["rot"] += 1
        os.replace(ctx["path"], f"{ctx['path']}.{ctx['rot']}")
        ctx["writer"] = open(ctx["path"], "a", encoding="utf-8")

    def _tailer_settle(self, ctx: dict, expect_admitted: int) -> None:
        """Wait until the tailer has delivered every generated line
        (warmup lines were submitted directly, so the expected admission
        count is warmup + stream)."""
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            peek = self.sched.stats.peek()
            if peek["PipelineAdmittedLines"] >= expect_admitted:
                return
            time.sleep(0.05)
        raise RuntimeError(
            f"tailer delivered {self.sched.stats.peek()} "
            f"< {expect_admitted} lines"
        )

    # ---- reporting ----

    def _report(self, base: dict, bans_before: int, refused_before: int,
                peaks: Dict[str, float], feed_s: float,
                challenge: Optional[dict] = None) -> ScenarioReport:
        sc = self.scenario
        peek = self.sched.stats.peek()

        def delta(key: str) -> int:
            return int(peek[key]) - int(base[key])

        n_lines = len(sc.lines())
        n_cmds = sc.n_commands()
        shed = delta("PipelineShedLines")
        drain_err = delta("PipelineDrainErrorLines")
        stale = delta("PipelineStaleDroppedLines")
        admitted = delta("PipelineAdmittedLines")
        processed = delta("PipelineProcessedLines")

        engine_bans = self.banner.regex_ban_logs[bans_before:]
        oracle_bans = oracle_mod.expected_bans(sc, self.cfg)
        precision, recall, tp = oracle_mod.precision_recall(
            engine_bans, oracle_bans
        )

        chaotic = self.chaos is not None
        fw = getattr(self.matcher, "_fw_pipeline", None)
        dw = getattr(self.matcher, "device_windows", None)
        invariants: Dict[str, bool] = {
            "accounting": admitted == processed + shed + drain_err,
            "no_leaked_turns": fw is None or fw.idle(),
            "no_leaked_pins": (
                dw is None or int(dw._pin_counts.sum()) == 0
            ),
        }
        if n_cmds and not chaotic:
            invariants["commands_drained"] = (
                self._commands_handled == n_cmds
            )
        if sc.benign and not chaotic:
            invariants["benign_no_bans"] = not engine_bans
            invariants["benign_slo_clean"] = not any(
                self.slo.breached().values()
            )
        if chaotic and self.flightrec is not None:
            invariants["bundle_per_episode"] = all(
                ep.bundle for ep in self.chaos.episodes
            )
        if challenge is not None and not chaotic:
            invariants["challenge_ban_exact"] = (
                challenge["ban_precision"] == 1.0
                and challenge["ban_recall"] == 1.0
            )
            invariants["challenge_state_bounded"] = (
                challenge["failure_state_bounded"]
            )

        episodes = self.chaos.rows() if chaotic else []
        report = ScenarioReport(
            name=sc.name,
            seed=sc.seed,
            scale=sc.scale,
            mode=(
                "tailer" if self.via_tailer
                else "kafka" if self.kafka_broker is not None else "direct"
            ),
            single_kernel=self.single_kernel,
            n_lines=n_lines,
            n_commands=n_cmds,
            feed_s=round(feed_s, 4),
            lines_per_sec=round(n_lines / feed_s, 1),
            shed_lines=shed,
            drain_error_lines=drain_err,
            stale_lines=stale,
            shed_ratio=round((shed + drain_err) / max(1, admitted), 6),
            fallback_batches=delta("PipelineFallbackBatches"),
            refused_lines=self.matcher.refused_lines - refused_before,
            engine_bans=len(engine_bans),
            oracle_bans=len(oracle_bans),
            true_positives=tp,
            precision=round(precision, 6),
            recall=round(recall, 6),
            device_p99_ms=peek.get("PipelineDeviceP99Ms"),
            slo_burn_peak={k: round(v, 4) for k, v in sorted(peaks.items())},
            slo_breached=self.slo.breached(),
            invariants=invariants,
            episodes=episodes,
            incidents=(
                self.flightrec.incident_count if self.flightrec else 0
            ),
            command_items=self._commands_handled,
            challenge=challenge,
        )
        scen_stats.get_stats().note_run(
            sc.name,
            {
                "lines_per_sec": report.lines_per_sec,
                "shed_ratio": report.shed_ratio,
                "precision": report.precision,
                "recall": report.recall,
                "slo_burn_peak": max(peaks.values()) if peaks else 0.0,
            },
            episodes=len(episodes),
            invariant_failures=sum(
                1 for v in invariants.values() if not v
            ),
        )
        return report
