"""TorchMatcher: the regex rate-limit log path on the card (port of
`banjax_tpu/matcher/runner.py` TpuMatcher, deploy configuration).

Per batch of log lines (with matcher_device_windows on):

  host gate: the native batch parse + byte-class encode (`native/
    fastparse.c`, columnar work set, allowlist per distinct (host, ip)),
    or with matcher_native_parse: false the Python parse_line per line
    and the Python encode
    -> slot admission (slot_admission_enabled): rows of unseen IPs the
       traffic sketch does not put over the cheapest threshold are
       refused a device slot; they are matched statelessly (kernel A),
       their windows step on the host (`DeviceWindows.apply_host_events`)
       and they replay first
    -> per chunk of matcher_batch_lines, one device program
       (fused_windows): two-stage NFA match (kernel A), dense bitmap,
       overflow/chain gate, window commit (kernel B), compact result
    -> host replay of the window events into ConsumeLineResults and the
       Banner (ban_or_challenge_ip + log_regex_ban), per-site-then-global
       rule order.

A chunk that overflows a capacity (or follows one still outstanding)
commits nothing and replays through the classic path: single-stage match
(kernel A) when stage 2 missed candidates, then `DeviceWindows.
apply_bitmap` (kernel B). Batches with lines the device cannot decide
(non-ASCII or over-long) or rules the compiler cannot lower take the
classic path with host `re` for those lines or rules.

`pallas_single_kernel: off` selects the two-program commit instead
(`fused_windows.py`): program A (the stateless match and every overflow
flag, kernel A) runs per chunk at submit, program B (the window commit,
kernel B) at resolve, in chunk order. "auto" and "on" select the single
program; nothing downgrades from one to the other on a fault.

Host windows (matcher_device_windows: false): the match stays on the card
(kernel A, through the prefilter or the mesh), and the window states are
the host's `RegexRateLimitStates`, stepped per matched line in the
reference order (`_apply_host_windows`), with no slots, no sketch and no
kernel B.

Each committed chunk also folds into the traffic sketch (`obs/sketch.py`)
on the card. Unlike the JAX runner, nothing here swallows an error of
the sketch hooks or the admission gate: a fault reaches the caller.

The circuit breaker (`resilience/breaker.py`) brackets every batch: a
batch that raises records a failure and re-raises; while the breaker is
open, `consume_lines` raises `BreakerOpen` before it touches the card and
counts the refusal. The JAX runner reruns such batches on its host
reference matcher; the port moves no work to the host. A batch over
`matcher_latency_budget_ms` is counted (`budget_trips`) and, unlike in
the JAX runner, is not a breaker failure: an open breaker here refuses
lines, so tripping on a slow but working card would turn lateness into
loss. (The JAX runner's budget derived from the pipeline's device p99
feeds only its breaker, and is not ported.)

The streaming pipeline's split protocol (`pipeline/scheduler.py`):
`pipeline_begin` (or `encode_shard` per row shard and
`pipeline_begin_from_shards`) parses on fresh buffers; `pipeline_submit`
runs the admission gate, applies the refused rows' windows on the host
and commits each chunk in one device program (kernel A then kernel B),
with the 10 s staleness cut taken from the scheduler's clock;
`pipeline_collect` waits for the chunks' result copies; `pipeline_finish`
replays everything in admission order on the drain thread. A batch that
cannot commit at submit (slot refusal, host-eval rows, `pipeline_fused:
false`, or an earlier batch that still owes a drain-time window apply)
takes the classic pend: its match at submit, its windows at its drain.
In two-program mode submit dispatches program A for every chunk of the
batch (or, when a slot allocation refuses, abandons them and takes the
classic pend), and the drain re-cuts staleness at its own clock and
dispatches program B chunk by chunk in admission order, keeping up to
drain_resolve_depth - 1 resolved chunks' replays pending so that one
chunk's event pull and replay overlap the next chunk's program B. Host
windows apply at the drain too. Where the JAX runner replays a batch's
refused rows at submit, the port replays them at the batch's drain, so
ban-log order stays the synchronous path's.

Mesh mode (`matcher_mesh_devices` > 0, `parallel/mesh.py`): the rules
compile into rp * k shards (k the least that fits kernel A's words a
shard), and every match goes through `ShardedMatchBackend` over a dp x rp
grid of devices (the fused two-stage when `matcher_prefilter` is on).
As in JAX there is then no single-program commit: each batch takes the
classic path, its windows committed by `DeviceWindows.apply_bitmap`
(kernel B). The members' devices come from `mesh_devices` (one a member,
repeats allowed), else cuda:0 .. cuda:N-1 on the card or N times the CPU;
a CUDA matcher asking for more members than cards runs single-device,
with a warning, as JAX does.

Observability (`obs/`): each committed chunk's program runs inside a
`program-ab-fused` span (a child of the scheduler's `submit`; in
two-program mode `program-a` there and `program-b` under `drain`), its
drain pull and replay inside `effector-replay` (a child of `drain`), a
gated chunk's fallback marks a `fused-overflow-fallback` instant; a breaker trip
records a `breaker-trip` instant and notifies the flight recorder; every
rate-limit ban is recorded in the provenance ledger with its rule, rule
index and the threshold's hit, under the drain's trace id.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from banjax_tpu_torch.config import Config, RegexWithRate
from banjax_tpu_torch.decisions.rate_limit import RateLimitResult, RegexRateLimitStates
from banjax_tpu_torch.decisions.static_lists import StaticDecisionLists
from banjax_tpu_torch.device import DeviceLike, resolve_device
from banjax_tpu_torch.effectors.banner import BannerInterface
from banjax_tpu_torch.matcher.api import ConsumeLineResult, Matcher, RuleResult
from banjax_tpu_torch.matcher.cpu_ref import apply_matched_rule
from banjax_tpu_torch.matcher.encode import ParsedLine, encode_for_match, parse_line
from banjax_tpu_torch.matcher.fused_windows import FusedWindowsPipeline, PipelineOverflow
from banjax_tpu_torch.matcher.kernels import fused_match_window, nfa_match
from banjax_tpu_torch.matcher.prefilter import FusedPrefilter, PrefilterOverflow, build_plan
from banjax_tpu_torch.matcher.rulec import compile_rules
from banjax_tpu_torch.matcher.windows import DeviceWindows, split_ns
from banjax_tpu_torch.matcher.workset import (
    CompositeWork,
    LazyResults,
    ListWork,
    NativeWork,
    unique_spans,
)
from banjax_tpu_torch.obs import flightrec, provenance, trace
from banjax_tpu_torch.obs.sketch import TrafficSketch
from banjax_tpu_torch.obs.stages import StageClock
from banjax_tpu_torch.obs.stats import MatcherStats
from banjax_tpu_torch.parallel import mesh
from banjax_tpu_torch.resilience import failpoints
from banjax_tpu_torch.resilience.breaker import CLOSED, CircuitBreaker
from banjax_tpu_torch.resilience.health import HealthStatus

log = logging.getLogger(__name__)

OLD_LINE_CUTOFF_SECONDS = 10
_MIN_BUCKET = 64

# process-wide warn-once for drain_resolve_depth on the single program
# (tests build many matchers; one log line is the signal)
_DEPTH_IGNORED_WARNED = False


class BreakerOpen(RuntimeError):
    """The matcher's breaker is open: the batch was refused before it
    touched the card (and counted in `refused_batches`/`refused_lines`)."""


class TorchMatcher(Matcher):
    # True when drain_resolve_depth > 1 is configured but the single
    # program leaves nothing to overlap (SingleKernelDepthIgnored)
    single_kernel_depth_ignored = False

    def __init__(
        self,
        config: Config,
        banner: BannerInterface,
        decision_lists: StaticDecisionLists,
        rate_limit_states: Optional[RegexRateLimitStates] = None,
        device: DeviceLike = None,
        health=None,
        mesh_devices: Optional[Sequence[DeviceLike]] = None,
    ):
        """`rate_limit_states`: the host window states that host windows
        (matcher_device_windows: false) step; a fresh one when None."""
        self.device = resolve_device(device)
        self.config = config
        self.banner = banner
        self.decision_lists = decision_lists
        self.rate_limit_states = (rate_limit_states if rate_limit_states is not None
                                  else RegexRateLimitStates())
        dev = self.device

        # the circuit breaker around the device batch path, and the
        # configured latency budget
        self.breaker = CircuitBreaker(
            failure_threshold=config.breaker_failure_threshold,
            recovery_seconds=config.breaker_recovery_seconds,
            window_size=config.breaker_window_size,
            name="matcher-device",
            on_trip=self._on_breaker_trip,
        )
        self._latency_budget_s = config.matcher_latency_budget_ms / 1e3
        self.budget_trips = 0      # batches over the latency budget
        self.refused_batches = 0   # batches the open breaker refused
        self.refused_lines = 0
        self.stats = MatcherStats()
        self._health_registry = health
        self._health = health.register("matcher") if health is not None else None
        # the split protocol: pipeline_fused false sends every batch down
        # the classic pend
        self._pipeline_fused = config.pipeline_fused
        # the two-program drain's resolve-ahead: up to depth - 1 resolved
        # chunks wait for their replay while the next chunk's program B
        # runs (1: the serial drain); the EWMA of the overlapped replays
        self._drain_resolve_depth = config.drain_resolve_depth
        self.drain_resolve_overlap_ms_ewma: Optional[float] = None
        self.pipelined_fused_chunks = 0
        self.pipelined_fused_fallbacks = 0
        # batches whose window apply waits for their drain (classic pend):
        # while any is outstanding, a later batch must not commit at submit
        self._drain_window_lock = threading.Lock()
        self._drain_window_batches = 0

        # rule table: per-site rules first, then global — rule id i is
        # column i of the match bitmap, end to end
        self._entries: List[Tuple[Optional[str], RegexWithRate]] = []
        self._per_site_idx: Dict[str, List[int]] = {}
        for site, rules in config.per_site_regexes_with_rates.items():
            for r in rules:
                self._per_site_idx.setdefault(site, []).append(len(self._entries))
                self._entries.append((site, r))
        self._global_idx: List[int] = []
        for r in config.regexes_with_rates:
            self._global_idx.append(len(self._entries))
            self._entries.append((None, r))
        patterns = [r.regex_string for _, r in self._entries]

        # mesh mode: the members' devices (None: more than the attached
        # cards, single-device) and the rule-parallel degree
        members, rp = None, 0
        if config.matcher_mesh_devices > 0:
            members = mesh.mesh_placement(config.matcher_mesh_devices, dev, mesh_devices)
            if members is not None:
                rp = mesh.resolve_rp(config.matcher_mesh_devices, config.matcher_mesh_rp)

        # one compile; "auto" shards keep every shard within the kernel's
        # words-per-block, mesh mode packs rp * k shards (byte classes do
        # not depend on the shard count)
        if rp:
            self.compiled = mesh.compile_for_mesh(patterns, rp)
        else:
            self.compiled = compile_rules(patterns, n_shards="auto")
        for i, reason in self.compiled.unsupported.items():
            log.info("rule %r falls back to the host regex path: %s",
                     self._entries[i][1].rule, reason)
        self._host_rule_idx = [
            i for i in range(len(self._entries)) if not self.compiled.device_ok[i]
        ]
        self._nfa = None if rp else nfa_match.prepare(self.compiled, dev)
        self._max_len = config.matcher_max_line_len
        self._max_batch = max(_MIN_BUCKET, config.matcher_batch_lines)
        self.clock = StageClock()

        # native batch parse: built and loaded here, so a matcher that asks
        # for it either has it or fails to start. The scratch buffers are
        # reused batch after batch (each batch is consumed before the next
        # parse); the allowlist cache holds one static-lists generation's
        # results per distinct (host, ip)
        self._native = config.matcher_native_parse
        self._parse_scratch = self._dedup_scratch = None
        self._allow_cache: Dict[Tuple[str, str], bool] = {}
        self._allow_cache_snap = None
        if self._native:
            from banjax_tpu_torch import native

            native.FASTPARSE.lib()
            self._parse_scratch = native.ParseScratch()
            self._dedup_scratch = native.DedupScratch()

        # the window counters on the device, or (None) the host states;
        # the sketch, the admission gate and the active table exist only
        # beside device windows, as in JAX
        self.device_windows: Optional[DeviceWindows] = None
        self.traffic_sketch: Optional[TrafficSketch] = None
        self._active_table = None
        self._host_row: Dict[str, int] = {}
        if config.matcher_device_windows:
            self._build_device_windows(config, dev)
        self._slot_admission = config.slot_admission_enabled and self.traffic_sketch is not None
        me = config.slot_admission_min_estimate
        if me <= 0:
            me = max(1, min((r.hits_per_interval for _, r in self._entries), default=0) + 1)
        self.admission_min_estimate = me

        # two-stage prefilter, sharing this matcher's byte classes so one
        # encode feeds both stages and the single-stage fallback; None when
        # the ruleset has too few filterable rules
        self._prefilter = None
        self._mesh_matcher = None
        if rp:
            self._mesh_matcher = self._build_mesh(config, patterns, members, rp, health)
        elif config.matcher_prefilter:
            plan = build_plan(
                patterns,
                byte_classes=(self.compiled.byte_to_class, self.compiled.n_classes),
            )
            if plan is not None:
                self._prefilter = FusedPrefilter(
                    plan, dev, cand_frac=config.matcher_prefilter_cand_frac
                )

        self._rule_pos_cache: Dict[str, Dict[int, int]] = {}
        self._global_pos = {int(x): k for k, x in enumerate(self._global_idx)}

        # the chunk commit when device windows and the prefilter are on
        # and every rule is device-decidable (host-fallback rules need the
        # classic bitmap path): one program a chunk, or the two programs
        self._fw_pipeline = None
        if (self.device_windows is not None and self._prefilter is not None
                and not self._host_rule_idx):
            single = self._resolve_single_kernel(config)
            self._fw_pipeline = FusedWindowsPipeline(
                self._prefilter, self.device_windows, self._active_table,
                self.compiled.n_rules, single_kernel=single,
                traffic_sketch=self.traffic_sketch, clock=self.clock,
            )

    def _build_device_windows(self, config: Config, dev: torch.device) -> None:
        self.device_windows = DeviceWindows(
            [r for _, r in self._entries],
            capacity=config.matcher_window_capacity, device=dev,
            native_slotmgr=config.slotmgr_native,
            warm_tier_enabled=config.warm_tier_enabled,
            warm_tier_capacity=config.warm_tier_capacity,
        )
        # the traffic sketch on this matcher's device, for the slot-
        # admission gate's estimates
        if config.traffic_sketch_enabled:
            self.traffic_sketch = TrafficSketch(
                [r.rule for _, r in self._entries], dev,
                depth=config.traffic_sketch_depth, width=config.traffic_sketch_width,
                hll_p=config.traffic_sketch_hll_p,
                pull_seconds=config.traffic_sketch_pull_seconds,
                topk=config.traffic_sketch_topk,
                max_candidates=config.traffic_sketch_candidates,
            )
        # active_table[h, rid]: rule rid applies to lines of host row h
        # (that host's per-site rules + the global rules) minus hosts_to_skip
        hosts = sorted(
            set(self._per_site_idx)
            | {h for _, r in self._entries for h in r.hosts_to_skip}
        )
        self._host_row = {h: i + 1 for i, h in enumerate(hosts)}
        table = np.zeros((len(hosts) + 1, max(1, len(self._entries))), dtype=bool)
        for row_host, row in [(None, 0)] + list(self._host_row.items()):
            ids = (self._per_site_idx.get(row_host, []) if row_host else []) + self._global_idx
            for idx in ids:
                if row_host and self._entries[idx][1].hosts_to_skip.get(row_host):
                    continue
                table[row, idx] = True
        self._active_table = torch.from_numpy(table).to(dev)

    def _resolve_single_kernel(self, config: Config) -> bool:
        """`pallas_single_kernel`: "off" selects the two-program commit,
        "auto" and "on" the single program. Either way kernel B is built
        and held against its plain version first; a failure raises (the
        JAX runner's selftest downgrade to two programs is not ported).
        The "matcher-single-kernel" health component carries JAX's texts;
        on the CPU the scan is the plain version, JAX's interpret-mode
        counterpart."""
        comp = (self._health_registry.register("matcher-single-kernel")
                if self._health_registry is not None else None)
        fused_match_window.scan_selftest(self.device)
        if config.pallas_single_kernel == "off":
            if comp is not None:
                comp.ok("pallas_single_kernel: off (two-program path)")
            return False
        depth_note = ""
        if self._drain_resolve_depth > 1:
            self.single_kernel_depth_ignored = True
            depth_note = (f"; drain_resolve_depth={self._drain_resolve_depth} is a "
                          "no-op here (no program-B dispatch to overlap)")
            global _DEPTH_IGNORED_WARNED
            if not _DEPTH_IGNORED_WARNED:
                _DEPTH_IGNORED_WARNED = True
                log.warning(
                    "drain_resolve_depth=%d is configured but the single-kernel fused "
                    "path commits at submit — the resolve-ahead depth is a no-op (set "
                    "pallas_single_kernel: off to use it, or drop the key)",
                    self._drain_resolve_depth,
                )
        if comp is not None:
            scan = "(interpret scan)" if self.device.type == "cpu" else "(compiled scan)"
            comp.ok("single-kernel fused path active " + scan + depth_note)
        return True

    def _build_mesh(self, config, patterns, members, rp, health) -> mesh.ShardedMatchBackend:
        """The sharded match backend (JAX `runner.py:321-377`): stage 2 of
        the fused plan packed like the full ruleset, into rp * k shards.
        Like the JAX matcher, it keeps the backend's default candidate
        fraction and the 8-line block of the non-compiled backends
        (`mesh._CAND_FRAC`, `mesh._BLOCK_B`)."""
        plan = None
        if config.matcher_prefilter:
            plan = build_plan(
                patterns,
                byte_classes=(self.compiled.byte_to_class, self.compiled.n_classes),
                stage2_shards=self.compiled.n_shards,
            )
        m = mesh.make_mesh(members, rp=rp)
        backend = mesh.ShardedMatchBackend(
            self.compiled, m, self._max_len, plan=plan,
            health=health.register("matcher-mesh") if health is not None else None,
        )
        log.info("matcher mesh: dp=%d rp=%d shards=%d prefilter=%s", m.dp, rp,
                 self.compiled.n_shards, plan is not None)
        return backend

    def close(self) -> None:
        """Release what the matcher holds — the native slot manager, the warm
        tier's mapping and every tensor on the device — so that a reload
        does not hold two matchers' state. The matcher is unusable
        afterwards; the caller drops its reference as well."""
        if self.device_windows is not None:
            self.device_windows.close()
        self.device_windows = None
        self._fw_pipeline = None
        self._prefilter = None
        self._mesh_matcher = None
        self.traffic_sketch = None
        self._nfa = None
        self._active_table = None

    def bind_thread(self) -> None:
        """Make this matcher's card the calling thread's current CUDA
        device (it is per thread): the pipeline's stage threads call this
        before their device work."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    # ---- Matcher API ----

    def consume_lines(
        self, lines: Sequence[str], now_unix: Optional[float] = None,
        _fused_ok: bool = True,
    ) -> List[ConsumeLineResult]:
        """The breaker-guarded batch entry point. Open: the batch is refused
        (`BreakerOpen`) before it touches the card. Closed or half-open: the
        batch runs; one that raises records a breaker failure and re-raises
        (nothing is rerun on the host)."""
        if not self.breaker.allow():
            self._refuse(len(lines))
        t0 = time.perf_counter()
        try:
            try:
                results = self._consume_lines_inner(lines, now_unix, _fused_ok)
            except Exception:
                self.breaker.record_failure()
                self._note_health()
                raise
            self._note_budget(time.perf_counter() - t0)
            self.breaker.record_success()
            self._note_health()
            return results
        finally:
            self.stats.record_batch(len(lines), time.perf_counter() - t0)

    def consume_lines_serial(
        self, lines: Sequence[str], now_unix: Optional[float] = None
    ) -> List[ConsumeLineResult]:
        """consume_lines without the fused program: the pipeline's generic
        drain. Later batches' chunks may hold the fused pipeline's order
        turns while this batch drains, and a fused burst here would wait on
        turns that only free after this very drain (the JAX runner's
        reason too). The classic path it takes gives the same results."""
        return self.consume_lines(lines, now_unix, _fused_ok=False)

    def _consume_lines_inner(self, lines, now_unix, fused_ok) -> List[ConsumeLineResult]:
        now = time.time() if now_unix is None else now_unix
        results = LazyResults(len(lines))
        with self.clock("gate"):
            work, encoded = self._gate(lines, now, results)
        if not len(work):
            return results
        # refused rows replay before admitted rows (the JAX runner's order)
        with self.clock("admission"):
            part = self._partition_admission(work, encoded)
        if part is not None:
            work, encoded, work_r, encoded_r = part
            with self.clock("refused"):
                self._replay_refused(self._refused_events(work_r, encoded_r), results)
            if not len(work):
                return results
        if encoded is None:
            with self.clock("encode"):
                encoded = encode_for_match(
                    self.compiled, [p.rest for _, p in work], self._max_len
                )
        cls_ids, lens, host_eval = encoded
        if fused_ok and self._fw_pipeline is not None and not host_eval.any():
            self._consume_via_pipeline(work, cls_ids, lens, results)
            return results
        with self.clock("chunk"):
            bits = self._match_bits(work, encoded)
        self._apply_windows(work, bits, results)
        return results

    # ---- the breaker, the latency budget, health ----

    def _refuse(self, n_lines: int) -> None:
        self.refused_batches += 1
        self.refused_lines += n_lines
        self._note_health()
        raise BreakerOpen(
            f"matcher breaker {self.breaker.state}: a batch of {n_lines} lines "
            "is refused (the port reruns nothing on the host)"
        )

    def _on_breaker_trip(self, name: str) -> None:
        trace.instant("breaker-trip", {"breaker": name})
        flightrec.notify("breaker-trip", name)

    def _note_budget(self, elapsed_s: float) -> None:
        # matcher_latency_budget_ms (0 = off). The JAX runner derives a
        # budget from the pipeline's device p99 when it is unset, because
        # there a breach is a breaker failure; here it is only counted
        budget = self._latency_budget_s
        if budget and elapsed_s > budget:
            self.budget_trips += 1

    def note_device_outcome(self, elapsed_s: float, ok: bool) -> None:
        """Breaker and health accounting for a device dispatch the pipeline
        drives (its submit and collect stages, the probe)."""
        if ok:
            self._note_budget(elapsed_s)
            self.breaker.record_success()
        else:
            self.breaker.record_failure()
        self._note_health()

    def _note_health(self) -> None:
        if self._health is None:
            return
        state = self.breaker.state
        if state == CLOSED:
            self._health.ok()
        else:
            self._health.set_status(
                HealthStatus.DEGRADED,
                f"breaker {state}; batches are refused, not rerouted",
            )

    def probe(self, now_unix: Optional[float] = None) -> bool:
        """A synthetic device probe: one canned line through the stateless
        match (kernel A), no window update and no Banner effect, so that a
        wedged card trips the breaker while the log is idle, and so that a
        half-open breaker can close without traffic. False when the probe
        failed or the breaker refused it."""
        if not self.breaker.allow():
            return False
        now = time.time() if now_unix is None else now_unix
        line = (f"{now:.6f} 203.0.113.1 GET banjax-probe.invalid "
                "GET /__banjax_probe HTTP/1.1 probe -")
        t0 = time.perf_counter()
        try:
            lw = ListWork()
            lw.append((0, parse_line(line, now, OLD_LINE_CUTOFF_SECONDS)))
            self._match_bits(lw, None)
        except Exception:  # noqa: BLE001 — a failed probe is the signal; it is counted
            log.exception("matcher device probe failed")
            self.note_device_outcome(time.perf_counter() - t0, ok=False)
            return False
        self.note_device_outcome(time.perf_counter() - t0, ok=True)
        return self.breaker.state == CLOSED

    def _gate(self, lines, now, results, use_scratch=True, parse_threads=None):
        """Host parse + allowlist exemption -> (work, (cls_ids, lens,
        host_eval) or None): one native pass when configured, else the
        Python parse per line (encoded later). `use_scratch=False` (the
        pipeline's split path) parses into fresh buffers: with batches in
        flight, one batch's work set must not alias buffers the next
        parse reuses."""
        if self._native:
            from banjax_tpu_torch import native

            nb = native.parse_encode_batch(
                lines, self.compiled.byte_to_class, self._max_len, now,
                OLD_LINE_CUTOFF_SECONDS,
                scratch=self._parse_scratch if use_scratch else None,
                max_threads=parse_threads,
            )
            if nb is not None:
                return self._native_gate(nb, lines, now, results, use_scratch)
        work = ListWork()
        for i, text in enumerate(lines):
            p = parse_line(text, now, OLD_LINE_CUTOFF_SECONDS)
            if p.error:
                log.warning("could not parse log line: %r", text)
                results[i].error = True
                continue
            if p.old_line:
                results[i].old_line = True
                continue
            if self.decision_lists.check_is_allowed(p.host, p.ip):
                results[i].exempted = True
                continue
            work.append((i, p))
        return work, None

    def _native_gate(self, nb, lines, now, results, use_scratch=True):
        """The gate over a native ParsedBatch, columnar: flag masks, unique
        ip/host tables, the allowlist per distinct (host, ip) with a cache,
        a NativeWork, and the pre-encoded class ids (int32 [n, max_len],
        zero past each length). FLAG_DEFER rows re-parse and re-encode
        through the Python path, as the JAX runner does."""
        from banjax_tpu_torch import native

        n = nb.n
        flags = np.asarray(nb.flags[:n])
        err = (flags & native.FLAG_ERROR) != 0
        old = (flags & native.FLAG_OLD) != 0
        ts = nb.ts_ns[:n].astype(np.int64, copy=True)

        defer_map: Dict[int, ParsedLine] = {}
        for r in np.flatnonzero(flags & native.FLAG_DEFER).tolist():
            p = parse_line(lines[r], now, OLD_LINE_CUTOFF_SECONDS)
            defer_map[r] = p
            err[r] = p.error
            old[r] = p.old_line
            if not p.error:
                # Python float()*1e9 can exceed int64: clamp the window
                # column only (replay reads the exact int of the ParsedLine)
                ts[r] = min(max(p.timestamp_ns, -(2**63)), 2**63 - 1)

        for r in np.flatnonzero(err).tolist():
            log.warning("could not parse log line: %r", lines[r])
            results[r].error = True
        for r in np.flatnonzero(old & ~err).tolist():
            results[r].old_line = True

        cand = np.flatnonzero(~err & ~old)
        if cand.size == 0:
            return ListWork(), None

        # distinct ip/host tables over the candidate rows; deferred rows
        # have no blob spans and join the tables afterwards, in line order
        darr = np.asarray(sorted(defer_map), dtype=np.int64)
        vmask = ~np.isin(cand, darr) if darr.size else np.ones(cand.size, dtype=bool)
        vrows = cand[vmask]
        text = nb.text()
        dedup = self._dedup_scratch if use_scratch else None
        ips_u, ip_inv_v = unique_spans(nb.ip_off[vrows], nb.ip_len[vrows], nb.blob, text,
                                       dedup)
        hosts_u, host_inv_v = unique_spans(nb.host_off[vrows], nb.host_len[vrows], nb.blob,
                                           text, dedup)
        ip_inv = np.empty(cand.size, dtype=np.int64)
        host_inv = np.empty(cand.size, dtype=np.int64)
        ip_inv[vmask] = ip_inv_v
        host_inv[vmask] = host_inv_v
        if darr.size:
            iidx = {v: j for j, v in enumerate(ips_u)}
            hidx = {v: j for j, v in enumerate(hosts_u)}
            for r in darr.tolist():
                k = int(np.searchsorted(cand, r))
                if k >= cand.size or cand[k] != r:
                    continue  # an errored or stale deferred row
                p = defer_map[r]
                ip_inv[k] = iidx.setdefault(p.ip, len(ips_u))
                if ip_inv[k] == len(ips_u):
                    ips_u.append(p.ip)
                host_inv[k] = hidx.setdefault(p.host, len(hosts_u))
                if host_inv[k] == len(hosts_u):
                    hosts_u.append(p.host)

        # allowlist per distinct (host, ip), cached until the static lists
        # change (a reload bumps their generation)
        snap = (self.decision_lists, self.decision_lists.generation)
        if self._allow_cache_snap != snap or len(self._allow_cache) > 500_000:
            self._allow_cache = {}
            self._allow_cache_snap = snap
        if self.decision_lists.has_any_allow_entries():
            n_ip = max(1, len(ips_u))
            upair, upair_inv = np.unique(host_inv * n_ip + ip_inv, return_inverse=True)
            allowed_u = np.empty(upair.size, dtype=bool)
            cache = self._allow_cache
            check = self.decision_lists.check_is_allowed
            for j, pr in enumerate(upair.tolist()):
                key = (hosts_u[pr // n_ip], ips_u[pr % n_ip])
                v = cache.get(key)
                if v is None:
                    v = cache[key] = check(*key)
                allowed_u[j] = v
            allowed = allowed_u[upair_inv]
            for k in np.flatnonzero(allowed).tolist():
                results[int(cand[k])].exempted = True
            keep = ~allowed
            rows = cand[keep]
        else:
            keep = slice(None)
            rows = cand
        if rows.size == 0:
            return ListWork(), None
        work = NativeWork(nb, rows, ips_u, ip_inv[keep], hosts_u, host_inv[keep], ts[rows],
                          defer_map)

        if rows.size == n:
            # nothing filtered: views of the parse scratch, no gather copy
            cls_ids, lens = nb.cls_ids[:n], nb.lens[:n]
        else:
            cls_ids, lens = nb.cls_ids[rows], nb.lens[rows]
        host_eval = (flags[rows] & native.FLAG_HOST_EVAL) != 0
        deferred = (flags[rows] & native.FLAG_DEFER) != 0
        if deferred.any():
            d_idx = np.flatnonzero(deferred)
            d_cls, d_lens, d_he = encode_for_match(
                self.compiled, [work[int(k)][1].rest for k in d_idx], self._max_len
            )
            cls_ids[d_idx] = d_cls
            lens[d_idx] = d_lens
            host_eval[d_idx] = d_he
        return work, (cls_ids, lens, host_eval)

    # ---- slot admission ----

    def _partition_admission(self, work, encoded):
        """Split one batch at the slot-admission gate: None when admission
        is off or every row is admitted, else (work_admitted,
        encoded_admitted, work_refused, encoded_refused). The split is per
        distinct IP, so each IP's rows stay on one side in order. The gate
        admits on `estimate + this batch's rows`; refused rows fold into
        the sketch's host mirror so the next batch's estimate has them."""
        if not self._slot_admission or not len(work):
            return None
        uips, uinv = work.unique_ips()
        counts = np.bincount(uinv, minlength=len(uips)).astype(np.int64)
        sk = self.traffic_sketch
        hashes = sk.base_hashes(uips)
        est = sk.estimate_ips(uips, hashes=hashes) + counts
        mask_u = self.device_windows.admission_mask(
            uips, estimates=est, min_estimate=self.admission_min_estimate, counts=counts,
        )
        if mask_u.all():
            return None
        refused_u = np.flatnonzero(~mask_u)
        sk.fold_refused([uips[int(i)] for i in refused_u], counts[refused_u],
                        hashes=hashes[refused_u])
        row_mask = mask_u[uinv]
        adm = np.flatnonzero(row_mask)
        ref = np.flatnonzero(~row_mask)
        enc_a = enc_r = None
        if encoded is not None:
            cls_ids, lens, host_eval = encoded
            enc_a = (cls_ids[adm], lens[adm], host_eval[adm])
            enc_r = (cls_ids[ref], lens[ref], host_eval[ref])
        return work.take(adm), enc_a, work.take(ref), enc_r

    def _refused_events(self, work, encoded):
        """Slot-refused rows: a stateless match (kernel A through the
        prefilter, no slot, no device window state), then the window steps
        on the host in (line, rule_id) order, homed in the warm tier.
        Returns what `_replay_refused` replays: (work, bits, events), or
        None when there are no rows."""
        if not len(work):
            return None
        bits = self._match_bits(work, encoded)
        events_in = []
        for row in np.flatnonzero(bits.any(axis=1)).tolist():
            _, p = work[row]
            pos = self._rule_pos(p.host)
            # applicable rule ids ascending == per-site-then-global
            for idx in sorted(x for x in np.nonzero(bits[row])[0].tolist() if x in pos):
                if self._entries[idx][1].hosts_to_skip.get(p.host):
                    continue  # no window event (the active table's rule)
                events_in.append((row, idx, p.ip, p.timestamp_ns))
        return work, bits, self.device_windows.apply_host_events(events_in)

    def _replay_refused(self, refused, results) -> None:
        if refused is not None:
            work, bits, events = refused
            self._replay_window_events(work, bits, None, events, results)

    # ---- the streaming pipeline's split protocol (pipeline/scheduler.py) ----
    #
    # consume_lines cut at its seams so that the scheduler runs the pieces
    # on its stage threads: begin (parse, gate, encode) on the encode
    # thread, submit (admission, refused rows' windows, one device program
    # a chunk) and collect (wait for the result copies) on the device
    # thread, finish (replay into results and the Banner) on the drain
    # thread, one batch at a time in admission order.

    def pipeline_begin(self, lines: Sequence[str], now: float) -> dict:
        """Encode stage: parse, gate and encode into fresh buffers (batches
        in flight must not share a parse scratch)."""
        results = LazyResults(len(lines))
        with self.clock("gate"):
            work, encoded = self._gate(lines, now, results, use_scratch=False)
        return self._pipeline_state(lines, results, work, encoded)

    def encode_shard(self, lines: Sequence[str], now: float):
        """One contiguous row shard of the encode stage, on the scheduler's
        encode pool: the native parse (one thread: the shard is one) and
        the gate, into fresh buffers. Row indices are the shard's own;
        `pipeline_begin_from_shards` rebases them."""
        results = LazyResults(len(lines))
        with self.clock("gate"):
            work, encoded = self._gate(lines, now, results, use_scratch=False, parse_threads=1)
        return work, encoded, results

    def pipeline_begin_from_shards(self, lines: Sequence[str], now: float, shards) -> dict:
        """Merge `encode_shard` outputs, [(row0, (work, encoded, results)),
        ...] in row order and covering `lines`, into the state
        `pipeline_begin` gives: results rebased by row0, the work sets
        joined in line order (`CompositeWork`), the encoded arrays
        concatenated, the distinct-IP table in global first-appearance
        order, so that slots, window events and ban-log bytes equal the
        single-thread encode's."""
        results = LazyResults(len(lines))
        parts, offsets, pres = [], [], []
        native_pre = True
        for row0, (work, pre, shard_results) in shards:
            results.absorb(shard_results, row0)
            if not len(work):
                continue
            parts.append(work)
            offsets.append(row0)
            if pre is None:
                native_pre = False
            else:
                pres.append(pre)
        if not parts:
            work, encoded = ListWork(), None
        elif len(parts) == 1 and offsets[0] == 0:
            work = parts[0]
            encoded = pres[0] if (native_pre and pres) else None
        else:
            work = CompositeWork(parts, offsets)
            # a shard the Python parse took has no encoded arrays: the
            # merged batch encodes from the rests
            encoded = (tuple(np.concatenate([p[k] for p in pres]) for k in range(3))
                       if native_pre else None)
        return self._pipeline_state(lines, results, work, encoded)

    def _pipeline_state(self, lines, results, work, encoded) -> dict:
        state = {"lines": lines, "results": results, "work": work, "pre": encoded,
                 "refused_rows": None, "refused": None, "fused": None, "classic": None,
                 "classic_pre": None, "pend": None, "bits": None, "fused_eligible": False}
        if self._pipeline_fused and self._fw_pipeline is not None and len(work):
            if encoded is None:
                with self.clock("encode"):
                    state["pre"] = encode_for_match(
                        self.compiled, [p.rest for _, p in work], self._max_len
                    )
            state["fused_eligible"] = not state["pre"][2].any()  # no host-eval rows
        return state

    def pipeline_submit(self, state: dict, now: Optional[float] = None) -> None:
        """Device stage. The admission gate splits the batch; the refused
        rows' windows step on the host now, so that the next batch's
        admission reads them (their replay waits for this batch's drain).
        The admitted rows commit chunk by chunk in one device program each
        (the live mask: rows younger than the cutoff at `now`), or, when
        that is not order-safe or a slot allocation refuses, take the
        classic pend from that row on: matched now, their windows applied
        at this batch's drain.

        If it raises once the batch has committed something (the refused
        rows' sketch fold and host steps, a chunk's program), the rows not
        committed take the classic path at this batch's drain, matched
        there (see `pipeline_recover`)."""
        if not len(state["work"]):
            return
        try:
            self._submit_stages(state, now)
        except BaseException:
            if self._committed(state):
                row0 = sum(len(e["work"]) for e in state["fused"] or ())
                if state["classic"] is None and row0 < len(state["work"]):
                    self._classic_rows(state, row0)
                state["pend"] = None
            raise

    def _submit_stages(self, state: dict, now: Optional[float]) -> None:
        with self.clock("admission"):
            part = self._partition_admission(state["work"], state["pre"])
        if part is not None:
            state["work"], state["pre"], work_r, pre_r = part
            # folded into the sketch: from here a rerun would count them twice
            state["refused_rows"] = (work_r, pre_r)
            with self.clock("refused"):
                state["refused"] = self._refused_events(work_r, pre_r)
            state["refused_rows"] = None
            if not len(state["work"]):
                return
        row0 = 0
        if state["fused_eligible"] and self._single_kernel_ordered():
            row0 = self._submit_fused_pipeline(state, now)
            if row0 == len(state["work"]):
                return
        self._classic_rows(state, row0)
        with self.clock("chunk"):
            state["pend"] = self._match_bits_submit(state["classic"], state["classic_pre"])

    def _classic_rows(self, state: dict, row0: int) -> None:
        """Rows row0.. of the admitted work apply their windows at this
        batch's drain: later batches must not commit at submit before
        then (the drain-window gate)."""
        work, pre = state["work"], state["pre"]
        state["classic"] = work[row0:] if row0 else work
        state["classic_pre"] = None if pre is None else tuple(a[row0:] for a in pre)
        with self._drain_window_lock:
            self._drain_window_batches += 1
        state["window_at_drain"] = True

    def _committed(self, state: dict) -> bool:
        """Whether the batch's submit changed window state: the refused
        rows' fold and host steps, or a single-program chunk. Program A
        changes none."""
        return bool(state["refused_rows"] is not None or state["refused"] is not None
                    or (state["fused"] and self._fw_pipeline.single_kernel))

    def pipeline_recover(self, state: dict) -> bool:
        """After a failed device stage (submit or collect): True when the
        batch had committed something — the refused rows' fold and host
        steps, a chunk's program on the card — so that rerunning it whole
        would count those hits twice. Its drain (`pipeline_finish`) then
        replays what was committed once and runs the rows that were not
        through the classic path, matched at the drain. False when nothing
        was committed: the caller aborts the batch and reruns it whole."""
        return self._committed(state)

    def _single_kernel_ordered(self) -> bool:
        """Committing at submit is order-safe only while no earlier batch
        still owes a drain-time window apply; otherwise this batch takes
        the classic pend too, and the drain thread applies in order. The
        two-program mode commits at drain anyway, so it never gates."""
        if not self._fw_pipeline.single_kernel:
            return True
        with self._drain_window_lock:
            return self._drain_window_batches == 0

    def _submit_fused_pipeline(self, state: dict, now: Optional[float] = None) -> int:
        """Run each chunk's program; returns the rows submitted.

        Single program: the rows committed, all of them or the chunks
        before the first whose slot allocation refused (in-flight batches
        hold pins until their drains). Unlike the JAX runner, which
        abandons every chunk of such a batch, committed chunks stay: a
        commit on the card cannot be taken back. A failure leaves the
        chunks committed so far in `state["fused"]` for the drain to
        replay, and re-raises.

        Two programs: program A (stateless) for every chunk, else none —
        a slot refusal or a failure abandons the chunks submitted so far
        (their turns and pins), as the JAX runner does; the batch then
        takes the classic pend, or the failure re-raises."""
        failpoints.check("matcher.device")
        work = state["work"]
        cls_ids, lens, _ = state["pre"]
        sk = self._fw_pipeline.single_kernel
        if sk and now is None:
            now = time.time()
        # the JAX span names: match and window commit are one program
        # (kernel A, then kernel B), or program A here and B at the drain
        span_name = "program-ab-fused" if sk else "program-a"
        mb = self._max_batch
        entries: List[dict] = []
        try:
            for s in range(0, len(work), mb):
                wc = work[s : s + mb]
                stale = live = None
                if sk:
                    st = (now - wc.ts_array() / 1e9) > OLD_LINE_CUTOFF_SECONDS
                    if st.any():
                        stale, live = st, ~st
                with trace.span(span_name, args={"row0": s}):
                    e = self._submit_pipeline_chunk(wc, cls_ids[s : s + mb], lens[s : s + mb],
                                                    live=live)
                if e is None:
                    if not sk:
                        self._abandon_entries(entries)
                        entries = []
                    break
                e.update(row0=s, live=live, stale=stale)
                entries.append(e)
                if sk:
                    state["fused"] = entries
        except BaseException:
            if not sk:
                self._abandon_entries(entries)
            raise
        state["fused"] = entries or None
        return sum(len(e["work"]) for e in entries)

    def _abandon_entries(self, entries: List[dict]) -> None:
        for e in entries:
            self._fw_pipeline.abandon(e["pend"])

    def pipeline_collect(self, state: dict) -> None:
        """Device stage, later: wait for the chunks' buffer copies
        (program A's in two-program mode), and pull the classic pend's
        match bits. If it raises, single-program chunks stay for the drain
        (whose resolve waits for them itself) and the classic rows are
        matched again there; program-A chunks committed nothing, and the
        scheduler aborts them and reruns the batch."""
        entries = state["fused"]
        if entries:
            with self.clock("chunk"):
                for e in entries:
                    if e["pend"].copied is not None:
                        e["pend"].copied.synchronize()
        pend, state["pend"] = state["pend"], None
        if pend is not None:
            with self.clock("chunk"):
                state["bits"] = self._match_bits_collect(pend)

    def pipeline_abort(self, state: dict) -> None:
        """Settle a batch that will not finish (its device stage or its
        drain failed): release its chunks' order turns and slot pins, and
        its drain-time window slot, exactly once. Idempotent."""
        entries, state["fused"] = state["fused"], None
        self._drain_window_done(state)
        for e in entries or ():
            self._fw_pipeline.abandon(e["pend"])

    def _drain_window_done(self, state: dict) -> None:
        if state.pop("window_at_drain", False):
            with self._drain_window_lock:
                self._drain_window_batches -= 1

    def pipeline_finish(self, state: dict, now: float):
        """Drain stage, in admission order: the refused rows' replay, then
        each committed chunk's event pull and replay (its staleness cut was
        taken at submit), then the classic pend's rows, re-checked for
        staleness at `now` (a line that aged out in the pipeline is marked
        old_line and counted) before their windows apply. Returns
        (results, lines dropped as stale). A single-program chunk that
        fails raises: the scheduler counts the batch as failed and aborts
        what is left. Two-program chunks are re-cut for staleness at `now`
        and committed here (`_finish_two_program`); one that fails loses
        its own lines (marked error) and counts a breaker failure.

        After a failed device stage (`pipeline_recover`) the same steps
        finish the batch: the refused rows' host steps if submit did not
        reach them, and the classic rows' match if it was not collected."""
        t0 = time.perf_counter()
        results = state["results"]
        n_stale = 0
        try:
            if state["refused_rows"] is not None:
                with self.clock("refused"):
                    state["refused"] = self._refused_events(*state["refused_rows"])
                state["refused_rows"] = None
            refused, state["refused"] = state["refused"], None
            self._replay_refused(refused, results)
            if state["fused"]:
                if self._fw_pipeline.single_kernel:
                    n_stale += self._finish_single_kernel(state, results)
                else:
                    n_stale += self._finish_two_program(state, now, results)
            work = state["classic"]
            if work is not None and len(work):
                bits = state["bits"]
                if bits is None:
                    pend, state["pend"] = state["pend"], None
                    with self.clock("chunk"):
                        bits = (self._match_bits_collect(pend) if pend is not None
                                else self._match_bits(work, state["classic_pre"]))
                stale = (now - work.ts_array() / 1e9) > OLD_LINE_CUTOFF_SECONDS
                if stale.any():
                    n_stale += int(stale.sum())
                    for k in np.flatnonzero(stale).tolist():
                        r = results[work[k][0]]
                        r.old_line = True
                        r.rule_results = []
                    keep = np.flatnonzero(~stale)
                    work, bits = work.take(keep), bits[keep]
                if len(work):
                    self._apply_windows(work, bits, results)
            self._note_health()
            return results, n_stale
        except Exception:
            self.note_device_outcome(time.perf_counter() - t0, ok=False)
            raise
        finally:
            self._drain_window_done(state)
            self.stats.record_batch(len(state["lines"]), time.perf_counter() - t0)

    def _finish_single_kernel(self, state: dict, results) -> int:
        """The committed chunks' drain: a pull of the buffer each copied
        since submit, the decode and the replay; a gated chunk replays
        through the classic fallback, in chunk order."""
        fw = self._fw_pipeline
        entries = state["fused"]
        n_stale = 0
        for k, e in enumerate(entries):
            state["fused"] = entries[k:]  # what pipeline_abort settles if this raises
            stale, live = e["stale"], e["live"]
            if stale is not None:
                n_stale += int(stale.sum())
                for j in np.flatnonzero(stale).tolist():
                    r = results[e["work"][j][0]]
                    r.old_line = True
                    r.rule_results = []
            failpoints.check("matcher.resolve")
            try:
                with self.clock("chunk"):
                    fw.resolve(e["pend"])
            except PipelineOverflow as ov:
                trace.instant("fused-overflow-fallback", {"row0": e["row0"]})
                self.pipelined_fused_fallbacks += 1
                self._pipeline_fallback_entry(e, ov, results, live=live)
                continue
            # a child of the scheduler's ambient drain span
            with trace.span("effector-replay", args={"row0": e["row0"]}):
                with self.clock("chunk"):
                    res = fw.collect(e["pend"])
                self._replay_window_events(e["work"], None, (res.matched_pairs, res.always_bits),
                                           res.events, results, live_rows=live)
            self.pipelined_fused_chunks += 1
        state["fused"] = None
        return n_stale

    def _finish_two_program(self, state: dict, now: float, results) -> int:
        """The two-program chunks' drain (JAX `_finish_fused_pipeline`):
        each chunk's rows are re-cut for staleness at `now`, then program B
        commits the live rows, chunk by chunk in admission order, with
        up to drain_resolve_depth - 1 resolved chunks' event pulls and
        replays pending, so that each overlaps the next chunk's program B.
        Resolve order is B dispatch order is device apply order, and
        replays run chunk-ascending (pending replays drain before an
        overflowing chunk's classic replay), so ban-log order stays the
        synchronous path's. A fully stale chunk is abandoned without a
        program B. Returns the lines dropped as stale."""
        entries, state["fused"] = state["fused"], None
        fw = self._fw_pipeline
        depth = self._drain_resolve_depth
        pending: List[dict] = []  # resolved, replay deferred (<= depth - 1)
        n_stale = 0

        def collect_replay(e, overlapped: bool) -> None:
            t0 = time.perf_counter()
            # a child of the scheduler's ambient drain span: the event
            # pull and replay that the resolve-ahead hides behind the next
            # chunk's program B
            with trace.span("effector-replay",
                            args={"row0": e["row0"], "overlapped": overlapped}):
                try:
                    with self.clock("chunk"):
                        res = fw.collect(e["pend"])
                    self._replay_window_events(
                        e["work"], None, (res.matched_pairs, res.always_bits), res.events,
                        results, live_rows=e["live"],
                    )
                    self.pipelined_fused_chunks += 1
                except Exception:  # noqa: BLE001 — collect settled its pins and turns
                    log.exception("two-program event collect failed; chunk lines marked error")
                    self._mark_chunk_error(e, e["chunk_stale"], results)
                    self.note_device_outcome(0.0, ok=False)
            if overlapped:
                ms = (time.perf_counter() - t0) * 1e3
                prev = self.drain_resolve_overlap_ms_ewma
                self.drain_resolve_overlap_ms_ewma = ms if prev is None else prev + 0.3 * (ms - prev)

        def drain_pending() -> None:
            while pending:
                collect_replay(pending.pop(0), overlapped=False)

        for e in entries:
            pend = e["pend"]
            work = e["work"]
            stale = (now - work.ts_array() / 1e9) > OLD_LINE_CUTOFF_SECONDS
            e["chunk_stale"] = stale
            live = None
            if stale.any():
                n_stale += int(stale.sum())
                for k in np.flatnonzero(stale).tolist():
                    r = results[work[k][0]]
                    r.old_line = True
                    r.rule_results = []
                if stale.all():
                    # nothing to commit: settle the chunk without program B
                    fw.abandon(pend)
                    continue
                live = ~stale
            e["live"] = live
            try:
                failpoints.check("matcher.resolve")
                with trace.span("program-b", args={"row0": e["row0"],
                                                   "masked": live is not None}):
                    with self.clock("chunk"):
                        fw.resolve(pend, live=live)
            except PipelineOverflow as ov:
                # earlier chunks' effects fire before this chunk's replay
                drain_pending()
                trace.instant("fused-overflow-fallback", {"row0": e["row0"]})
                self.pipelined_fused_fallbacks += 1
                try:
                    self._pipeline_fallback_entry(e, ov, results, live=live)
                except Exception:  # noqa: BLE001 — one chunk's loss, not the stream's
                    log.exception("two-program overflow fallback failed; chunk lines "
                                  "marked error")
                    self._mark_chunk_error(e, stale, results)
                    self.note_device_outcome(0.0, ok=False)
                continue
            except Exception:  # noqa: BLE001 — resolve settles its own failures
                # a fault before resolve (the matcher.resolve failpoint)
                # leaves the chunk submitted: settle its turns and pins
                if pend.state == "submitted":
                    fw.abandon(pend)
                drain_pending()
                log.exception("two-program window commit failed; chunk lines marked error")
                self._mark_chunk_error(e, stale, results)
                self.note_device_outcome(0.0, ok=False)
                continue
            pending.append(e)
            while len(pending) > depth - 1:
                head = pending.pop(0)
                collect_replay(head, overlapped=bool(pending))
        drain_pending()
        return n_stale

    @staticmethod
    def _mark_chunk_error(e: dict, chunk_stale: np.ndarray, results) -> None:
        """A chunk whose commit failed loses its live lines (marked error)."""
        for k in np.flatnonzero(~chunk_stale).tolist():
            results[e["work"][k][0]].error = True

    # ---- the fused path ----

    def _consume_via_pipeline(self, work, cls_ids, lens, results) -> None:
        """Chunks through the fused program, up to two in flight: chunk N's
        buffer is pulled while chunk N+1 runs. An overflowing chunk drains
        every earlier chunk first, then replays classically before any
        later chunk is collected, so window updates keep log order."""
        failpoints.check("matcher.device")
        fw = self._fw_pipeline
        chunks = [
            (work[s : s + self._max_batch],
             cls_ids[s : s + self._max_batch],
             lens[s : s + self._max_batch])
            for s in range(0, max(1, len(work)), self._max_batch)
        ]
        q: List[dict] = []  # in-flight entries, oldest first

        def collect_replay(e):
            with self.clock("chunk"):
                res = fw.collect(e["pend"])
            self._replay_window_events(
                e["work"], None, (res.matched_pairs, res.always_bits), res.events, results
            )

        def resolve_entry(e) -> bool:
            """Resolve e; on overflow drain every earlier chunk, then replay
            e classically. False when the fallback consumed e."""
            try:
                with self.clock("chunk"):
                    fw.resolve(e["pend"])
                return True
            except PipelineOverflow as ov:
                drained = False
                try:
                    while q and q[0] is not e:
                        collect_replay(q.pop(0))
                    drained = True
                finally:
                    if not drained:
                        self.device_windows.release_pins(e["slots"])
                        fw.fallback_done(e["pend"])
                        if q and q[0] is e:
                            q.pop(0)
                if q and q[0] is e:
                    q.pop(0)
                self._pipeline_fallback_entry(e, ov, results)
                return False

        def drain_all():
            while q:
                if q[-1]["pend"].state == "submitted":
                    if not resolve_entry(q[-1]):
                        continue
                head = q.pop(0)
                if head["pend"].state in ("failed", "done"):
                    continue
                collect_replay(head)

        try:
            for wc, cc, lc in chunks:
                entry = self._submit_pipeline_chunk(wc, cc, lc)
                if entry is None:
                    # slot allocation refused: drain in-flight pins, then
                    # run this chunk through the splitting sync path
                    drain_all()
                    self._pipeline_chunk_sync(wc, cc, lc, results)
                    continue
                q.append(entry)
                if len(q) >= 2 and q[-2]["pend"].state == "submitted":
                    resolve_entry(q[-2])
                if len(q) >= 3:
                    collect_replay(q.pop(0))
            drain_all()
        except Exception:
            try:
                drain_all()
            except Exception:  # noqa: BLE001 — the first error is the one raised
                log.exception("pipeline drain after failure also failed")
            raise

    def _slots_for_work(self, work) -> Optional[np.ndarray]:
        """A pinned slot per row (one decision per distinct IP), or None
        when the allocation refuses; the sketch's slot -> hash table is
        refreshed for the batch's assignments."""
        with self.clock("slots"):
            uips, uinv = work.unique_ips()
            uslots = self.device_windows.slots_for_unique_ips(uips)
            if uslots is None:
                return None
            if self.traffic_sketch is not None:
                try:
                    with self.clock("sketch"):
                        self.traffic_sketch.note_assignments(uips, uslots)
                except BaseException:
                    self.device_windows.release_pins(uslots)
                    raise
            return uslots[uinv]

    def _submit_pipeline_chunk(self, work, cls_ids, lens, live=None):
        """Allocate slots and run the chunk's program (`live`: its commit
        mask); None when slot allocation refuses. Pins pass to the
        pipeline's submit, which releases them itself if it fails."""
        slots = self._slots_for_work(work)
        if slots is None:
            return None
        try:
            ts_s, ts_ns = split_ns(work.ts_array())
            host_idx = work.host_idx(self._host_row)
        except Exception:
            self.device_windows.release_pins(slots)
            raise
        with self.clock("chunk"):
            pend = self._fw_pipeline.submit(cls_ids, lens, slots, ts_s, ts_ns, host_idx,
                                            live=live)
        return {"work": work, "cls": cls_ids, "lens": lens, "slots": slots,
                "ts_s": ts_s, "ts_ns": ts_ns, "host_idx": host_idx, "pend": pend}

    def _pipeline_chunk_sync(self, work, cls_ids, lens, results) -> None:
        """A chunk whose slot allocation refused with nothing in flight:
        halve until allocations fit, each piece submit -> collect."""

        def make(cls_c, lens_c):
            def apply_fn(work_c, slots, ts_s, ts_ns, host_idx, results_c):
                with self.clock("chunk"):
                    pend = self._fw_pipeline.submit(cls_c, lens_c, slots, ts_s, ts_ns, host_idx)
                e = {"work": work_c, "cls": cls_c, "lens": lens_c, "slots": slots,
                     "ts_s": ts_s, "ts_ns": ts_ns, "host_idx": host_idx, "pend": pend}
                try:
                    with self.clock("chunk"):
                        res = self._fw_pipeline.collect(pend)
                except PipelineOverflow as ov:
                    self._pipeline_fallback_entry(e, ov, results_c)
                    return
                self._replay_window_events(
                    work_c, None, (res.matched_pairs, res.always_bits), res.events, results_c
                )

            def split(lo, hi):
                return make(cls_c[lo:hi], lens_c[lo:hi])

            return split, apply_fn

        self._with_window_slots(work, *make(cls_ids, lens), results)

    def _pipeline_fallback_entry(self, e, ov, results, live=None) -> None:
        """Classic replay of one gated chunk (every earlier chunk applied).
        `live` (bool [n] or None) masks rows the staleness cut dropped out
        of both the window apply and the replay."""
        with self.clock("chunk"):
            replay = self._pipeline_fallback_apply(e, ov, live)
        self._replay_window_events(e["work"], *replay, results, live_rows=live)

    def _pipeline_fallback_apply(self, e, ov, live=None):
        """The fallback's match and window apply -> (bits, sparse, events)
        for the replay."""
        dw = self.device_windows
        pend = e["pend"]
        n = len(e["work"])
        try:
            if ov.candidate_overflow:
                # stage 2 never saw the excess lines: full single-stage match
                bits = self._single_stage_bits(n, e["cls"], e["lens"], np.arange(n))
                if live is not None:
                    bits = bits * live[:, None].astype(np.uint8)
                apply_bits = bits
            else:
                # the dense bitmap is complete: apply it from the device
                apply_bits = pend.bits_dev[:n]
                if live is not None:
                    apply_bits = apply_bits * torch.from_numpy(
                        live.astype(np.uint8)).to(apply_bits.device)[:, None]
                bits = None
        except Exception:
            dw.release_pins(e["slots"])
            self._fw_pipeline.fallback_done(pend)
            raise
        try:
            events = dw.apply_bitmap(  # releases the pins itself
                apply_bits, e["slots"], e["ts_s"], e["ts_ns"],
                self._active_table, e["host_idx"],
            )
        finally:
            self._fw_pipeline.fallback_done(pend)
        if bits is None and pend.matched_pairs is not None:
            return None, (pend.matched_pairs, pend.always_bits), events
        if bits is None:
            bits = pend.bits_dev[:n].cpu().numpy()
            if live is not None:
                bits = bits * live[:, None].astype(np.uint8)
        return bits, None, events

    # ---- replay ----

    def _sparse_row_sets(self, n, sparse) -> Dict[int, set]:
        """Per-row matched rule-id sets from the (row, rule) pairs and the
        packed always-rule bits."""
        matched_pairs, always_bits = sparse
        plan = self._prefilter.plan
        row_ids: Dict[int, set] = {}
        if matched_pairs is not None and len(matched_pairs):
            R8 = self._prefilter._nf8 * 8
            rows_idx, cols = matched_pairs // R8, matched_pairs % R8
            ok = cols < plan.stage2.n_rules
            for row, rid in zip(rows_idx[ok], plan.f_idx[cols[ok]]):
                row_ids.setdefault(int(row), set()).add(int(rid))
        if always_bits is not None and plan.n_always:
            ab = np.unpackbits(always_bits[:n], axis=1, count=plan.n_always)
            for row, col in zip(*np.nonzero(ab)):
                row_ids.setdefault(int(row), set()).add(int(plan.a_idx[col]))
        return row_ids

    def _replay_window_events(self, work, bits, sparse, events, results,
                              live_rows=None) -> None:
        """Window events + match bookkeeping into ConsumeLineResults
        (per-site-then-global rule order, Banner per exceeded event).
        `live_rows` (bool [n]) skips rows the staleness cut dropped."""
        with self.clock("replay"):
            self._replay_body(work, bits, sparse, events, results, live_rows)

    def _replay_body(self, work, bits, sparse, events, results, live_rows) -> None:
        if self.traffic_sketch is not None and events:
            # per-rule pressure, where every path's fired events land
            with self.clock("sketch"):
                self.traffic_sketch.note_rule_events(e.rule_id for e in events)
        evmap = {(e.line, e.rule_id): e for e in events}
        if sparse is not None:
            row_ids = self._sparse_row_sets(len(work), sparse)
            row_iter = sorted(row_ids)
        else:
            row_any = bits.any(axis=1)
            row_iter = [r for r in range(len(work)) if row_any[r]]
        if live_rows is not None:
            row_iter = [r for r in row_iter if live_rows[r]]
        for row in row_iter:
            i, p = work[row]
            pos = self._rule_pos(p.host)
            ids = row_ids[row] if sparse is not None else np.nonzero(bits[row])[0].tolist()
            matched = sorted((x for x in ids if x in pos), key=pos.__getitem__)
            try:
                for idx in matched:
                    _, rule = self._entries[idx]
                    result = RuleResult(rule_name=rule.rule, regex_match=True)
                    if rule.hosts_to_skip.get(p.host):
                        result.skip_host = True
                        results[i].rule_results.append(result)
                        continue
                    e = evmap[(row, idx)]
                    result.seen_ip = e.seen_ip
                    result.rate_limit_result = RateLimitResult(
                        match_type=e.match_type, exceeded=e.exceeded
                    )
                    if e.exceeded:
                        self.banner.ban_or_challenge_ip(self.config, p.ip, rule.decision, p.host)
                        self.banner.log_regex_ban(
                            self.config, p.timestamp_ns / 1e9, p.ip, rule.rule,
                            p.rest, rule.decision,
                        )
                        # the fixed window fires on the hit after the
                        # threshold; the ambient drain span gives the trace id
                        provenance.record(
                            provenance.SOURCE_RATE_LIMIT, p.ip, rule.decision,
                            rule=rule.rule, rule_index=idx,
                            hits=rule.hits_per_interval + 1,
                        )
                    results[i].rule_results.append(result)
            except Exception:  # noqa: BLE001 — a failing effector loses one line, not the batch
                log.exception("error applying rules to log line")
                results[i].error = True

    # ---- the classic bitmap path ----

    def _with_window_slots(self, work, split, apply_fn, results) -> None:
        """Slot allocation with recursive split when it refuses; apply_fn
        owns the pins from the moment it is entered."""
        dw = self.device_windows
        slots = self._slots_for_work(work)
        if slots is None:
            if len(work) <= 1:
                log.error(
                    "device-windows slot allocation failed for a single line "
                    "(capacity=%d, all slots pinned); dropping line", dw.capacity,
                )
                for i, _ in work:
                    results[i].error = True
                return
            mid = max(1, len(work) // 2)
            self._with_window_slots(work[:mid], *split(0, mid), results)
            self._with_window_slots(work[mid:], *split(mid, len(work)), results)
            return
        handed_off = False
        try:
            ts_s, ts_ns = split_ns(work.ts_array())
            host_idx = work.host_idx(self._host_row)
            handed_off = True
            apply_fn(work, slots, ts_s, ts_ns, host_idx, results)
        except Exception:
            if not handed_off:
                dw.release_pins(slots)
            raise

    def _apply_windows(self, work, bits, results) -> None:
        """The classic path's window step: on the device, or the host
        states' when device windows are off."""
        if self.device_windows is not None:
            self._apply_device_windows(work, bits, results)
        else:
            self._apply_host_windows(work, bits, results)

    def _apply_host_windows(self, work, bits, results) -> None:
        """The host window pass in line order (JAX `_apply_host_windows`):
        the host's per-site rules first, then the global rules
        (regex_rate_limiter.go:175-211). Only matched lines are visited,
        and in them only their matched rule ids."""
        with self.clock("host-windows"):
            for row in np.flatnonzero(bits.any(axis=1)).tolist():
                i, p = work[row]
                pos = self._rule_pos(p.host)
                ids = np.nonzero(bits[row])[0].tolist()
                try:
                    for idx in sorted((x for x in ids if x in pos), key=pos.__getitem__):
                        results[i].rule_results.append(apply_matched_rule(
                            self.config, self.banner, self.rate_limit_states,
                            self._entries[idx][1], p.ip, p.host, p.rest, p.timestamp_ns))
                except Exception:  # noqa: BLE001 — a failing effector loses one line, not the batch
                    log.exception("error applying rules to log line")
                    results[i].error = True

    def _apply_device_windows(self, work, bits, results) -> None:
        def make(bits_c):
            def apply_fn(work_c, slots, ts_s, ts_ns, host_idx, results_c):
                if self.traffic_sketch is not None:
                    # the fused path folds at its submit instead
                    try:
                        with self.clock("sketch"):
                            self.traffic_sketch.update(slots, len(work_c))
                    except BaseException:
                        self.device_windows.release_pins(slots)
                        raise
                with self.clock("chunk"):
                    events = self.device_windows.apply_bitmap(
                        bits_c, slots, ts_s, ts_ns, self._active_table, host_idx
                    )
                self._replay_window_events(work_c, bits_c, None, events, results_c)

            def split(lo, hi):
                return make(bits_c[lo:hi])

            return split, apply_fn

        self._with_window_slots(work, *make(bits), results)

    def _match_bits(self, work, encoded) -> np.ndarray:
        """[N, n_rules] uint8 exact match bitmap: the prefilter (or the
        single-stage match when it is off or overflows) for device rows,
        host `re` for host_eval rows and unlowerable rules. `encoded` is
        (cls_ids, lens, host_eval), or None to encode here."""
        return self._match_bits_collect(self._match_bits_submit(work, encoded))

    def _match_bits_submit(self, work, encoded) -> dict:
        """Dispatch the match of a work batch without waiting for the card;
        `_match_bits_collect` completes it (the pipeline's classic pend
        submits on its device stage and collects later)."""
        failpoints.check("matcher.device")
        n = len(work)
        if encoded is None:
            encoded = encode_for_match(self.compiled, [p.rest for _, p in work], self._max_len)
        cls_ids, lens, host_eval = encoded
        device_rows = np.flatnonzero(~host_eval)
        pend = {"n": n, "work": work, "cls": cls_ids, "lens": lens, "host_eval": host_eval,
                "device_rows": device_rows, "kind": "single", "chunks": None}
        if self._mesh_matcher is not None:
            # one sharded submit per chunk of device rows, none waiting
            # for the card: collect merges each back into line order
            pend["kind"] = "mesh"
            pend["chunks"] = [
                (rows, self._mesh_matcher.submit(cls_ids[rows], lens[rows]))
                for rows in (device_rows[s : s + self._max_batch]
                             for s in range(0, len(device_rows), self._max_batch))
            ]
        elif self._prefilter is not None:
            dev_lens = np.where(host_eval, 0, lens)
            pend["kind"] = "prefilter"
            pend["chunks"] = [
                (sl, self._prefilter.submit(cls_ids[sl], dev_lens[sl]))
                for sl in (slice(s, min(n, s + self._max_batch))
                           for s in range(0, n, self._max_batch))
            ]
        return pend

    def _match_bits_collect(self, pend: dict) -> np.ndarray:
        n, work = pend["n"], pend["work"]
        cls_ids, lens, host_eval = pend["cls"], pend["lens"], pend["host_eval"]
        device_rows = pend["device_rows"]
        if pend["kind"] == "mesh":
            bits = np.zeros((n, self.compiled.n_rules), dtype=np.uint8)
            for rows, p in pend["chunks"]:
                bits[rows] = self._mesh_matcher.collect(p)
        elif pend["kind"] == "prefilter":
            try:
                bits = np.zeros((n, self.compiled.n_rules), dtype=np.uint8)
                for sl, p in pend["chunks"]:
                    bits[sl] = self._prefilter.collect(p)
                # a zero-length row contributes no device bits
                bits[host_eval] = 0
            except PrefilterOverflow as e:
                log.info("prefilter overflow (%s); batch reruns single-stage", e)
                bits = self._single_stage_bits(n, cls_ids, lens, device_rows)
        else:
            bits = self._single_stage_bits(n, cls_ids, lens, device_rows)
        for row in np.flatnonzero(host_eval):
            rest = work[int(row)][1].rest
            for idx, (_, rule) in enumerate(self._entries):
                if rule.regex.search(rest) is not None:
                    bits[row, idx] = 1
        for idx in self._host_rule_idx:
            rule = self._entries[idx][1]
            for row in device_rows:
                if rule.regex.search(work[int(row)][1].rest) is not None:
                    bits[row, idx] = 1
        return bits

    def _single_stage_bits(self, n, cls_ids, lens, device_rows) -> np.ndarray:
        """Full-NFA match bitmap of the device rows (kernel A), per chunk."""
        bits = np.zeros((n, self.compiled.n_rules), dtype=np.uint8)
        for start in range(0, len(device_rows), self._max_batch):
            rows = device_rows[start : start + self._max_batch]
            lens_c = np.asarray(lens[rows], dtype=np.int32)
            L_p = max(1, min(cls_ids.shape[1], -(-max(1, int(lens_c.max())) // 32) * 32))
            cls_c = np.ascontiguousarray(cls_ids[rows, :L_p], dtype=np.int32)
            out = nfa_match.match_bits(
                self._nfa, torch.from_numpy(cls_c).to(self.device),
                torch.from_numpy(lens_c).to(self.device),
            )
            bits[rows] = out.cpu().numpy()
        return bits

    def _rule_pos(self, host: str) -> Dict[int, int]:
        """{rule id -> position in the host's per-site-then-global order};
        hosts without per-site rules share the global dict (the host field
        is attacker-controlled, so it is not cached per unknown host)."""
        if host not in self._per_site_idx:
            return self._global_pos
        d = self._rule_pos_cache.get(host)
        if d is None:
            d = {int(x): k for k, x in enumerate(self._per_site_idx[host] + self._global_idx)}
            self._rule_pos_cache[host] = d
        return d
