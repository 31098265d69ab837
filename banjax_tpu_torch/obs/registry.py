"""The exposition-schema registry (a copy of `banjax_tpu/obs/registry.py`,
cut to the families the port emits).

Every key the 29-second metrics line can emit and every Prometheus family
`/metrics` can expose is declared here, with name, type, help and label
names equal to the JAX registry's entry (tests/test_torch_obs.py holds
each one against it), so that a dashboard built on the JAX package reads
the port unchanged. Two namespaces share one declaration:

  * `line_key`: the CamelCase key on the 29 s JSON line
    (`obs/metrics.py`). The reference's five keys keep their exact bytes
    (REFERENCE_LINE_KEYS).
  * `prom`: the `banjax_*` family `/metrics` exposes
    (`obs/exposition.py`). Interval-window keys are line-only.

Not declared: the keys whose meaning in the port would differ
from the JAX key's: `MatcherCpuFallbackBatches` (an open breaker refuses,
it never reroutes to the host), `MatcherBudgetTrips` (a budget breach is
counted but is no breaker failure), the transfer-byte keys
(`MatcherH2dBytes*`, `MatcherD2hBytes*`, `SingleKernelD2hBytesPerBatch`:
the port does not count its copies) and `SketchAdmissionFpRate`.

Histograms (fixed buckets, cumulative) live here too, so the recorders
(`obs/stats.py`, `challenge/stats.py`) and the renderer agree on the
bucket bounds.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
from typing import Dict, List, Tuple

# counter: monotone total; gauge: point-in-time value; histogram:
# fixed-bucket cumulative distribution (prom-only)
COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# the reference's exact five keys (config.go:158-181)
REFERENCE_LINE_KEYS = (
    "Time",
    "LenExpiringChallenges",
    "LenExpiringBlocks",
    "LenIpToRegexStates",
    "LenFailedChallengeStates",
)

# fixed latency buckets (seconds) shared by every duration histogram
LATENCY_BUCKETS_S = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


# fixed size buckets (bytes) for wire-frame histograms: a single small
# control frame through a maximally coalesced fabric_frame_max_bytes blob
FRAME_BYTES_BUCKETS = (
    256.0, 1024.0, 4096.0, 16384.0, 65536.0,
    262144.0, 1048576.0, 4194304.0,
)


@dataclasses.dataclass(frozen=True)
class Family:
    """One declared metric family; `line_key` or `prom` may be empty (a
    family can live on one surface only)."""

    kind: str
    help: str
    line_key: str = ""
    prom: str = ""
    labels: Tuple[str, ...] = ()


FAMILIES: List[Family] = [
    Family(GAUGE, "metrics line timestamp (reference format)",
           line_key="Time"),
    Family(GAUGE, "expiring challenge decisions held",
           line_key="LenExpiringChallenges",
           prom="banjax_expiring_challenges"),
    Family(GAUGE, "expiring block decisions held",
           line_key="LenExpiringBlocks",
           prom="banjax_expiring_blocks"),
    Family(GAUGE, "per-IP regex rate-limit states held",
           line_key="LenIpToRegexStates",
           prom="banjax_ip_to_regex_states"),
    Family(GAUGE, "failed-challenge rate-limit states held",
           line_key="LenFailedChallengeStates",
           prom="banjax_failed_challenge_states"),
    Family(COUNTER, "log lines consumed by the matcher",
           line_key="MatcherLinesTotal",
           prom="banjax_matcher_lines_total"),
    Family(COUNTER, "matcher batches consumed",
           line_key="MatcherBatchesTotal",
           prom="banjax_matcher_batches_total"),
    Family(GAUGE, "lines/sec over the last reporting interval (line-only; "
           "Prometheus rates banjax_matcher_lines_total instead)",
           line_key="MatcherLinesPerSec"),
    Family(GAUGE, "p50 batch latency (ms) over the recent-latency ring",
           line_key="MatcherBatchLatencyP50Ms"),
    Family(GAUGE, "p99 batch latency (ms) over the recent-latency ring",
           line_key="MatcherBatchLatencyP99Ms"),
    Family(GAUGE, "device window slots occupied",
           line_key="DeviceWindowsOccupancy",
           prom="banjax_device_windows_occupancy"),
    Family(GAUGE, "device window slot capacity",
           line_key="DeviceWindowsCapacity",
           prom="banjax_device_windows_capacity"),
    Family(COUNTER, "device window LRU evictions (spill to host shadow)",
           line_key="DeviceWindowsEvictions",
           prom="banjax_device_windows_evictions_total"),
    Family(GAUGE, "evictions in this reporting interval (line-only delta)",
           line_key="DeviceWindowsEvictionsPerInterval"),
    Family(COUNTER, "device window capacity grows",
           line_key="DeviceWindowsGrows",
           prom="banjax_device_windows_grows_total"),
    Family(GAUGE, "1 when the native C slot manager is live, 0 on the Python dict"
           " path",
           line_key="SlotMgrNative",
           prom="banjax_slotmgr_native"),
    Family(GAUGE, "IPs with live window counters (evicted/spilled included)",
           line_key="DeviceWindowsShadowedIps",
           prom="banjax_device_windows_shadowed_ips"),
    Family(COUNTER, "rows refused a device window slot by the sketch admission gate"
           " (matched and rate-limited statelessly on the host path — "
           "counted, never dropped)",
           line_key="SlotRefusals",
           prom="banjax_slot_refusals_total"),
    Family(COUNTER, "unseen IPs admitted to a slot because the count-min estimate "
           "reached the admission threshold",
           line_key="SketchAdmissions",
           prom="banjax_sketch_admissions_total"),
    Family(COUNTER, "evicted slot window vectors spilled into the warm tier "
           "(native/shmstate.c)",
           line_key="WarmTierSpills",
           prom="banjax_warm_tier_spills_total"),
    Family(COUNTER, "warm-tier entries refilled into a device slot on re-admission",
           line_key="WarmTierRefills",
           prom="banjax_warm_tier_refills_total"),
    Family(COUNTER, "spills the warm tier refused (full of unexpired entries; state"
           " falls back losslessly to the host shadow — the raise-"
           "warm_tier_capacity signal)",
           line_key="WarmTierDropped",
           prom="banjax_warm_tier_dropped_total"),
    Family(GAUGE, "warm-tier entries occupied",
           line_key="WarmTierOccupancy",
           prom="banjax_warm_tier_occupancy"),
    Family(GAUGE, "warm-tier entry capacity",
           line_key="WarmTierCapacity",
           prom="banjax_warm_tier_capacity"),
    # ---- mesh ----
    Family(COUNTER, "sharded-mesh batches served by the fused two-stage path",
           line_key="MeshFusedBatches", prom="banjax_mesh_fused_batches_total"),
    Family(COUNTER, "sharded-mesh batches that fell back single-stage",
           line_key="MeshFallbackBatches",
           prom="banjax_mesh_fallback_batches_total"),
    Family(GAUGE, "EWMA mesh submit wall time (ms)",
           line_key="MeshSubmitMsEwma", prom="banjax_mesh_submit_ms_ewma"),
    Family(GAUGE, "EWMA mesh d2h merge wall time (ms)",
           line_key="MeshMergeMsEwma", prom="banjax_mesh_merge_ms_ewma"),
    Family(GAUGE, "slowest shard's d2h pull in the last merge (ms)",
           line_key="MeshShardMergeMsMax",
           prom="banjax_mesh_shard_merge_ms_max"),
    Family(GAUGE, "1 when the two-stage literal prefilter is active",
           line_key="PrefilterActive",
           prom="banjax_prefilter_active"),
    Family(COUNTER, "sync-path fused matcher+windows batches",
           line_key="PipelineFusedBatches",
           prom="banjax_fused_batches_total"),
    Family(COUNTER, "fallback batches (fused overflow / pipeline generic drain)",
           line_key="PipelineFallbackBatches",
           prom="banjax_fused_fallback_batches_total"),
    Family(COUNTER, "two-phase fused chunks committed via the pipeline",
           line_key="PipelinedFusedChunks",
           prom="banjax_pipelined_fused_chunks_total"),
    Family(COUNTER, "two-phase chunks replayed classically (overflow)",
           line_key="PipelinedFusedFallbacks",
           prom="banjax_pipelined_fused_fallbacks_total"),
    Family(GAUGE, "configured fused-drain resolve-ahead depth",
           line_key="DrainResolveAheadDepth",
           prom="banjax_drain_resolve_ahead_depth"),
    Family(GAUGE, "EWMA event-decode+replay ms hidden behind the next chunk's "
           "window program",
           line_key="DrainResolveOverlapMs",
           prom="banjax_drain_resolve_overlap_ms"),
    Family(COUNTER, "chunks committed by the single-kernel fused match+window "
           "program (one dispatch, one pull)",
           line_key="SingleKernelChunks",
           prom="banjax_single_kernel_chunks_total"),
    Family(COUNTER, "single-kernel chunks routed to the classic replay (in-kernel "
           "overflow or chain gate)",
           line_key="SingleKernelFallbacks",
           prom="banjax_single_kernel_fallbacks_total"),
    Family(GAUGE, "1 when drain_resolve_depth > 1 is configured but the single-"
           "kernel path makes it a no-op (no program-B dispatch left to "
           "overlap)",
           line_key="SingleKernelDepthIgnored",
           prom="banjax_single_kernel_depth_ignored"),
    Family(GAUGE, "circuit breaker state (one-hot by state label)",
           line_key="MatcherBreakerState",
           prom="banjax_matcher_breaker_state",
           labels=("state",)),
    Family(COUNTER, "circuit breaker trips",
           line_key="MatcherBreakerTrips",
           prom="banjax_matcher_breaker_trips_total"),
    Family(COUNTER, "decision insertions recorded by the provenance ledger "
           "(obs/provenance.py; /decisions/explain)",
           prom="banjax_decision_inserts_total",
           labels=("source", "decision")),
    Family(GAUGE, "SLO error-budget burn rate over the labeled window (1.0 = "
           "consuming the budget exactly at the sustainable rate)",
           prom="banjax_slo_burn_rate",
           labels=("slo", "window")),
    Family(GAUGE, "1 when the SLO burns >= 1.0 on every evaluated window (one-hot"
           " by slo label)",
           prom="banjax_slo_breached",
           labels=("slo",)),
    Family(COUNTER, "incident bundles captured by the flight recorder "
           "(obs/flightrec.py; /debug/incidents)",
           prom="banjax_flightrec_incidents_total"),
    Family(COUNTER, "scenario-harness runs completed in this process "
           "(bench --scenarios / the chaos soak)",
           prom="banjax_scenario_runs_total"),
    Family(COUNTER, "chaos failpoint episodes injected across scenario "
           "runs", prom="banjax_scenario_injected_episodes_total"),
    Family(COUNTER, "scenario invariant failures (accounting, leaked "
           "turns/pins, benign-SLO, bundle-per-episode)",
           prom="banjax_scenario_invariant_failures_total"),
    Family(GAUGE, "last run's end-to-end lines/sec for the labeled "
           "attack shape", prom="banjax_scenario_lines_per_sec",
           labels=("scenario",)),
    Family(GAUGE, "last run's (shed + drain-error) per admitted line "
           "for the labeled shape", prom="banjax_scenario_shed_ratio",
           labels=("scenario",)),
    Family(GAUGE, "last run's ban precision vs the generator oracle",
           prom="banjax_scenario_ban_precision", labels=("scenario",)),
    Family(GAUGE, "last run's ban recall vs the generator oracle",
           prom="banjax_scenario_ban_recall", labels=("scenario",)),
    Family(GAUGE, "last run's peak SLO burn rate across all SLOs and "
           "windows", prom="banjax_scenario_slo_burn_peak",
           labels=("scenario",)),
    Family(COUNTER, "log lines folded into the device traffic sketch (count-min + "
           "HLL + rule pressure)",
           line_key="TrafficSketchLines",
           prom="banjax_traffic_sketch_lines_total"),
    Family(GAUGE, "estimated distinct client IPs (HyperLogLog registers, as of "
           "the last sketch pull)",
           line_key="TrafficDistinctIpsEst",
           prom="banjax_traffic_distinct_ips_estimate"),
    Family(GAUGE, "top heavy hitter's estimated share of sketched lines (count-"
           "min point estimate / lines folded)",
           line_key="TrafficHeavyHitterShare",
           prom="banjax_traffic_heavy_hitter_share"),
    Family(COUNTER, "bytes pulled device->host by periodic sketch refreshes "
           "(compact pulls, never per batch)",
           line_key="TrafficSketchPullBytes",
           prom="banjax_traffic_sketch_pull_bytes_total"),
    Family(GAUGE, "age of the newest sketch pull (s)",
           line_key="TrafficSketchPullAgeSeconds",
           prom="banjax_traffic_sketch_pull_age_seconds"),
    Family(COUNTER, "fired (line, rule) window events folded into the sketch, per "
           "rule — which rules absorb the flood",
           prom="banjax_traffic_rule_pressure",
           labels=("rule",)),
    # ---- multi-host decision fabric (fabric/) ----
    Family(GAUGE, "1 when the labeled fabric peer is alive in this "
           "node's membership view, 0 after it is declared dead",
           prom="banjax_fabric_peer_up", labels=("peer",)),
    Family(COUNTER, "lines forwarded to an owning peer and acked",
           line_key="FabricForwardedLines",
           prom="banjax_fabric_forwarded_lines_total"),
    Family(COUNTER, "lines received over the wire from a fabric peer",
           line_key="FabricReceivedLines",
           prom="banjax_fabric_received_lines_total"),
    Family(COUNTER, "lines owned locally and submitted in-process",
           line_key="FabricLocalLines",
           prom="banjax_fabric_local_lines_total"),
    Family(COUNTER, "lines with no alive owner — counted shed, never "
           "silently lost (the fabric half of admitted == processed + "
           "shed)", line_key="FabricShedLines",
           prom="banjax_fabric_shed_lines_total"),
    Family(COUNTER, "journal lines replayed to takeover successors "
           "after a peer death",
           line_key="FabricReplayedLines",
           prom="banjax_fabric_replayed_lines_total"),
    Family(COUNTER, "decisions produced to the Kafka command topic for "
           "fabric-wide replication",
           line_key="FabricReplicatedDecisions",
           prom="banjax_fabric_replicated_decisions_total"),
    Family(COUNTER, "replication produce attempts that failed (retried "
           "once, then counted and dropped — the local decision holds)",
           line_key="FabricReplicationErrors",
           prom="banjax_fabric_replication_errors_total"),
    Family(COUNTER, "replicated commands suppressed by the (origin, seq) "
           "deduper — own-origin echoes and duplicate inserts",
           line_key="FabricDuplicatesSuppressed",
           prom="banjax_fabric_duplicate_suppressed_total"),
    Family(COUNTER, "replicated peer decisions applied to the local "
           "dynamic lists",
           line_key="FabricReplicatedApplied",
           prom="banjax_fabric_replicated_applied_total"),
    Family(COUNTER, "range takeovers completed after a peer death",
           line_key="FabricTakeovers",
           prom="banjax_fabric_takeovers_total"),
    Family(HISTOGRAM, "takeover duration: peer declared dead -> journal "
           "fully replayed (s)",
           prom="banjax_fabric_takeover_duration_seconds"),
    Family(GAUGE, "gossip membership state of the labeled peer in this "
           "node's view (0=alive 1=suspect 2=dead 3=left)",
           prom="banjax_fabric_membership_state", labels=("peer",)),
    Family(COUNTER, "alive -> suspect transitions observed (direct + "
           "indirect probes all failed, or a suspicion digest arrived)",
           line_key="FabricMembershipSuspects",
           prom="banjax_fabric_membership_suspects_total"),
    Family(COUNTER, "suspicions that expired into confirmed-dead "
           "(drives mark_dead -> journal-replay takeover)",
           line_key="FabricMembershipConfirmedDead",
           prom="banjax_fabric_membership_confirmed_dead_total"),
    Family(COUNTER, "suspicions refuted by liveness evidence or an "
           "incarnation-bumped ALIVE from the suspect itself",
           line_key="FabricMembershipRefuted",
           prom="banjax_fabric_membership_refuted_total"),
    Family(COUNTER, "members joined or revived in this node's view "
           "(gossip join announce, rejoin, refute-after-dead)",
           line_key="FabricMembershipJoined",
           prom="banjax_fabric_membership_joined_total"),
    Family(COUNTER, "graceful LEFT departures observed (journal cleared "
           "without replay — the leaver drained first)",
           line_key="FabricMembershipLeft",
           prom="banjax_fabric_membership_left_total"),
    Family(COUNTER, "bytes of dedicated gossip probe traffic sent "
           "(digest piggybacks on data-path acks ride free)",
           line_key="FabricGossipBytes",
           prom="banjax_fabric_gossip_bytes_total"),
    Family(HISTOGRAM, "failure-detection latency: last liveness evidence "
           "for a member -> its death confirmed in this node's view (s)",
           prom="banjax_fabric_membership_detection_seconds"),
    # ---- fabric wire v2 transport (fabric/peer.py LinePipe) ----
    Family(COUNTER, "data-path frames sent to peers, by negotiated wire "
           "version (v2 binary / json fallback) and transport (tcp / shm)",
           prom="banjax_fabric_frames_total",
           labels=("version", "transport")),
    Family(COUNTER, "total data-path frames sent (all versions/transports "
           "— the 29s-line scalar of banjax_fabric_frames_total)",
           line_key="FabricFramesSent"),
    Family(COUNTER, "total data-path frame bytes sent to peers",
           line_key="FabricFrameBytes"),
    Family(HISTOGRAM, "size of each data-path frame sent (bytes) — how "
           "well send-side coalescing packs routed groups",
           prom="banjax_fabric_frame_bytes"),
    Family(COUNTER, "data-path acks received from peers (frames retired "
           "from the sliding window)",
           line_key="FabricAcksReceived",
           prom="banjax_fabric_acks_total"),
    Family(GAUGE, "frames currently in flight across all peer windows "
           "(bounded by fabric_inflight_frames per peer)",
           line_key="FabricInflightFrames",
           prom="banjax_fabric_inflight_frames"),
    Family(HISTOGRAM, "frame send -> ack round trip (s) through the "
           "pipelined window",
           prom="banjax_fabric_ack_rtt_seconds"),
    Family(GAUGE, "worst unread-byte fraction across this node's shm "
           "peer rings (0 when no ring transport is attached)",
           line_key="FabricRingOccupancy",
           prom="banjax_fabric_ring_occupancy"),
    Family(COUNTER, "takeover-replay lines skipped because their "
           "pre-death owner is still alive (already processed once — "
           "replaying would double-count rate-limit hits)",
           line_key="FabricReplaySkippedLines",
           prom="banjax_fabric_replay_skipped_lines_total"),
    Family(COUNTER, "lines+commands admitted into the pipeline",
           line_key="PipelineAdmittedLines",
           prom="banjax_pipeline_admitted_lines_total"),
    Family(COUNTER, "lines+commands fully drained",
           line_key="PipelineProcessedLines",
           prom="banjax_pipeline_processed_lines_total"),
    Family(COUNTER, "lines shed oldest-first under overload",
           line_key="PipelineShedLines",
           prom="banjax_pipeline_shed_lines_total"),
    Family(COUNTER, "lines lost to drain-stage failures (counted, never silent)",
           line_key="PipelineDrainErrorLines",
           prom="banjax_pipeline_drain_error_lines_total"),
    Family(COUNTER, "lines dropped stale at effector drain (10 s cutoff)",
           line_key="PipelineStaleDroppedLines",
           prom="banjax_pipeline_stale_dropped_lines_total"),
    Family(COUNTER, "pipeline batches drained",
           line_key="PipelineBatches",
           prom="banjax_pipeline_batches_total"),
    Family(COUNTER, "kafka command messages drained in admission order",
           line_key="PipelineCommandItems",
           prom="banjax_pipeline_command_items_total"),
    Family(COUNTER, "kafka command batches drained",
           line_key="PipelineCommandBatches",
           prom="banjax_pipeline_command_batches_total"),
    Family(COUNTER, "synthetic idle-probe failures",
           line_key="PipelineProbeFailures",
           prom="banjax_pipeline_probe_failures_total"),
    Family(GAUGE, "EWMA p99 of the device stage (ms) — feeds the derived breaker "
           "budget",
           line_key="PipelineDeviceP99Ms"),
    Family(GAUGE, "adaptive batch-size target (power-of-two bucket)",
           line_key="PipelineBatchTarget",
           prom="banjax_pipeline_batch_target"),
    Family(GAUGE, "command-batch take bound",
           line_key="PipelineCommandBatchTarget",
           prom="banjax_pipeline_command_batch_target"),
    Family(GAUGE, "EWMA encode-stage wall per batch (ms)",
           line_key="PipelineStageEncodeEwmaMs"),
    Family(GAUGE, "EWMA device-stage wall per batch (ms)",
           line_key="PipelineStageDeviceEwmaMs"),
    Family(GAUGE, "EWMA drain-stage wall per batch (ms)",
           line_key="PipelineStageDrainEwmaMs"),
    Family(GAUGE, "lines waiting in the admission buffer",
           line_key="PipelineBufferedLines",
           prom="banjax_pipeline_buffered_lines"),
    Family(GAUGE, "batches in flight across the stage ring",
           line_key="PipelineInflightBatches",
           prom="banjax_pipeline_inflight_batches"),
    Family(GAUGE, "configured in-flight ring size",
           line_key="PipelineRingSize",
           prom="banjax_pipeline_ring_size"),
    Family(GAUGE, "configured encode worker count (0 = single-thread)",
           line_key="EncodeWorkers",
           prom="banjax_encode_workers"),
    Family(COUNTER, "admission batches encoded via the sharded worker pool",
           line_key="EncodeShardedBatches",
           prom="banjax_encode_sharded_batches_total"),
    Family(GAUGE, "slowest encode shard's wall (ms) this interval",
           line_key="EncodeShardMsMax"),
    Family(GAUGE, "EWMA encode-pool utilization (1.0 = perfectly balanced)",
           line_key="EncodeWorkerUtilization",
           prom="banjax_encode_worker_utilization"),
    Family(GAUGE, "worst shard skew (max/mean shard wall) this interval",
           line_key="EncodeShardSkewMax",
           prom="banjax_encode_shard_skew_max"),
    Family(GAUGE, "EWMA per-worker busy fraction of fan-out wall (prom-only; per-"
           "shard-index label)",
           prom="banjax_encode_worker_busy_fraction",
           labels=("worker",)),
    Family(COUNTER, "kafka record batches skipped (undecodable codec)",
           line_key="KafkaSkippedBatches",
           prom="banjax_kafka_skipped_batches_total"),
    Family(GAUGE, "live SO_REUSEPORT http worker processes",
           line_key="HttpWorkers", prom="banjax_http_workers"),
    Family(COUNTER, "http workers respawned after a crash",
           line_key="HttpWorkerRespawns",
           prom="banjax_http_worker_respawns_total"),
    Family(COUNTER, "failed-challenge states dropped by the shm limiter",
           line_key="HttpFcDropped", prom="banjax_http_fc_dropped_total"),
    Family(GAUGE, "aggregate health (0 healthy / 1 degraded / 2 failed)",
           line_key="HealthStatus",
           prom="banjax_health_status"),
    Family(GAUGE, "per-component health (0 healthy / 1 degraded / 2 failed); "
           "Health_<name> on the line",
           prom="banjax_health_component_status",
           labels=("component",)),
    Family(COUNTER, "challenge cookies issued (stateless signed issuance, sha-inv +"
           " password)",
           line_key="ChallengeIssued",
           prom="banjax_challenge_issued_total"),
    Family(COUNTER, "sha-inv PoW cookie verifications by outcome and verifying path"
           " (cpu = reference oracle, device = batched sha256 kernel)",
           prom="banjax_challenge_verifications_total",
           labels=("result", "path")),
    Family(COUNTER, "sha-inv PoW cookie verifications, all outcomes and paths "
           "(line-only scalar of the labeled prom family)",
           line_key="ChallengeVerifications"),
    Family(GAUGE, "exact per-IP failed-challenge entries held by the bounded "
           "state (LRU + sketch spill/refill tiers excluded)",
           line_key="ChallengeFailureStateEntries",
           prom="banjax_challenge_failure_state_entries"),
    Family(COUNTER, "failed-challenge entries evicted from the bounded state under "
           "challenger pressure — bounded memory, never silent",
           line_key="ChallengeFailureEvictions",
           prom="banjax_challenge_failure_evictions_total"),
    Family(COUNTER, "/auth_request responses served from the decision-table byte "
           "templates, by decision tier",
           prom="banjax_serve_fastpath_hits_total",
           labels=("tier",)),
    Family(COUNTER, "fast-path consultations that fell through to the decision "
           "chain, by reason",
           prom="banjax_serve_fastpath_misses_total",
           labels=("reason",)),
    Family(COUNTER, "fast-path hits, all tiers (line-only scalar of the labeled "
           "prom family)",
           line_key="ServeFastpathHits"),
    Family(COUNTER, "fast-path misses, all reasons (line-only scalar of the labeled"
           " prom family)",
           line_key="ServeFastpathMisses"),
    Family(COUNTER, "fast-path lookup faults (armed failpoint, torn seqlock read "
           "budget, unexpected error) — every one fell open to the chain",
           line_key="ServeFastpathFaults",
           prom="banjax_serve_fastpath_faults_total"),
    Family(GAUGE, "live entries in the shared decision table",
           line_key="ServeTableEntries",
           prom="banjax_serve_fastpath_table_entries"),
    Family(COUNTER, "inserts refused by a full decision table (the IP stays chain-"
           "served; live decisions are never evicted)",
           line_key="ServeTableDropped",
           prom="banjax_serve_fastpath_table_dropped_total"),
    Family(GAUGE, "session-id entries mirrored as a count (cookie-bearing "
           "requests defer to the chain while nonzero)",
           prom="banjax_serve_fastpath_table_session_entries"),
    Family(COUNTER, "dynamic-list -> decision-table mirror write failures (the "
           "table degrades to misses, never authority)",
           line_key="ServeMirrorErrors",
           prom="banjax_serve_fastpath_mirror_errors_total"),
    Family(COUNTER, "coalesced netlink sendmsg batches acked clean by the kernel",
           line_key="IpsetBatchSends",
           prom="banjax_ipset_batch_sends_total"),
    Family(COUNTER, "ipset entries carried by those batches",
           line_key="IpsetBatchEntries",
           prom="banjax_ipset_batch_entries_total"),
    Family(COUNTER, "kernel-edge ban failures by path (netlink send/nack vs "
           "subprocess shim) — counted and routed, never raised into the "
           "ban path",
           prom="banjax_ipset_errors_total",
           labels=("path",)),
    Family(COUNTER, "kernel-edge ban failures, all paths (line-only scalar of the "
           "labeled prom family)",
           line_key="IpsetErrors"),
    Family(COUNTER, "entries re-routed from netlink to the per-entry subprocess "
           "fallback (lossless)",
           line_key="IpsetFallbacks",
           prom="banjax_ipset_fallback_total"),
    Family(COUNTER, "oldest queued bans shed by a full netlink queue (bounded "
           "memory, never blocks the ban path)",
           line_key="IpsetQueueShed",
           prom="banjax_ipset_queue_shed_total"),
    Family(GAUGE, "bans waiting in the netlink batch queue",
           prom="banjax_ipset_queue_depth"),
    # ---- fleet observability plane (obs/fleet.py) ----
    Family(GAUGE, "gossip-piggybacked health bits of the labeled fleet "
           "node (bit 1 slo_breached, bit 2 breaker open, bit 4 breaker "
           "half-open; 0 = healthy)",
           prom="banjax_fabric_peer_health", labels=("node",)),
    Family(GAUGE, "1 when the labeled peer could not be reached by the "
           "last /metrics?fleet=1 fan-out (its samples come from the "
           "stale cache or are absent — partial-but-honest view)",
           prom="banjax_fleet_peer_unreachable", labels=("instance",)),
    Family(GAUGE, "age (s) of the labeled peer's snapshot in the merged "
           "fleet exposition (near zero for a live pull)",
           prom="banjax_fleet_peer_staleness_seconds",
           labels=("instance",)),
    Family(HISTOGRAM, "tailer read -> effector commit end-to-end latency (s), by hop "
           "(local = owned by the tailing node, fabric = forwarded to its "
           "owner over the wire)",
           prom="banjax_e2e_latency_seconds",
           labels=("hop",)),
    Family(HISTOGRAM, "device verification batch size (candidate solutions per sha256"
           " kernel dispatch)",
           prom="banjax_challenge_verify_batch_size"),
    Family(HISTOGRAM, "end-to-end matcher batch latency (s)",
           prom="banjax_batch_latency_seconds"),
    Family(HISTOGRAM, "device stage (submit->collect) latency (s)",
           prom="banjax_device_stage_latency_seconds"),
    Family(HISTOGRAM, "per-stage pipeline span duration (s)",
           prom="banjax_stage_duration_seconds",
           labels=("stage",)),
]

# dynamic line-key prefixes (one key per registered component)
DYNAMIC_LINE_PREFIXES = ("Health_",)

LINE_KEYS: Dict[str, Family] = {f.line_key: f for f in FAMILIES if f.line_key}
PROM_FAMILIES: Dict[str, Family] = {f.prom: f for f in FAMILIES if f.prom}


def is_declared_line_key(key: str) -> bool:
    return key in LINE_KEYS or any(key.startswith(p) for p in DYNAMIC_LINE_PREFIXES)


class Histogram:
    """Thread-safe fixed-bucket histogram (Prometheus cumulative semantics
    at render time; counts stored per bucket)."""

    __slots__ = ("bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, bounds: Tuple[float, ...] = LATENCY_BUCKETS_S):
        self.bounds = tuple(bounds)
        self._counts = [0] * (len(self.bounds) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> Tuple[Tuple[float, ...], List[int], float, int]:
        """(bounds, cumulative counts incl. +Inf, sum, count)."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, running = [], 0
        for c in counts:
            running += c
            cum.append(running)
        return self.bounds, cum, s, total


class StageHistograms:
    """A labeled histogram set keyed by stage name, created lazily so only
    stages that run appear in the exposition."""

    __slots__ = ("_hists", "_lock")

    def __init__(self):
        self._hists: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def observe(self, stage: str, value_s: float) -> None:
        h = self._hists.get(stage)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(stage, Histogram())
        h.observe(value_s)

    def items(self):
        with self._lock:
            return sorted(self._hists.items())
