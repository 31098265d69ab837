"""The slice of the banjax YAML config that the port's paths read.

The port reads the same YAML file as the JAX package
(`banjax_tpu/config/schema.py`) with the same key names and the same
strict scalar typing, but keeps only the keys its two paths use: for the
regex rate-limit log path the rules, the allowlists, `disable_logging`,
the decision TTL, the `matcher_*` keys and the host tier and state
tiering keys (`matcher_native_parse`, `slotmgr_native`,
`traffic_sketch_*`, `slot_admission_*`, `warm_tier_*`); for the `/auth_request`
decision chain the decision lists, the password, session and challenge
keys and the `challenge_*` keys of the challenge plane; for the service
around both (`config_holder.py`, `cli.BanjaxApp`) the log files, the
HTTP listener keys and the serving fast path's keys; for the streaming
pipeline (`pipeline/`) and the breaker and failpoints it drives, the
`pipeline_*`, `breaker_*`, `matcher_latency_budget_ms`,
`matcher_probe_seconds`, `failpoints*`, `encode_workers` and
`drain_resolve_depth` keys; for the kernel edge (`effectors/ipset*.py`)
`iptables_ban_seconds`, `ipset_netlink_enabled` and
`iptables_unbanner_seconds` (read and used nowhere, as in JAX: the
kernel's per-entry timeouts expire bans); for the observability plane
(`obs/`) the `trace_*`, `provenance_*`, `slo_*` and `flightrec_*` keys,
`metrics_log_file` and `profile`; for the Kafka channel (`ingest/kafka_*.py`)
the `kafka_*` keys, `disable_kafka_writer`, `dnet`, `dnet_to_partition` and
the command TTLs (`block_ip_ttl_seconds`, `block_session_ttl_seconds` and
their per-site maps); for multi-process serving (`httpapi/workers.py`)
`http_workers`; for the decision fabric and fleet observability
(`fabric/`, `obs/fleet.py`) the `fabric_*` and `fleet_*` keys and
`flightrec_fleet_capture`; all with the JAX defaults and checks.

The port reads every key of the JAX schema. A key the JAX schema reads
and the port does not would be named in one warning per load and kept in
`Config.not_ported` (`_NOT_PORTED_KEYS`, empty now that every module is
ported); it is never dropped without a word. Keys neither schema knows
are ignored, as the full schema ignores them. The mesh keys
(`matcher_mesh_devices`, `matcher_mesh_rp`, `parallel/mesh.py`) load
with the JAX checks. `matcher_backend` `auto` and `pallas` select the
port's one route (the Hopper kernels on the card, their plain versions
only when the caller asks for the CPU); `xla` and `pallas-interpret`
fail the load, since they would run the plain versions on the card.
`http_workers` loads as in JAX: -1 is one worker per extra core,
and the app serves single-process, with a warning, below -1.
`load_pages` embeds the two challenge pages as `ConfigHolder` does.

`RegexWithRate.from_yaml_dict` is a copy of the schema's: RE2-dialect
check, Python `re` compile, Go's truncating `interval * 1e9`.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from pathlib import Path
from typing import Any, Dict, List

import yaml

from banjax_tpu_torch.decisions.model import Decision, parse_decision
from banjax_tpu_torch.matcher.re2check import check_re2_compatible

log = logging.getLogger(__name__)

NANOS_PER_SECOND = 1_000_000_000


@dataclasses.dataclass
class RegexWithRate:
    """One rate-limit rule. `interval_ns` mirrors Go's time.Duration so the
    fixed-window comparison `ts - start > interval` is bit-identical."""

    rule: str
    regex_string: str
    regex: "re.Pattern[str]"
    interval_ns: int
    hits_per_interval: int
    decision: Decision
    hosts_to_skip: Dict[str, bool] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_yaml_dict(cls, d: Dict[str, Any]) -> "RegexWithRate":
        regex_string = d.get("regex", "")
        check_re2_compatible(regex_string)
        try:
            regex = re.compile(regex_string)
        except re.error as e:
            raise ValueError(f"bad regex {regex_string!r}: {e}") from None
        interval_ns = int(float(d.get("interval", 0)) * NANOS_PER_SECOND)
        return cls(
            rule=d.get("rule", ""),
            regex_string=regex_string,
            regex=regex,
            interval_ns=interval_ns,
            hits_per_interval=int(d.get("hits_per_interval", 0)),
            decision=parse_decision(d.get("decision", "")),
            hosts_to_skip=dict(d.get("hosts_to_skip") or {}),
        )


@dataclasses.dataclass
class Config:
    regexes_with_rates: List[RegexWithRate] = dataclasses.field(default_factory=list)
    per_site_regexes_with_rates: Dict[str, List[RegexWithRate]] = dataclasses.field(
        default_factory=dict
    )
    global_decision_lists: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    per_site_decision_lists: Dict[str, Dict[str, List[str]]] = dataclasses.field(
        default_factory=dict
    )
    disable_logging: Dict[str, bool] = dataclasses.field(default_factory=dict)
    expiring_decision_ttl_seconds: int = 0
    matcher: str = "cpu"
    matcher_batch_lines: int = 16384
    matcher_max_line_len: int = 256
    matcher_device_windows: bool = False
    matcher_window_capacity: int = 0  # IP slots; 0 = auto-size
    matcher_prefilter: bool = True
    matcher_prefilter_cand_frac: float = 0.125
    matcher_backend: str = "auto"  # auto | pallas: the one route the port has
    # the device mesh (parallel/mesh.py): 0 = single-device; rp 0 = auto
    matcher_mesh_devices: int = 0
    matcher_mesh_rp: int = 0
    # the chunk commit: auto/on the single program, off the two programs
    # (a match program, then the window program at the drain)
    pallas_single_kernel: str = "auto"
    # the host tier and state tiering (the JAX schema's defaults)
    matcher_native_parse: bool = True
    slotmgr_native: bool = True
    traffic_sketch_enabled: bool = True
    traffic_sketch_depth: int = 4
    traffic_sketch_width: int = 8192
    traffic_sketch_hll_p: int = 12
    traffic_sketch_pull_seconds: float = 5.0
    traffic_sketch_topk: int = 32
    traffic_sketch_candidates: int = 8192
    slot_admission_enabled: bool = False
    slot_admission_min_estimate: int = 0  # <= 0: min(hits_per_interval) + 1
    warm_tier_enabled: bool = False
    warm_tier_capacity: int = 1 << 20
    # --- the /auth_request decision chain
    standalone_testing: bool = False
    iptables_ban_seconds: int = 0
    hostname: str = ""  # not a YAML key: the serving process sets it
    hmac_secret: str = ""
    disable_kafka: bool = False
    # --- the Kafka channel (commands in, reports out)
    disable_kafka_writer: bool = False
    kafka_security_protocol: str = ""
    kafka_ssl_ca: str = ""
    kafka_ssl_cert: str = ""
    kafka_ssl_key: str = ""
    kafka_ssl_key_password: str = ""
    kafka_command_topic: str = ""
    kafka_report_topic: str = ""
    kafka_min_bytes: int = 0
    kafka_max_bytes: int = 0
    kafka_max_wait_ms: int = 0
    kafka_dialer_timeout_seconds: int = 0
    kafka_dialer_keep_alive_seconds: int = 0
    dnet: str = ""
    dnet_to_partition: Dict[str, int] = dataclasses.field(default_factory=dict)
    block_ip_ttl_seconds: int = 0
    block_session_ttl_seconds: int = 0
    sites_to_block_ip_ttl_seconds: Dict[str, int] = dataclasses.field(default_factory=dict)
    sites_to_block_session_ttl_seconds: Dict[str, int] = dataclasses.field(default_factory=dict)
    sitewide_sha_inv_list: Dict[str, str] = dataclasses.field(default_factory=dict)
    per_site_user_agent_decision_lists: Dict[str, Dict[str, List[str]]] = dataclasses.field(
        default_factory=dict
    )
    global_user_agent_decision_lists: Dict[str, List[str]] = dataclasses.field(
        default_factory=dict
    )
    password_hashes: Dict[str, str] = dataclasses.field(default_factory=dict)
    password_protected_paths: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    password_protected_path_exceptions: Dict[str, List[str]] = dataclasses.field(
        default_factory=dict
    )
    password_hash_roaming: Dict[str, str] = dataclasses.field(default_factory=dict)
    password_persite_cookie_ttl_seconds: Dict[str, int] = dataclasses.field(default_factory=dict)
    use_user_agent_in_cookie: Dict[str, bool] = dataclasses.field(default_factory=dict)
    sites_to_disable_baskerville: Dict[str, bool] = dataclasses.field(default_factory=dict)
    sha_inv_path_exceptions: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    too_many_failed_challenges_interval_seconds: int = 0
    too_many_failed_challenges_threshold: int = 0
    password_cookie_ttl_seconds: int = 0
    sha_inv_cookie_ttl_seconds: int = 0
    sha_inv_expected_zero_bits: int = 0
    sha_inv_challenge_html: str = ""
    password_protected_path_html: str = ""
    challenger_bytes: bytes = b""      # the pages, embedded by load_pages
    password_page_bytes: bytes = b""
    session_cookie_hmac_secret: str = ""
    session_cookie_ttl_seconds: int = 0
    session_cookie_not_verify: bool = False
    # the challenge plane
    challenge_device_verify: bool = False
    challenge_verify_batch_max: int = 256
    challenge_failure_state_max: int = 0
    # --- the service: log files, the holder's required keys, the listener
    server_log_file: str = ""
    banning_log_file: str = ""
    banning_log_file_temp: str = ""
    gin_log_file: str = ""
    config_version: str = ""
    debug: bool = False
    kafka_brokers: List[str] = dataclasses.field(default_factory=list)
    http_workers: int = 0
    http_fast_path: bool = True
    http_listen_host: str = ""
    admin_token: str = ""
    serve_fastpath_enabled: bool = True
    serve_decision_table_capacity: int = 65536
    # --- the breaker, the failpoints, the streaming pipeline
    breaker_failure_threshold: int = 3
    breaker_recovery_seconds: float = 30.0
    matcher_latency_budget_ms: float = 0.0
    breaker_window_size: int = 0
    failpoints: str = ""
    failpoints_admin_enabled: bool = True
    pipeline_enabled: bool = False
    pipeline_ring_size: int = 4
    pipeline_latency_budget_ms: float = 250.0
    pipeline_buffer_lines: int = 131072
    pipeline_max_block_ms: float = 250.0
    matcher_probe_seconds: float = 0.0
    pipeline_fused: bool = True
    pipeline_kafka: bool = True
    encode_workers: int = -1
    drain_resolve_depth: int = 2
    pipeline_command_take_max: int = 1024
    # --- the kernel edge
    iptables_unbanner_seconds: int = 0  # read, used nowhere (as in JAX)
    ipset_netlink_enabled: bool = True
    # --- the observability plane
    metrics_log_file: str = ""
    profile: bool = False
    trace_enabled: bool = False
    trace_ring_size: int = 4096
    # the JAX key name, kept: here it turns on the torch.profiler / NVTX bridge
    trace_jax_annotations: bool = False
    provenance_enabled: bool = True
    provenance_ring_size: int = 2048
    slo_enabled: bool = True
    slo_sample_seconds: float = 15.0  # 0 = no background sampling thread
    slo_batch_latency_target: float = 0.99
    slo_shed_ratio_max: float = 0.001
    slo_stale_ratio_max: float = 0.001
    slo_breaker_open_ratio_max: float = 0.01
    slo_budget_trip_ratio_max: float = 0.01
    flightrec_dir: str = ""
    flightrec_min_interval_s: float = 60.0
    flightrec_keep: int = 16
    flightrec_provenance_records: int = 256
    # the decision fabric (fabric/): this shard's id and listen address,
    # the peer table (node id -> "host:port", this node's own included)
    fabric_enabled: bool = False
    fabric_node_id: str = ""
    fabric_listen: str = ""
    fabric_peers: Dict[str, str] = dataclasses.field(default_factory=dict)
    fabric_vnodes: int = 64
    fabric_send_timeout_ms: float = 2000.0
    fabric_takeover_grace_ms: float = 500.0
    fabric_gossip_interval_ms: float = 1000.0  # <= 0: no gossip membership
    fabric_suspect_timeout_ms: float = 3000.0
    fabric_indirect_probes: int = 2
    fabric_graceful_leave_ms: float = 5000.0
    fabric_inflight_frames: int = 8  # 0: the synchronous JSON path
    fabric_wire_v2: bool = True
    fabric_frame_max_bytes: int = 1 << 20
    fabric_shm_enabled: bool = False
    fabric_shm_ring_bytes: int = 1 << 21
    # fleet observability (obs/fleet.py)
    fabric_trace_propagation: bool = False
    fleet_metrics_enabled: bool = False
    fleet_scrape_timeout_ms: float = 750.0
    flightrec_fleet_capture: bool = False
    # not YAML keys: the holder sets them
    restart_time: int = 0
    reload_time: int = 0
    # JAX-schema keys in the file that the port does not read
    not_ported: List[str] = dataclasses.field(default_factory=list)


_SCALAR_KEYS = {
    "expiring_decision_ttl_seconds": int,
    "matcher": str,
    "matcher_batch_lines": int,
    "matcher_max_line_len": int,
    "matcher_device_windows": bool,
    "matcher_window_capacity": int,
    "matcher_prefilter": bool,
    "matcher_prefilter_cand_frac": float,
    "matcher_backend": str,
    "matcher_mesh_devices": int,
    "matcher_mesh_rp": int,
    "pallas_single_kernel": str,
    "matcher_native_parse": bool,
    "slotmgr_native": bool,
    "traffic_sketch_enabled": bool,
    "traffic_sketch_depth": int,
    "traffic_sketch_width": int,
    "traffic_sketch_hll_p": int,
    "traffic_sketch_pull_seconds": float,
    "traffic_sketch_topk": int,
    "traffic_sketch_candidates": int,
    "slot_admission_enabled": bool,
    "slot_admission_min_estimate": int,
    "warm_tier_enabled": bool,
    "warm_tier_capacity": int,
    "standalone_testing": bool,
    "iptables_ban_seconds": int,
    "hmac_secret": str,
    "disable_kafka": bool,
    "disable_kafka_writer": bool,
    "kafka_security_protocol": str,
    "kafka_ssl_ca": str,
    "kafka_ssl_cert": str,
    "kafka_ssl_key": str,
    "kafka_ssl_key_password": str,
    "kafka_command_topic": str,
    "kafka_report_topic": str,
    "kafka_min_bytes": int,
    "kafka_max_bytes": int,
    "kafka_max_wait_ms": int,
    "kafka_dialer_timeout_seconds": int,
    "kafka_dialer_keep_alive_seconds": int,
    "dnet": str,
    "block_ip_ttl_seconds": int,
    "block_session_ttl_seconds": int,
    "too_many_failed_challenges_interval_seconds": int,
    "too_many_failed_challenges_threshold": int,
    "password_cookie_ttl_seconds": int,
    "sha_inv_cookie_ttl_seconds": int,
    "sha_inv_expected_zero_bits": int,
    "sha_inv_challenge_html": str,
    "password_protected_path_html": str,
    "session_cookie_hmac_secret": str,
    "session_cookie_ttl_seconds": int,
    "session_cookie_not_verify": bool,
    "challenge_device_verify": bool,
    "challenge_verify_batch_max": int,
    "challenge_failure_state_max": int,
    "server_log_file": str,
    "banning_log_file": str,
    "banning_log_file_temp": str,
    "gin_log_file": str,
    "config_version": str,
    "debug": bool,
    "http_workers": int,
    "http_fast_path": bool,
    "http_listen_host": str,
    "admin_token": str,
    "serve_fastpath_enabled": bool,
    "serve_decision_table_capacity": int,
    "breaker_failure_threshold": int,
    "breaker_recovery_seconds": float,
    "matcher_latency_budget_ms": float,
    "breaker_window_size": int,
    "failpoints": str,
    "failpoints_admin_enabled": bool,
    "pipeline_enabled": bool,
    "pipeline_ring_size": int,
    "pipeline_latency_budget_ms": float,
    "pipeline_buffer_lines": int,
    "pipeline_max_block_ms": float,
    "matcher_probe_seconds": float,
    "pipeline_fused": bool,
    "pipeline_kafka": bool,
    "encode_workers": int,
    "drain_resolve_depth": int,
    "pipeline_command_take_max": int,
    "iptables_unbanner_seconds": int,
    "ipset_netlink_enabled": bool,
    "metrics_log_file": str,
    "profile": bool,
    "trace_enabled": bool,
    "trace_ring_size": int,
    "trace_jax_annotations": bool,
    "provenance_enabled": bool,
    "provenance_ring_size": int,
    "slo_enabled": bool,
    "slo_sample_seconds": float,
    "slo_batch_latency_target": float,
    "slo_shed_ratio_max": float,
    "slo_stale_ratio_max": float,
    "slo_breaker_open_ratio_max": float,
    "slo_budget_trip_ratio_max": float,
    "flightrec_dir": str,
    "flightrec_min_interval_s": float,
    "flightrec_keep": int,
    "flightrec_provenance_records": int,
    "fabric_enabled": bool,
    "fabric_node_id": str,
    "fabric_listen": str,
    "fabric_vnodes": int,
    "fabric_send_timeout_ms": float,
    "fabric_takeover_grace_ms": float,
    "fabric_gossip_interval_ms": float,
    "fabric_suspect_timeout_ms": float,
    "fabric_indirect_probes": int,
    "fabric_graceful_leave_ms": float,
    "fabric_inflight_frames": int,
    "fabric_wire_v2": bool,
    "fabric_frame_max_bytes": int,
    "fabric_shm_enabled": bool,
    "fabric_shm_ring_bytes": int,
    "fabric_trace_propagation": bool,
    "fleet_metrics_enabled": bool,
    "fleet_scrape_timeout_ms": float,
    "flightrec_fleet_capture": bool,
}

_DICT_KEYS = (
    "global_decision_lists", "per_site_decision_lists", "disable_logging",
    "sitewide_sha_inv_list", "per_site_user_agent_decision_lists",
    "global_user_agent_decision_lists", "password_hashes",
    "password_protected_paths", "password_protected_path_exceptions",
    "password_hash_roaming", "password_persite_cookie_ttl_seconds",
    "use_user_agent_in_cookie", "sites_to_disable_baskerville",
    "sha_inv_path_exceptions", "dnet_to_partition", "sites_to_block_ip_ttl_seconds",
    "sites_to_block_session_ttl_seconds", "fabric_peers",
)

# keys the port reads besides the two tables above
_OTHER_KEYS = (
    "regexes_with_rates", "per_site_regexes_with_rates", "kafka_brokers",
)

# the rest of the JAX schema's keys (`banjax_tpu/config/schema.py:504-577`),
# read there and not here: none, every module is ported
_NOT_PORTED_KEYS: frozenset = frozenset()

_PAGES_DIR = Path(__file__).resolve().parent / "httpapi" / "pages"


def config_from_yaml_text(text: str, standalone_testing_default: bool = False) -> Config:
    """Parse YAML text into the slice's Config; a bad rule fails the load.
    `standalone_testing_default` seeds the field before the YAML is read,
    so an explicit `standalone_testing:` key wins (config_holder.go:89-90)."""
    raw = yaml.safe_load(text) or {}
    if not isinstance(raw, dict):
        raise ValueError("config root must be a mapping")
    cfg = Config()
    cfg.standalone_testing = standalone_testing_default
    for key, typ in _SCALAR_KEYS.items():
        if key not in raw or raw[key] is None:
            continue
        value = raw[key]
        if typ is int:
            if isinstance(value, bool) or not isinstance(value, int):
                raise ValueError(f"config key {key}: expected int, got {value!r}")
        elif typ is bool:
            if not isinstance(value, bool):
                raise ValueError(f"config key {key}: expected bool, got {value!r}")
        elif typ is float:
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                raise ValueError(f"config key {key}: expected float, got {value!r}")
            value = float(value)
        elif not isinstance(value, typ):
            raise ValueError(f"config key {key}: expected {typ.__name__}, got {value!r}")
        setattr(cfg, key, value)
    for key in _DICT_KEYS:
        if key in raw and raw[key] is not None:
            if not isinstance(raw[key], dict):
                raise ValueError(f"config key {key}: expected dict, got {raw[key]!r}")
            setattr(cfg, key, raw[key])
    if raw.get("kafka_brokers") is not None:
        if not isinstance(raw["kafka_brokers"], list):
            raise ValueError(f"config key kafka_brokers: expected list, got {raw['kafka_brokers']!r}")
        cfg.kafka_brokers = raw["kafka_brokers"]
    for entry in raw.get("regexes_with_rates") or []:
        cfg.regexes_with_rates.append(RegexWithRate.from_yaml_dict(entry))
    for site, entries in (raw.get("per_site_regexes_with_rates") or {}).items():
        cfg.per_site_regexes_with_rates[site] = [
            RegexWithRate.from_yaml_dict(e) for e in (entries or [])
        ]
    if cfg.matcher not in ("cpu", "tpu"):
        raise ValueError(f"config key matcher: expected cpu|tpu, got {cfg.matcher!r}")
    if cfg.matcher_window_capacity < 0:
        raise ValueError(
            "config key matcher_window_capacity: expected 0 (auto-size) or a "
            f"positive slot count, got {cfg.matcher_window_capacity}"
        )
    if cfg.pallas_single_kernel not in ("auto", "on", "off"):
        raise ValueError(
            "config key pallas_single_kernel: expected auto|on|off, got "
            f"{cfg.pallas_single_kernel!r}"
        )
    if cfg.matcher_backend not in ("auto", "xla", "pallas", "pallas-interpret"):
        raise ValueError(
            "config key matcher_backend: expected "
            f"auto|xla|pallas|pallas-interpret, got {cfg.matcher_backend!r}"
        )
    if cfg.matcher_backend in ("xla", "pallas-interpret"):
        raise ValueError(
            f"config key matcher_backend: {cfg.matcher_backend} would run the plain "
            "PyTorch versions on the card, which the port never does; use auto or "
            "pallas (the Hopper kernels on the card, the plain versions only on a "
            "CPU device)"
        )
    if cfg.matcher_mesh_devices < 0 or cfg.matcher_mesh_rp < 0:
        raise ValueError(
            "config keys matcher_mesh_devices/matcher_mesh_rp: expected "
            f"non-negative, got {cfg.matcher_mesh_devices}/{cfg.matcher_mesh_rp}"
        )
    if (
        cfg.matcher_mesh_devices > 0
        and cfg.matcher_mesh_rp > 0
        and cfg.matcher_mesh_devices % cfg.matcher_mesh_rp != 0
    ):
        raise ValueError(
            f"config key matcher_mesh_rp: {cfg.matcher_mesh_rp} does not "
            f"divide matcher_mesh_devices {cfg.matcher_mesh_devices}"
        )
    if not 1 <= cfg.traffic_sketch_depth <= 8:
        raise ValueError(
            f"config key traffic_sketch_depth: expected 1..8, got {cfg.traffic_sketch_depth}"
        )
    if cfg.traffic_sketch_width < 16:
        raise ValueError(
            f"config key traffic_sketch_width: expected >= 16, got {cfg.traffic_sketch_width}"
        )
    if not 4 <= cfg.traffic_sketch_hll_p <= 16:
        raise ValueError(
            f"config key traffic_sketch_hll_p: expected 4..16, got {cfg.traffic_sketch_hll_p}"
        )
    if cfg.traffic_sketch_pull_seconds < 0:
        raise ValueError(
            "config key traffic_sketch_pull_seconds: expected non-negative, "
            f"got {cfg.traffic_sketch_pull_seconds}"
        )
    if cfg.traffic_sketch_topk < 1 or cfg.traffic_sketch_candidates < 1:
        raise ValueError(
            "config keys traffic_sketch_topk/traffic_sketch_candidates: expected "
            f">= 1, got {cfg.traffic_sketch_topk}/{cfg.traffic_sketch_candidates}"
        )
    if cfg.slot_admission_enabled and not (
        cfg.traffic_sketch_enabled and cfg.matcher_device_windows
    ):
        raise ValueError(
            "config key slot_admission_enabled: requires traffic_sketch_enabled "
            "and matcher_device_windows"
        )
    if cfg.warm_tier_enabled and not cfg.matcher_device_windows:
        raise ValueError("config key warm_tier_enabled: requires matcher_device_windows")
    if cfg.challenge_verify_batch_max < 1:
        raise ValueError(
            "config key challenge_verify_batch_max: expected >= 1, got "
            f"{cfg.challenge_verify_batch_max}"
        )
    if cfg.challenge_failure_state_max < 0:
        raise ValueError(
            "config key challenge_failure_state_max: expected 0 (unbounded) "
            f"or a positive entry count, got {cfg.challenge_failure_state_max}"
        )
    if cfg.serve_decision_table_capacity < 1:
        raise ValueError(
            "config key serve_decision_table_capacity: expected >= 1 (rounded "
            f"up to a power of two), got {cfg.serve_decision_table_capacity}"
        )
    _check_pipeline_keys(cfg)
    _check_obs_keys(cfg)
    _check_fabric_keys(cfg)
    cfg.not_ported = sorted(k for k in raw if k in _NOT_PORTED_KEYS)
    if cfg.not_ported:
        log.warning("not ported: %s", ", ".join(cfg.not_ported))
    return cfg


def _check_pipeline_keys(cfg: Config) -> None:
    """The JAX schema's checks of the breaker, pipeline and encode keys
    (`banjax_tpu/config/schema.py:667-726`), with its messages."""
    if cfg.breaker_failure_threshold < 1:
        raise ValueError(
            "config key breaker_failure_threshold: expected >= 1, got "
            f"{cfg.breaker_failure_threshold}"
        )
    if cfg.breaker_recovery_seconds < 0 or cfg.matcher_latency_budget_ms < 0:
        raise ValueError(
            "config keys breaker_recovery_seconds/matcher_latency_budget_ms: "
            f"expected non-negative, got {cfg.breaker_recovery_seconds}/"
            f"{cfg.matcher_latency_budget_ms}"
        )
    if cfg.breaker_window_size != 0 and (
        cfg.breaker_window_size < cfg.breaker_failure_threshold
    ):
        raise ValueError(
            "config key breaker_window_size: expected 0 (off) or >= "
            f"breaker_failure_threshold ({cfg.breaker_failure_threshold}), "
            f"got {cfg.breaker_window_size}"
        )
    if cfg.pipeline_ring_size < 1:
        raise ValueError(
            f"config key pipeline_ring_size: expected >= 1, got {cfg.pipeline_ring_size}"
        )
    if cfg.pipeline_latency_budget_ms <= 0:
        raise ValueError(
            "config key pipeline_latency_budget_ms: expected positive, got "
            f"{cfg.pipeline_latency_budget_ms}"
        )
    if cfg.pipeline_buffer_lines < 1:
        raise ValueError(
            f"config key pipeline_buffer_lines: expected >= 1, got {cfg.pipeline_buffer_lines}"
        )
    if cfg.pipeline_max_block_ms < 0 or cfg.matcher_probe_seconds < 0:
        raise ValueError(
            "config keys pipeline_max_block_ms/matcher_probe_seconds: "
            f"expected non-negative, got {cfg.pipeline_max_block_ms}/"
            f"{cfg.matcher_probe_seconds}"
        )
    if cfg.encode_workers < -1:
        raise ValueError(
            "config key encode_workers: expected -1 (auto), 0 (single-"
            f"thread) or a positive worker count, got {cfg.encode_workers}"
        )
    if cfg.drain_resolve_depth < 1:
        raise ValueError(
            f"config key drain_resolve_depth: expected >= 1, got {cfg.drain_resolve_depth}"
        )
    if cfg.pipeline_command_take_max < 1:
        raise ValueError(
            "config key pipeline_command_take_max: expected >= 1, got "
            f"{cfg.pipeline_command_take_max}"
        )


def _check_obs_keys(cfg: Config) -> None:
    """The JAX schema's checks of the trace, provenance, SLO and flight
    recorder keys (`banjax_tpu/config/schema.py:727-753,866-871`), with
    its messages."""
    if cfg.trace_ring_size < 1:
        raise ValueError(
            f"config key trace_ring_size: expected >= 1, got {cfg.trace_ring_size}"
        )
    if cfg.provenance_ring_size < 1:
        raise ValueError(
            f"config key provenance_ring_size: expected >= 1, got {cfg.provenance_ring_size}"
        )
    if not 0.0 < cfg.slo_batch_latency_target < 1.0:
        raise ValueError(
            "config key slo_batch_latency_target: expected a fraction in "
            f"(0, 1), got {cfg.slo_batch_latency_target}"
        )
    for key in ("slo_shed_ratio_max", "slo_stale_ratio_max",
                "slo_breaker_open_ratio_max", "slo_budget_trip_ratio_max"):
        if getattr(cfg, key) <= 0:
            raise ValueError(f"config key {key}: expected positive, got {getattr(cfg, key)}")
    if cfg.slo_sample_seconds < 0 or cfg.flightrec_min_interval_s < 0:
        raise ValueError(
            "config keys slo_sample_seconds/flightrec_min_interval_s: "
            f"expected non-negative, got {cfg.slo_sample_seconds}/"
            f"{cfg.flightrec_min_interval_s}"
        )
    if cfg.flightrec_keep < 1 or cfg.flightrec_provenance_records < 1:
        raise ValueError(
            "config keys flightrec_keep/flightrec_provenance_records: "
            f"expected >= 1, got {cfg.flightrec_keep}/"
            f"{cfg.flightrec_provenance_records}"
        )


def _check_fabric_keys(cfg: Config) -> None:
    """The JAX schema's checks of the fabric and fleet keys
    (`banjax_tpu/config/schema.py:796-865`), with its messages."""
    if cfg.fabric_vnodes < 1:
        raise ValueError(f"config key fabric_vnodes: expected >= 1, got {cfg.fabric_vnodes}")
    if cfg.fabric_send_timeout_ms <= 0 or cfg.fabric_takeover_grace_ms < 0:
        raise ValueError(
            "config keys fabric_send_timeout_ms/fabric_takeover_grace_ms: "
            f"expected positive/non-negative, got {cfg.fabric_send_timeout_ms}"
            f"/{cfg.fabric_takeover_grace_ms}"
        )
    if cfg.fabric_enabled:
        if not cfg.fabric_node_id or not cfg.fabric_listen:
            raise ValueError(
                "config key fabric_enabled: requires fabric_node_id and fabric_listen"
            )
        if cfg.fabric_peers and cfg.fabric_node_id not in cfg.fabric_peers:
            raise ValueError(
                f"config key fabric_peers: missing this node's own id {cfg.fabric_node_id!r}"
            )
    if (cfg.fabric_gossip_interval_ms > 0
            and cfg.fabric_suspect_timeout_ms <= cfg.fabric_gossip_interval_ms):
        raise ValueError(
            "config key fabric_suspect_timeout_ms: must exceed "
            f"fabric_gossip_interval_ms, got {cfg.fabric_suspect_timeout_ms}"
            f" <= {cfg.fabric_gossip_interval_ms}"
        )
    if cfg.fabric_indirect_probes < 0:
        raise ValueError(
            f"config key fabric_indirect_probes: expected >= 0, got {cfg.fabric_indirect_probes}"
        )
    if cfg.fabric_graceful_leave_ms < 0:
        raise ValueError(
            "config key fabric_graceful_leave_ms: expected >= 0, got "
            f"{cfg.fabric_graceful_leave_ms}"
        )
    if cfg.fabric_inflight_frames < 0:
        raise ValueError(
            "config key fabric_inflight_frames: expected >= 0 (0 = "
            f"synchronous JSON path), got {cfg.fabric_inflight_frames}"
        )
    if cfg.fabric_frame_max_bytes < 4096:
        raise ValueError(
            f"config key fabric_frame_max_bytes: expected >= 4096, got {cfg.fabric_frame_max_bytes}"
        )
    if cfg.fabric_shm_ring_bytes & (cfg.fabric_shm_ring_bytes - 1) or \
            cfg.fabric_shm_ring_bytes < 4096:
        raise ValueError(
            "config key fabric_shm_ring_bytes: expected a power of two "
            f">= 4096, got {cfg.fabric_shm_ring_bytes}"
        )
    if cfg.fabric_shm_enabled and cfg.fabric_shm_ring_bytes <= cfg.fabric_frame_max_bytes:
        raise ValueError(
            "config key fabric_shm_ring_bytes: must exceed "
            "fabric_frame_max_bytes (a frame is ring-written atomically), "
            f"got {cfg.fabric_shm_ring_bytes} <= {cfg.fabric_frame_max_bytes}"
        )
    if cfg.fleet_scrape_timeout_ms <= 0:
        raise ValueError(
            "config key fleet_scrape_timeout_ms: expected positive, got "
            f"{cfg.fleet_scrape_timeout_ms}"
        )


def load_pages(cfg: Config) -> Config:
    """Embed the SHA-inverse challenge page and the password page, from the
    configured paths or the port's copies (`config/holder.py:45-55`)."""
    cfg.challenger_bytes = Path(
        cfg.sha_inv_challenge_html or _PAGES_DIR / "sha-inverse-challenge.html"
    ).read_bytes()
    cfg.password_page_bytes = Path(
        cfg.password_protected_path_html or _PAGES_DIR / "password-protected-path.html"
    ).read_bytes()
    return cfg
