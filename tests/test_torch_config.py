"""The port's config loader against the JAX schema: the deploy file loads,
every key the JAX schema reads and the port does not is named (one
warning, `Config.not_ported`), the service's and the pipeline's keys are
read with the JAX defaults and checks, and so are the kernel edge's, the
observability plane's and the Kafka channel's, `pipeline_enabled: true`
loads, and `http_workers` loads as the JAX schema reads it. Every module
is ported, so no key is left unread: the mesh keys load with the JAX
checks, and `matcher_backend` refuses the JAX-only `xla` and
`pallas-interpret`."""

import logging
from pathlib import Path

import pytest
import yaml

from banjax_tpu.config import schema as jax_schema
from banjax_tpu_torch import config as port_config
from banjax_tpu_torch.config import config_from_yaml_text

ROOT = Path(__file__).resolve().parents[1]
DEPLOY = ROOT / "deploy" / "banjax-config.yaml"
SERVICE_KEYS = (
    "server_log_file", "banning_log_file", "banning_log_file_temp", "gin_log_file",
    "config_version", "debug", "disable_kafka", "kafka_brokers", "http_fast_path",
    "http_listen_host", "admin_token", "serve_fastpath_enabled",
    "serve_decision_table_capacity", "http_workers",
)
# the streaming pipeline's, the breaker's, the probe's, the failpoints' and
# the sharded encode's keys
PIPELINE_KEYS = (
    "breaker_failure_threshold", "breaker_recovery_seconds", "matcher_latency_budget_ms",
    "breaker_window_size", "failpoints", "failpoints_admin_enabled", "pipeline_enabled",
    "pipeline_ring_size", "pipeline_latency_budget_ms", "pipeline_buffer_lines",
    "pipeline_max_block_ms", "matcher_probe_seconds", "pipeline_fused", "pipeline_kafka",
    "encode_workers", "drain_resolve_depth", "pipeline_command_take_max",
)
# the kernel edge's and the observability plane's keys
OBS_KEYS = (
    "iptables_ban_seconds", "iptables_unbanner_seconds", "ipset_netlink_enabled",
    "metrics_log_file", "profile", "trace_enabled", "trace_ring_size",
    "trace_jax_annotations", "provenance_enabled", "provenance_ring_size", "slo_enabled",
    "slo_sample_seconds", "slo_batch_latency_target", "slo_shed_ratio_max",
    "slo_stale_ratio_max", "slo_breaker_open_ratio_max", "slo_budget_trip_ratio_max",
    "flightrec_dir", "flightrec_min_interval_s", "flightrec_keep",
    "flightrec_provenance_records",
)
# the Kafka channel's keys (commands in, reports out, the command TTLs)
KAFKA_KEYS = (
    "disable_kafka_writer", "kafka_security_protocol", "kafka_ssl_ca", "kafka_ssl_cert",
    "kafka_ssl_key", "kafka_ssl_key_password", "kafka_command_topic", "kafka_report_topic",
    "kafka_min_bytes", "kafka_max_bytes", "kafka_max_wait_ms",
    "kafka_dialer_timeout_seconds", "kafka_dialer_keep_alive_seconds", "dnet",
    "dnet_to_partition", "block_ip_ttl_seconds", "block_session_ttl_seconds",
    "sites_to_block_ip_ttl_seconds", "sites_to_block_session_ttl_seconds",
)


# the decision fabric's and fleet observability's keys
FABRIC_KEYS = (
    "fabric_enabled", "fabric_node_id", "fabric_listen", "fabric_peers", "fabric_vnodes",
    "fabric_send_timeout_ms", "fabric_takeover_grace_ms", "fabric_gossip_interval_ms",
    "fabric_suspect_timeout_ms", "fabric_indirect_probes", "fabric_graceful_leave_ms",
    "fabric_inflight_frames", "fabric_wire_v2", "fabric_frame_max_bytes",
    "fabric_shm_enabled", "fabric_shm_ring_bytes", "fabric_trace_propagation",
    "fleet_metrics_enabled", "fleet_scrape_timeout_ms", "flightrec_fleet_capture",
)


def _jax_keys():
    return set(jax_schema._SCALAR_KEYS) | set(jax_schema._DICT_OR_LIST_KEYS) | {
        "regexes_with_rates", "per_site_regexes_with_rates"}


def _port_read_keys():
    return (set(port_config._SCALAR_KEYS) | set(port_config._DICT_KEYS)
            | set(port_config._OTHER_KEYS))


def test_every_jax_schema_key_is_read_or_named_not_ported():
    jax_keys, read = _jax_keys(), _port_read_keys()
    assert read | port_config._NOT_PORTED_KEYS == jax_keys
    assert not read & port_config._NOT_PORTED_KEYS
    assert set(SERVICE_KEYS) <= read
    assert set(PIPELINE_KEYS) <= read
    assert set(OBS_KEYS) <= read
    assert set(KAFKA_KEYS) <= read
    assert set(FABRIC_KEYS) <= read
    assert port_config._NOT_PORTED_KEYS == set()


def test_deploy_file_names_exactly_the_keys_the_port_does_not_read(caplog):
    text = DEPLOY.read_text()
    in_file = set(yaml.safe_load(text))
    expected = sorted(k for k in in_file if k in _jax_keys() - _port_read_keys())
    with caplog.at_level(logging.WARNING, logger="banjax_tpu_torch.config"):
        cfg = config_from_yaml_text(text)
    assert cfg.not_ported == expected
    assert {"serve_fastpath_enabled", "server_log_file", "banning_log_file"}.isdisjoint(expected)
    assert expected == []
    assert set(FABRIC_KEYS).isdisjoint(expected)
    assert set(PIPELINE_KEYS).isdisjoint(expected)
    assert set(OBS_KEYS).isdisjoint(expected)
    assert set(KAFKA_KEYS).isdisjoint(expected) and "http_workers" not in expected
    warnings = [r.getMessage() for r in caplog.records if "not ported" in r.getMessage()]
    assert warnings == []


def test_service_keys_match_the_jax_schema():
    text = DEPLOY.read_text()
    jax_cfg = jax_schema.config_from_yaml_text(text)
    cfg = config_from_yaml_text(text)
    for key in SERVICE_KEYS:
        assert getattr(cfg, key) == getattr(jax_cfg, key), key
    empty_jax, empty = jax_schema.config_from_yaml_text(""), config_from_yaml_text("")
    for key in SERVICE_KEYS:
        assert getattr(empty, key) == getattr(empty_jax, key), key
    assert empty.not_ported == []
    assert config_from_yaml_text("", standalone_testing_default=True).standalone_testing
    assert not config_from_yaml_text("standalone_testing: false",
                                     standalone_testing_default=True).standalone_testing


@pytest.mark.parametrize("text, match", [
    ("http_workers: '2'", "http_workers"),
    ("http_workers: true", "http_workers"),
    ("serve_decision_table_capacity: 0", "serve_decision_table_capacity"),
    ("http_fast_path: 1", "http_fast_path"),
    ("kafka_brokers: kafka:9092", "kafka_brokers"),
    ("server_log_file: 7", "server_log_file"),
])
def test_service_keys_are_checked(text, match):
    with pytest.raises(ValueError, match=match):
        config_from_yaml_text(text)


def test_deploy_not_ported_list_shrank_by_exactly_the_pipeline_keys():
    """The keys this slice reads are the deploy file's pipeline, breaker,
    probe and failpoint keys; what stays not ported is the rest."""
    text = DEPLOY.read_text()
    in_file = set(yaml.safe_load(text))
    cfg = config_from_yaml_text(text)
    before = sorted(k for k in in_file if k in _jax_keys() - (_port_read_keys() - set(PIPELINE_KEYS)))
    assert sorted(set(before) - set(cfg.not_ported)) == sorted(in_file & set(PIPELINE_KEYS))
    assert set(cfg.not_ported) <= set(before)


def test_pipeline_keys_match_the_jax_schema():
    text = DEPLOY.read_text()
    jax_cfg = jax_schema.config_from_yaml_text(text)
    cfg = config_from_yaml_text(text)
    empty_jax, empty = jax_schema.config_from_yaml_text(""), config_from_yaml_text("")
    for key in PIPELINE_KEYS:
        assert getattr(cfg, key) == getattr(jax_cfg, key), key
        assert getattr(empty, key) == getattr(empty_jax, key), key
    on = "pipeline_enabled: true\nencode_workers: 2\ndrain_resolve_depth: 1\nfailpoints: x=error:1"
    cfg_on, jax_on = config_from_yaml_text(on), jax_schema.config_from_yaml_text(on)
    for key in PIPELINE_KEYS:
        assert getattr(cfg_on, key) == getattr(jax_on, key), key
    assert cfg_on.pipeline_enabled


@pytest.mark.parametrize("text, match", [
    ("pipeline_ring_size: 0", "pipeline_ring_size"),
    ("encode_workers: -2", "encode_workers"),
    ("pipeline_latency_budget_ms: 0", "pipeline_latency_budget_ms"),
    ("pipeline_buffer_lines: 0", "pipeline_buffer_lines"),
    ("pipeline_max_block_ms: -1", "pipeline_max_block_ms"),
    ("matcher_probe_seconds: -1", "matcher_probe_seconds"),
    ("breaker_failure_threshold: 0", "breaker_failure_threshold"),
    ("breaker_recovery_seconds: -1", "breaker_recovery_seconds"),
    ("matcher_latency_budget_ms: -5", "matcher_latency_budget_ms"),
    ("breaker_window_size: 2", "breaker_window_size"),
    ("drain_resolve_depth: 0", "drain_resolve_depth"),
    ("pipeline_command_take_max: 0", "pipeline_command_take_max"),
    ("pipeline_enabled: 1", "pipeline_enabled"),
    ("failpoints: 3", "failpoints"),
])
def test_pipeline_keys_are_checked(text, match):
    """Each bad value fails the port's load and the JAX schema's alike."""
    with pytest.raises(ValueError, match=match):
        config_from_yaml_text(text)
    with pytest.raises(ValueError, match=match):
        jax_schema.config_from_yaml_text(text)


def test_obs_keys_match_the_jax_schema():
    """The kernel edge's and the observability plane's keys: the JAX
    defaults, the deploy file's values, and explicit values alike."""
    text = DEPLOY.read_text()
    jax_cfg, cfg = jax_schema.config_from_yaml_text(text), config_from_yaml_text(text)
    empty_jax, empty = jax_schema.config_from_yaml_text(""), config_from_yaml_text("")
    on = ("trace_enabled: true\ntrace_ring_size: 64\ntrace_jax_annotations: true\n"
          "provenance_enabled: false\nslo_sample_seconds: 1\nflightrec_dir: /x\n"
          "flightrec_keep: 2\nprofile: true\nipset_netlink_enabled: false\n"
          "iptables_unbanner_seconds: 7\nslo_batch_latency_target: 0.5\n")
    cfg_on, jax_on = config_from_yaml_text(on), jax_schema.config_from_yaml_text(on)
    for key in OBS_KEYS:
        assert getattr(cfg, key) == getattr(jax_cfg, key), key
        assert getattr(empty, key) == getattr(empty_jax, key), key
        assert getattr(cfg_on, key) == getattr(jax_on, key), key
    assert cfg.ipset_netlink_enabled and cfg.metrics_log_file and cfg.iptables_unbanner_seconds
    assert empty.provenance_enabled and empty.slo_enabled and not empty.trace_enabled


@pytest.mark.parametrize("text, match", [
    ("trace_ring_size: 0", "trace_ring_size"),
    ("provenance_ring_size: 0", "provenance_ring_size"),
    ("slo_batch_latency_target: 1.0", "slo_batch_latency_target"),
    ("slo_shed_ratio_max: 0", "slo_shed_ratio_max"),
    ("slo_stale_ratio_max: -1", "slo_stale_ratio_max"),
    ("slo_breaker_open_ratio_max: 0", "slo_breaker_open_ratio_max"),
    ("slo_budget_trip_ratio_max: 0", "slo_budget_trip_ratio_max"),
    ("slo_sample_seconds: -1", "slo_sample_seconds"),
    ("flightrec_min_interval_s: -1", "flightrec_min_interval_s"),
    ("flightrec_keep: 0", "flightrec_keep"),
    ("flightrec_provenance_records: 0", "flightrec_provenance_records"),
    ("trace_enabled: 1", "trace_enabled"),
    ("ipset_netlink_enabled: yes please", "ipset_netlink_enabled"),
    ("metrics_log_file: 3", "metrics_log_file"),
    ("iptables_unbanner_seconds: 1.5", "iptables_unbanner_seconds"),
])
def test_obs_keys_are_checked(text, match):
    """Each bad value fails the port's load and the JAX schema's alike,
    with the same message."""
    with pytest.raises(ValueError, match=match) as port_err:
        config_from_yaml_text(text)
    with pytest.raises(ValueError, match=match) as jax_err:
        jax_schema.config_from_yaml_text(text)
    assert str(port_err.value) == str(jax_err.value)


KAFKA_TEXT = """
disable_kafka: false
disable_kafka_writer: true
kafka_brokers: ["127.0.0.1:9092", "127.0.0.1:9093"]
kafka_security_protocol: ssl
kafka_ssl_ca: /ca.pem
kafka_ssl_cert: /c.pem
kafka_ssl_key: /c.key
kafka_ssl_key_password: pw
kafka_command_topic: cmds
kafka_report_topic: reps
kafka_min_bytes: 2
kafka_max_bytes: 4096
kafka_max_wait_ms: 50
kafka_dialer_timeout_seconds: 3
kafka_dialer_keep_alive_seconds: 9
dnet: d2
dnet_to_partition: {d1: 0, d2: 3}
block_ip_ttl_seconds: 600
block_session_ttl_seconds: 900
sites_to_block_ip_ttl_seconds: {a.example: 77}
sites_to_block_session_ttl_seconds: {b.example: 88}
"""


@pytest.mark.parametrize("text", [KAFKA_TEXT, "", "deploy"])
def test_kafka_keys_match_the_jax_schema(text):
    text = DEPLOY.read_text() if text == "deploy" else text
    jax_cfg, cfg = jax_schema.config_from_yaml_text(text), config_from_yaml_text(text)
    for key in KAFKA_KEYS + ("disable_kafka", "kafka_brokers", "pipeline_kafka"):
        assert getattr(cfg, key) == getattr(jax_cfg, key), key
    assert not set(KAFKA_KEYS) & set(cfg.not_ported)


@pytest.mark.parametrize("text, match", [
    ("kafka_min_bytes: '2'", "kafka_min_bytes"),
    ("kafka_command_topic: 7", "kafka_command_topic"),
    ("disable_kafka_writer: 1", "disable_kafka_writer"),
    ("dnet_to_partition: [1]", "dnet_to_partition"),
    ("sites_to_block_ip_ttl_seconds: x", "sites_to_block_ip_ttl_seconds"),
])
def test_kafka_keys_are_checked_as_jax(text, match):
    for load in (config_from_yaml_text, jax_schema.config_from_yaml_text):
        with pytest.raises(ValueError, match=match):
            load(text)


@pytest.mark.parametrize("workers", [2, -1, -2, 0])
def test_http_workers_loads_as_jax(workers):
    text = f"http_workers: {workers}"
    assert config_from_yaml_text(text).http_workers == \
        jax_schema.config_from_yaml_text(text).http_workers == workers


def test_deploy_not_ported_list_shrank_by_exactly_the_kafka_and_worker_keys():
    """What this slice reads of the deploy file is its Kafka keys and
    `http_workers`; the rest of what was not ported stays named."""
    text = DEPLOY.read_text()
    in_file = set(yaml.safe_load(text))
    cfg = config_from_yaml_text(text)
    slice_keys = set(KAFKA_KEYS) | {"http_workers"}
    before = sorted(k for k in in_file if k in _jax_keys() - (_port_read_keys() - slice_keys))
    assert sorted(set(before) - set(cfg.not_ported)) == sorted(in_file & slice_keys)
    assert set(cfg.not_ported) <= set(before)


SHARD = """
fabric_enabled: true
fabric_node_id: b
fabric_listen: 127.0.0.1:4481
fabric_peers: {a: "127.0.0.1:4480", b: "127.0.0.1:4481", c: "127.0.0.1:4482"}
fabric_gossip_interval_ms: 50
fabric_suspect_timeout_ms: 300
fabric_inflight_frames: 0
fabric_shm_enabled: true
fabric_shm_ring_bytes: 4194304
fabric_trace_propagation: true
fleet_metrics_enabled: true
fleet_scrape_timeout_ms: 100
flightrec_fleet_capture: true
"""


@pytest.mark.parametrize("text", ["", "deploy", SHARD])
def test_fabric_keys_match_the_jax_schema(text):
    text = DEPLOY.read_text() if text == "deploy" else text
    cfg, jax_cfg = config_from_yaml_text(text), jax_schema.config_from_yaml_text(text)
    for key in FABRIC_KEYS:
        assert getattr(cfg, key) == getattr(jax_cfg, key), key


@pytest.mark.parametrize("text, match", [
    ("fabric_vnodes: 0", "fabric_vnodes"),
    ("fabric_send_timeout_ms: 0", "fabric_send_timeout_ms"),
    ("fabric_enabled: true", "fabric_enabled"),
    ("fabric_enabled: true\nfabric_node_id: x\nfabric_listen: ':1'\nfabric_peers: {a: ':2'}",
     "fabric_peers"),
    ("fabric_suspect_timeout_ms: 1000", "fabric_suspect_timeout_ms"),
    ("fabric_indirect_probes: -1", "fabric_indirect_probes"),
    ("fabric_graceful_leave_ms: -1", "fabric_graceful_leave_ms"),
    ("fabric_inflight_frames: -1", "fabric_inflight_frames"),
    ("fabric_frame_max_bytes: 100", "fabric_frame_max_bytes"),
    ("fabric_shm_ring_bytes: 5000", "fabric_shm_ring_bytes"),
    ("fabric_shm_enabled: true\nfabric_shm_ring_bytes: 1048576", "fabric_shm_ring_bytes"),
    ("fleet_scrape_timeout_ms: 0", "fleet_scrape_timeout_ms"),
    ("fabric_peers: [a]", "fabric_peers"),
    ("fabric_wire_v2: 1", "fabric_wire_v2"),
])
def test_fabric_keys_are_checked_as_jax_checks_them(text, match):
    with pytest.raises(ValueError, match=match):
        jax_schema.config_from_yaml_text(text)
    with pytest.raises(ValueError, match=match):
        config_from_yaml_text(text)


MESH_KEYS = ("matcher_backend", "matcher_mesh_devices", "matcher_mesh_rp")


@pytest.mark.parametrize("text", [
    "", "deploy", "matcher_mesh_devices: 4\nmatcher_mesh_rp: 2", "matcher_mesh_devices: 8",
    "matcher_backend: pallas\nmatcher_mesh_devices: 1",
])
def test_mesh_keys_load_as_jax(text):
    text = DEPLOY.read_text() if text == "deploy" else text
    cfg, jax_cfg = config_from_yaml_text(text), jax_schema.config_from_yaml_text(text)
    for key in MESH_KEYS:
        assert getattr(cfg, key) == getattr(jax_cfg, key), key
    assert cfg.not_ported == []


@pytest.mark.parametrize("text, match", [
    ("matcher_mesh_devices: -1", "matcher_mesh_devices/matcher_mesh_rp: expected non-negative"),
    ("matcher_mesh_rp: -2", "matcher_mesh_devices/matcher_mesh_rp: expected non-negative"),
    ("matcher_mesh_devices: 4\nmatcher_mesh_rp: 3",
     "matcher_mesh_rp: 3 does not divide matcher_mesh_devices 4"),
    ("matcher_mesh_rp: '2'", "matcher_mesh_rp"),
    ("matcher_backend: cuda", "expected auto|xla|pallas|pallas-interpret"),
])
def test_mesh_keys_are_checked_as_jax_checks_them(text, match):
    with pytest.raises(ValueError, match=match):
        jax_schema.config_from_yaml_text(text)
    with pytest.raises(ValueError, match=match):
        config_from_yaml_text(text)


@pytest.mark.parametrize("backend", ["xla", "pallas-interpret"])
def test_jax_only_backends_fail_the_load(backend):
    """JAX loads them; the port would run its plain versions on the card."""
    text = f"matcher_backend: {backend}"
    assert jax_schema.config_from_yaml_text(text).matcher_backend == backend
    with pytest.raises(ValueError, match="plain PyTorch versions on the card"):
        config_from_yaml_text(text)
