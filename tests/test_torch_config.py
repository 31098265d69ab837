"""The port's config loader against the JAX schema: the deploy file loads,
every key the JAX schema reads and the port does not is named (one
warning, `Config.not_ported`), the service's keys are read with the JAX
defaults and checks, and `http_workers` other than 0 is refused."""

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


def test_deploy_file_names_exactly_the_keys_the_port_does_not_read(caplog):
    text = DEPLOY.read_text()
    in_file = set(yaml.safe_load(text))
    expected = sorted(k for k in in_file if k in _jax_keys() - _port_read_keys())
    with caplog.at_level(logging.WARNING, logger="banjax_tpu_torch.config"):
        cfg = config_from_yaml_text(text)
    assert cfg.not_ported == expected
    assert {"serve_fastpath_enabled", "server_log_file", "banning_log_file"}.isdisjoint(expected)
    assert {"ipset_netlink_enabled", "breaker_failure_threshold", "matcher_backend",
            "failpoints_admin_enabled", "kafka_command_topic"} <= set(expected)
    warnings = [r.getMessage() for r in caplog.records if "not ported" in r.getMessage()]
    assert warnings == ["not ported: " + ", ".join(expected)]


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
    ("http_workers: 2", "http_workers"),
    ("http_workers: -1", "http_workers"),
    ("serve_decision_table_capacity: 0", "serve_decision_table_capacity"),
    ("http_fast_path: 1", "http_fast_path"),
    ("kafka_brokers: kafka:9092", "kafka_brokers"),
    ("server_log_file: 7", "server_log_file"),
])
def test_service_keys_are_checked(text, match):
    with pytest.raises(ValueError, match=match):
        config_from_yaml_text(text)
