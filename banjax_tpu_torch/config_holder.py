"""Hot-reloadable config holder (a copy of `banjax_tpu/config/holder.py`).

Reference behavior (Go banjax): internal/config_holder.go:27-161 — an
atomically swapped, immutable Config snapshot. `reload()` re-reads the
file and keeps `restart_time`; a load embeds the two challenge pages,
applies the `-debug` flag and the standalone-testing overrides (Kafka
off, the log paths swapped to the testing files) and requires
`server_log_file`, `iptables_ban_seconds` and `kafka_brokers`.

Assigning an object reference is atomic under the interpreter lock, so
`get()` needs no lock: a caller takes one snapshot per request or batch
and uses only that. `generation` moves on every successful reload; the
app rebuilds its matcher when it sees a new one. A reload that fails
raises and leaves the old snapshot and generation in place.
"""

from __future__ import annotations

import socket
import threading
import time

from banjax_tpu_torch.config import Config, config_from_yaml_text, load_pages


def default_hostname() -> str:
    try:
        return socket.gethostname()
    except OSError:
        return "unknown-hostname"


def _load_config(path: str, restart_time: int, standalone_testing: bool, debug: bool) -> Config:
    """config_holder.go load() (:68-161)."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    config = config_from_yaml_text(text, standalone_testing_default=standalone_testing)
    config.restart_time = restart_time
    config.reload_time = int(time.time())
    config.hostname = default_hostname()
    load_pages(config)
    if not config.debug and debug:
        config.debug = True
    if config.standalone_testing:
        # config_holder.go:139-145: the process hosts itself for tests
        config.disable_kafka = True
        config.server_log_file = "testing-log-file.txt"
        config.banning_log_file = "banning-log-file.txt"
    if not config.server_log_file:
        raise ValueError("config needs server_log_file")
    if not config.iptables_ban_seconds:
        raise ValueError("config needs iptables_ban_seconds")
    if not config.kafka_brokers:
        raise ValueError("config needs kafka_brokers")
    return config


class ConfigHolder:
    """Snapshot holder; `get()` returns the latest Config."""

    def __init__(self, path: str, standalone_testing: bool = False, debug: bool = False):
        self._path = path
        self._lock = threading.Lock()  # serialises reloads, not reads
        self._config = _load_config(path, int(time.time()), standalone_testing, debug)
        self.generation = 0

    @property
    def path(self) -> str:
        return self._path

    def get(self) -> Config:
        return self._config

    def reload(self) -> None:
        """Re-read the file, keeping restart_time (config_holder.go:55-66)."""
        with self._lock:
            old = self._config
            self._config = _load_config(
                self._path, old.restart_time, old.standalone_testing, old.debug
            )
            self.generation += 1
