"""The port's log tailer and config holder.

The tailer's no-drop, no-duplicate contract under rotation mid-burst, an
unterminated last line, truncation, a file that appears late, bounded
reads, and an `on_lines` that raises (counted, health failed, the tailer
alive) — the cases of `tests/faults/test_tailer_rotation.py` and
`test_tailer_faults.py` on the port's `LogTailer`. The holder: the
generation moves on a reload, a failed reload keeps the snapshot, and
the required-key errors are the JAX holder's, text for text.

Every wait has its own deadline; every tailer is stopped."""

import os
import threading
import time

import pytest
import yaml

from banjax_tpu.config.holder import ConfigHolder as JaxHolder
from banjax_tpu_torch.config_holder import ConfigHolder
from banjax_tpu_torch.ingest import tailer as tailer_mod
from banjax_tpu_torch.ingest.tailer import LogTailer
from banjax_tpu_torch.resilience.backoff import Backoff
from banjax_tpu_torch.resilience.health import HealthRegistry


class _Sink:
    def __init__(self, fail_on=None):
        self._lock = threading.Lock()
        self.lines = []
        self.batches = []
        self.fail_on = fail_on

    def __call__(self, batch):
        if self.fail_on is not None and self.fail_on in batch:
            raise RuntimeError(f"bad batch with {self.fail_on}")
        with self._lock:
            self.lines.extend(batch)
            self.batches.append(list(batch))

    def snapshot(self):
        with self._lock:
            return list(self.lines)

    def wait_for(self, n, timeout=10.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.snapshot()) >= n:
                return True
            time.sleep(0.01)
        return False


def _fast_backoff():
    return Backoff(base=0.01, cap=0.05, jitter=0.0)


@pytest.fixture()
def follow(tmp_path):
    tailers = []

    def start(sink, create=True, health=None):
        path = str(tmp_path / "access.log")
        if create:
            open(path, "w").close()
        t = LogTailer(path, sink, backoff=_fast_backoff(), health=health)
        t.start()
        tailers.append(t)
        if create:
            assert t.opened.wait(5)
        return path, t

    yield start
    for t in tailers:
        t.stop()
        assert not t._thread.is_alive()


def test_rotation_mid_burst_loses_no_bytes(follow):
    sink = _Sink()
    path, _ = follow(sink)
    with open(path, "a") as f:
        f.write("alpha\nbravo\n")
    assert sink.wait_for(2)
    # appended and rotated at once: the tailer has not read these yet
    with open(path, "a") as f:
        f.write("charlie\ndelta\n")
    os.replace(path, path + ".1")
    with open(path, "a") as f:
        f.write("echo\n")
    assert sink.wait_for(5), sink.snapshot()
    time.sleep(0.15)
    assert sink.snapshot() == ["alpha", "bravo", "charlie", "delta", "echo"]


def test_rotation_delivers_the_unterminated_last_line(follow):
    sink = _Sink()
    path, _ = follow(sink)
    with open(path, "a") as f:
        f.write("first\nsecond-no-newline")
    os.replace(path, path + ".1")
    with open(path, "a") as f:
        f.write("third\n")
    assert sink.wait_for(3), sink.snapshot()
    assert sink.snapshot() == ["first", "second-no-newline", "third"]


def test_truncation_reopens_from_the_start(follow):
    sink = _Sink()
    path, t = follow(sink)
    with open(path, "a") as f:
        f.write("one\ntwo\n")
    assert sink.wait_for(2)
    t.opened.clear()
    with open(path, "w") as f:  # copytruncate
        f.write("3\n")
    assert sink.wait_for(3), sink.snapshot()
    assert t.opened.wait(5)
    assert sink.snapshot() == ["one", "two", "3"]


def test_a_file_that_appears_late_is_followed(follow, tmp_path):
    sink = _Sink()
    health = HealthRegistry()
    comp = health.register("tailer")
    path, t = follow(sink, create=False, health=comp)
    time.sleep(0.1)
    assert not t.opened.is_set()
    assert health.snapshot()["components"]["tailer"]["status"] == "degraded"
    assert t.backoff.attempt > 0
    with open(path + ".new", "w") as f:
        f.write("before-open\n")
    os.replace(path + ".new", path)  # whole before the first open: skipped (from EOF)
    assert t.opened.wait(5)
    with open(path, "a") as f:
        f.write("after-open\n")
    assert sink.wait_for(1)
    assert sink.snapshot() == ["after-open"]
    assert t.backoff.attempt == 0
    assert health.snapshot()["status"] == "healthy"


def test_reads_are_bounded(follow, monkeypatch):
    monkeypatch.setattr(tailer_mod, "READ_CHUNK_BYTES", 64)
    sink = _Sink()
    path, _ = follow(sink)
    lines = [f"line-{i:04d}-" + "x" * 20 for i in range(40)]
    with open(path, "a") as f:
        f.write("\n".join(lines) + "\n")
    assert sink.wait_for(len(lines)), len(sink.snapshot())
    assert sink.snapshot() == lines
    assert len(sink.batches) >= 10
    assert max(sum(len(x) + 1 for x in b) for b in sink.batches) <= 64 + 31


def test_a_failing_batch_is_counted_and_the_tailer_lives_on(follow):
    sink = _Sink(fail_on="poison")
    health = HealthRegistry()
    comp = health.register("tailer")
    path, t = follow(sink, health=comp)
    with open(path, "a") as f:
        f.write("ok-1\n")
    assert sink.wait_for(1)
    with open(path, "a") as f:
        f.write("poison\n")
    deadline = time.monotonic() + 5
    while t.errors == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert t.errors == 1 and isinstance(t.last_error, RuntimeError)
    snap = health.snapshot()
    assert snap["status"] == "failed" and "RuntimeError" in snap["components"]["tailer"]["detail"]
    with open(path, "a") as f:
        f.write("ok-2\n")
    assert sink.wait_for(2)
    assert sink.snapshot() == ["ok-1", "ok-2"]
    assert t.lines_delivered == 2 and t._thread.is_alive()


def _write_config(path, **over):
    keys = {
        "server_log_file": "/var/log/banjax/banjax-format.log",
        "iptables_ban_seconds": 10,
        "kafka_brokers": ["localhost:9092"],
        "config_version": "v1",
    }
    keys.update(over)
    path.write_text(yaml.safe_dump({k: v for k, v in keys.items() if v is not None}))


def test_holder_generation_and_a_failed_reload(tmp_path):
    cfg = tmp_path / "c.yaml"
    _write_config(cfg)
    h = ConfigHolder(str(cfg))
    first = h.get()
    assert (h.generation, first.config_version, h.path) == (0, "v1", str(cfg))
    assert first.challenger_bytes and first.password_page_bytes and first.hostname
    _write_config(cfg, config_version="v2")
    h.reload()
    assert (h.generation, h.get().config_version) == (1, "v2")
    assert h.get().restart_time == first.restart_time
    cfg.write_text("regexes_with_rates:\n  - {rule: r, regex: '(', interval: 1}\n")
    with pytest.raises(ValueError):
        h.reload()
    assert (h.generation, h.get().config_version) == (1, "v2")


def test_holder_debug_and_standalone_overrides(tmp_path):
    cfg = tmp_path / "c.yaml"
    _write_config(cfg, server_log_file="a.log", banning_log_file="b.log")
    c = ConfigHolder(str(cfg), standalone_testing=True, debug=True).get()
    j = JaxHolder(str(cfg), standalone_testing=True, debug=True).get()
    for key in ("debug", "standalone_testing", "disable_kafka", "server_log_file",
                "banning_log_file", "challenger_bytes", "password_page_bytes"):
        assert getattr(c, key) == getattr(j, key), key


@pytest.mark.parametrize("missing", ["server_log_file", "iptables_ban_seconds", "kafka_brokers"])
def test_holder_required_keys_fail_with_the_jax_texts(tmp_path, missing):
    cfg = tmp_path / "c.yaml"
    _write_config(cfg, **{missing: None})
    with pytest.raises(ValueError) as jax_err:
        JaxHolder(str(cfg))
    with pytest.raises(ValueError) as port_err:
        ConfigHolder(str(cfg))
    assert str(port_err.value) == str(jax_err.value) == f"config needs {missing}"
