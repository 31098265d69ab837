"""The service's log path as a whole: the port's `BanjaxApp(device="cpu")`
against the JAX package's `BanjaxApp` (`matcher: tpu`, `matcher_backend:
xla`), both tailing one access log — the tailer and `_consume_lines`
only, no HTTP.

The same seeded lines are appended batch by batch; after each batch the
test waits until both tailers have consumed it, so the two apps see the
same batches whatever one read returns. Across a rotation, a truncation
and a `reload()` with a changed rule (the matcher is rebuilt in both:
the generation moves), the two ban logs must stay byte-identical, and so
must the window states. The JAX app runs with its ipset off
(`init_ipset` returns None, as in standalone testing)."""

import os
import random
import threading
import time

import pytest
import yaml

from banjax_tpu import cli as jax_cli
from banjax_tpu_torch import workload
from banjax_tpu_torch.cli import BanjaxApp, RegexStatesView
from tests.differential.test_tpu_matcher import CONFIG_YAML
from tests.test_torch_matcher import _one_torch_thread  # noqa: F401

APP_KEYS = """
matcher: tpu
matcher_backend: xla
matcher_device_windows: true
matcher_prefilter: true
pallas_single_kernel: "on"
matcher_native_parse: false
slotmgr_native: false
traffic_sketch_enabled: false
matcher_max_line_len: 128
matcher_prefilter_cand_frac: 0.25
matcher_batch_lines: 128
iptables_ban_seconds: 10
kafka_brokers: ["localhost:9092"]
disable_kafka: true
challenge_device_verify: false
"""


def _config(tmp_path, name, log_path, hits=2):
    cfg = yaml.safe_load(CONFIG_YAML)
    extra = yaml.safe_load(workload.rules_config(workload.generate_rules(8, seed=31), seed=3))
    cfg["regexes_with_rates"] += extra["regexes_with_rates"]
    cfg["regexes_with_rates"][0]["hits_per_interval"] = hits
    cfg.update(yaml.safe_load(APP_KEYS))
    cfg.update(server_log_file=str(log_path),
               banning_log_file=str(tmp_path / f"{name}-bans.log"),
               metrics_log_file=str(tmp_path / f"{name}-metrics.log"))
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _lines(now, n, seed):
    """Offenders crossing their thresholds, allowlisted and skipped hosts,
    per-site rules, stale and unparseable lines, generated-rule attacks,
    and a run of candidates."""
    rng = random.Random(seed)
    pats = workload.generate_rules(8, seed=31)
    out = []
    for i in range(n):
        ip = f"10.1.{rng.randrange(3)}.{rng.randrange(8)}"
        ts = now - 4 + 3 * i / n
        kind = rng.random()
        if kind < 0.05:
            rest = "POST example.com POST /submit HTTP/1.1 ua -"
        elif kind < 0.12:
            rest = f"GET example.com GET /page{i % 5} HTTP/1.1 ua -"
        elif kind < 0.15:
            rest = "GET per-site.com GET /blockme HTTP/1.1 ua -"
        elif kind < 0.17:
            rest = "DELETE skipme.com DELETE /x HTTP/1.1 ua -"
        elif kind < 0.19:
            ip, rest = "12.12.12.12", "GET example.com GET /allowed HTTP/1.1 ua -"
        elif kind < 0.25:
            rest = workload.synthesize_match(pats[rng.randrange(len(pats))], rng)
        else:
            rest = f"GET news.net GET /benign/{i % 11} HTTP/1.1 Mozilla/5.0 -"
        out.append(f"{ts:f} {ip} {rest}")
    out[3] = "short garbage"
    out[5] = f"{now - 100:f} 10.9.9.9 GET example.com GET /old HTTP/1.1 ua -"
    return out


class _Counted:
    """Wraps a tailer's on_lines to count the lines it consumed."""

    def __init__(self, app):
        self.inner = app.tailer.on_lines
        self.n = 0
        self.lock = threading.Lock()
        app.tailer.on_lines = self

    def __call__(self, batch):
        self.inner(batch)
        with self.lock:
            self.n += len(batch)


@pytest.fixture()
def apps(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_cli, "init_ipset", lambda *a, **k: None)
    log_path = tmp_path / "access.log"
    log_path.write_text("")
    jax_app = jax_cli.BanjaxApp(str(_config(tmp_path, "jax", log_path)))
    port_app = BanjaxApp(str(_config(tmp_path, "port", log_path)), device="cpu")
    counts = (_Counted(jax_app), _Counted(port_app))
    try:
        jax_app.tailer.start()
        port_app.start_workers()
        assert jax_app.tailer.opened.wait(10) and port_app.tailer.opened.wait(10)
        yield tmp_path, log_path, jax_app, port_app, counts
    finally:
        port_app.shutdown()
        jax_app.shutdown()


def _wait_consumed(counts, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(c.n >= n for c in counts):
            return
        time.sleep(0.02)
    pytest.fail(f"tailers consumed {[c.n for c in counts]} of {n} lines")


def _same_ban_logs(tmp_path, jax_app, port_app, tag):
    jax_bans = (tmp_path / "jax-bans.log").read_text()
    port_bans = (tmp_path / "port-bans.log").read_text()
    assert port_bans == jax_bans, tag
    assert RegexStatesView(port_app).format_states() == \
        jax_cli.RegexStatesView(jax_app).format_states(), tag
    assert port_app.tailer.errors == 0, (tag, port_app.tailer.last_error)
    return jax_bans.count("\n")


def test_tailed_ban_logs_are_identical_across_rotation_truncation_and_reload(apps):
    tmp_path, log_path, jax_app, port_app, counts = apps
    total, bans = 0, []

    def write(seed, n=180):
        nonlocal total
        lines = _lines(time.time(), n, seed)
        with open(log_path, "a") as f:
            f.write("\n".join(lines) + "\n")
        total += n
        _wait_consumed(counts, total)

    write(1)
    bans.append(_same_ban_logs(tmp_path, jax_app, port_app, "first batch"))
    # rotation: the old file is renamed away, a new one takes its name
    os.replace(log_path, str(log_path) + ".1")
    log_path.write_text("")
    write(2)
    bans.append(_same_ban_logs(tmp_path, jax_app, port_app, "after rotation"))
    # truncation in place: wait until both tailers have reopened
    jax_app.tailer.opened.clear()
    port_app.tailer.opened.clear()
    log_path.write_text("")
    assert jax_app.tailer.opened.wait(10) and port_app.tailer.opened.wait(10)
    write(3)
    bans.append(_same_ban_logs(tmp_path, jax_app, port_app, "after truncation"))
    # reload with a changed rule: both rebuild their matcher
    gens = (jax_app._matcher_generation, port_app._matcher_generation)
    for name, app in (("jax", jax_app), ("port", port_app)):
        _config(tmp_path, name, log_path, hits=1)
        app.reload()
    write(4)
    assert (jax_app._matcher_generation, port_app._matcher_generation) == \
        (gens[0] + 1, gens[1] + 1) == (1, 1)
    bans.append(_same_ban_logs(tmp_path, jax_app, port_app, "after reload"))
    assert bans[0] > 0 and bans[1] > bans[0] and bans[2] > bans[1] and bans[3] > bans[2], bans
    assert port_app.health.snapshot()["status"] == "healthy"
