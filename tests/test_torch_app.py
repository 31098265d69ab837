"""The service's log path as a whole: the port's `BanjaxApp(device="cpu")`
against the JAX package's `BanjaxApp` (`matcher: tpu`, its XLA scan:
`matcher_backend: auto` on the CPU), both tailing one access log — the tailer and `_consume_lines`
only, no HTTP.

The same seeded lines are appended batch by batch; after each batch the
test waits until both tailers have consumed it, so the two apps see the
same batches whatever one read returns. Across a rotation, a truncation
and a `reload()` with a changed rule (the matcher is rebuilt in both:
the generation moves), the two ban logs must stay byte-identical, and so
must the window states. The JAX app runs with its ipset off
(`init_ipset` returns None, as in standalone testing)."""

import io
import json
import os
import random
import threading
import time

import pytest
import yaml

from banjax_tpu import cli as jax_cli
from banjax_tpu_torch import cli as port_cli
from banjax_tpu_torch import workload
from banjax_tpu_torch.cli import BanjaxApp, RegexStatesView
from tests.differential.test_tpu_matcher import CONFIG_YAML
from tests.test_torch_matcher import _one_torch_thread  # noqa: F401
from tests.test_torch_obs import obs_reset  # noqa: F401


@pytest.fixture(autouse=True)
def _port_ipset_off(monkeypatch):
    """The port's app creates the kernel's ipset outside standalone
    testing; here it runs with its ipset off, as the JAX app does
    (`init_ipset` returns None). tests/test_torch_ipset.py covers the
    kernel edge."""
    monkeypatch.setattr(port_cli, "init_ipset", lambda *a, **k: None)


# (no matcher_backend: the JAX "auto" is its XLA scan on the CPU, and the
# port refuses "xla")
APP_KEYS = """
matcher: tpu
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


# ------------------------------------------------- the observability plane

# values that depend on time or on where the tailer and the sizer cut
# batches, which the two apps need not do alike
_TIMED = ("Time", "PerSec", "Ms", "Latency", "Ewma", "Utilization", "Skew", "Age", "Target",
          "Batches", "Buffered", "Inflight")


def _deterministic(values):
    return {k: v for k, v in values.items() if not any(t in k for t in _TIMED)}


def _prom(text, parse):
    """{(family, sample, labels): value} of the deterministic samples."""
    out = {}
    for fam, ent in parse(text).items():
        if ent["type"] == "histogram" or any(t.lower() in fam for t in
                                              ("seconds", "ms", "batches", "target", "buffered",
                                               "inflight", "utilization", "skew", "fraction")):
            continue
        for name, labels, value in ent["samples"]:
            out[(fam, name, tuple(sorted(labels.items())))] = value
    return out


def test_observability_agrees_with_the_jax_app(tmp_path, monkeypatch):
    """Both apps pipelined, tracing on, tailing one log: the metrics line's
    and /metrics' deterministic values (the "matcher-single-kernel" health
    component's among them), the provenance records and the span tree of
    every batch agree, and the JAX keys the port leaves out are exactly
    the documented ones."""
    from banjax_tpu.obs import exposition as jax_expo
    from banjax_tpu.obs import metrics as jax_metrics
    from banjax_tpu.obs import provenance as jax_prov
    from banjax_tpu.obs import trace as jax_trace
    from banjax_tpu_torch.obs import exposition as port_expo
    from banjax_tpu_torch.obs import metrics as port_metrics
    from banjax_tpu_torch.obs import provenance as port_prov
    from banjax_tpu_torch.obs import registry as port_reg
    from banjax_tpu_torch.obs import trace as port_trace
    from tests.test_torch_obs import DIFFERENT_MEANING
    from tests.test_torch_pipeline import _app_config, _Drained, pipeline_lines

    monkeypatch.setattr(jax_cli, "init_ipset", lambda *a, **k: None)
    log_path = tmp_path / "access.log"
    log_path.write_text("")
    apps = []
    for name in ("jax", "port"):
        path = _app_config(tmp_path, name, log_path)
        cfg = yaml.safe_load(path.read_text())
        cfg.update(trace_enabled=True, slo_sample_seconds=0)
        path.write_text(yaml.safe_dump(cfg))
        apps.append(jax_cli.BanjaxApp(str(path)) if name == "jax"
                    else BanjaxApp(str(path), device="cpu"))
    jax_app, port_app = apps
    drained = (_Drained(jax_app.pipeline), _Drained(port_app.pipeline))
    tailed = (_Counted(jax_app), _Counted(port_app))
    try:
        jax_app.pipeline.start()
        jax_app.tailer.start()
        port_app.start_workers()
        assert jax_app.tailer.opened.wait(10) and port_app.tailer.opened.wait(10)
        total = 0
        for step in range(4):
            batch = pipeline_lines(time.time() + 60, 120, seed=60 + step, span=3.0)
            with open(log_path, "a") as f:
                f.write("\n".join(batch) + "\n")
            total += len(batch)
            _wait_consumed(tailed, total)
            _wait_consumed(drained, total)
        assert (tmp_path / "port-bans.log").read_text() == (tmp_path / "jax-bans.log").read_text()

        # the metrics line
        lines = []
        for write, app, view, extra in (
            (jax_metrics.write_metrics_line, jax_app, jax_cli.RegexStatesView(jax_app),
             (jax_app._matcher, None, jax_app.health, jax_app.pipeline)),
            (port_metrics.write_metrics_line, port_app, RegexStatesView(port_app),
             (port_app._matcher, port_app.health, port_app.pipeline, port_app.serve_stats,
              port_app.ipset_stats)),
        ):
            out = io.StringIO()
            write(out, app.dynamic_lists, view, app.failed_challenge_states, *extra)
            lines.append(json.loads(out.getvalue()))
        jax_line, port_line = lines
        assert all(port_reg.is_declared_line_key(k) for k in port_line)
        assert set(port_line) <= set(jax_line)
        assert set(jax_line) - set(port_line) == DIFFERENT_MEANING & set(jax_line)
        assert port_line["Health_matcher-single-kernel"] == \
            jax_line["Health_matcher-single-kernel"]
        assert _deterministic(port_line) == {k: v for k, v in _deterministic(jax_line).items()
                                             if k in port_line}
        assert port_line["MatcherLinesTotal"] == total == port_line["PipelineAdmittedLines"]

        # /metrics, each parsed by both strict parsers
        texts = (jax_app._render_metrics_text(), port_app.render_metrics_text())
        parsed = [[_prom(t, parse) for parse in (jax_expo.parse_text_format,
                                                  port_expo.parse_text_format)] for t in texts]
        assert parsed[0][0] == parsed[0][1] and parsed[1][0] == parsed[1][1]
        jax_prom, port_prom = parsed[0][0], parsed[1][0]
        fams = port_expo.parse_text_format(texts[1])
        assert set(fams) <= set(port_reg.PROM_FAMILIES)
        assert port_prom == {k: v for k, v in jax_prom.items() if k[0] in fams}
        assert any(("component", "matcher-single-kernel") in k[2] for k in port_prom)
        assert port_prom[("banjax_matcher_lines_total", "banjax_matcher_lines_total", ())] == total

        # the provenance records and the span tree of every batch
        def records(pv):
            return sorted((r["source"], r["ip"], r["decision"], r["rule"], r["rule_index"],
                           r["hits"]) for r in pv.get_ledger().tail(100_000))

        assert records(port_prov) == records(jax_prov)
        assert any(r[0] == "rate_limit" for r in records(port_prov))
        trees = []
        for tr, pv in ((jax_trace, jax_prov), (port_trace, port_prov)):
            spans = tr.get_tracer().snapshot()
            ids = {s["span_id"]: s["name"] for s in spans}
            by_trace = {}
            for s in spans:
                if s["trace_id"] and s["dur_us"] is not None:
                    by_trace.setdefault(s["trace_id"], set()).add(
                        (s["name"], ids.get(s["parent_id"], "")))
            for edges in by_trace.values():
                assert {("admission", ""), ("encode", "admission"), ("submit", "admission"),
                        ("collect", "admission"), ("drain", "admission"),
                        ("program-ab-fused", "submit")} <= edges
            # each rate-limit ban names a batch the ring holds
            for r in pv.get_ledger().tail(100_000):
                if r["source"] == "rate_limit":
                    assert r["trace_id"] in by_trace
            trees.append(set().union(*by_trace.values()))
        assert trees[0] == trees[1]
    finally:
        port_app.shutdown()
        jax_app.shutdown()
