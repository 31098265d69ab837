"""The Kafka channel of the port (`banjax_tpu_torch/ingest/kafka_wire.py`,
`kafka_io.py`, `reports.py` and the app's reader, writer and heartbeat)
against the JAX package's:

- the wire codecs byte for byte on seeded inputs (crc32c, varints,
  message set v1, record batch v2, snappy, lz4 and xxh32, gzip batches,
  the pre-encoded fixtures);
- `WireKafkaTransport` against `tests/fake_kafka_broker.py` in both
  protocol ladders (and mTLS where `openssl` exists): produce, then fetch
  from the last offset, gives the JAX transport's messages;
- `dispatch_raw` over a seeded command stream (the four names, per-site
  TTL overrides with the reference's swapped defaults, escaped session
  ids, malformed messages) into both packages' lists: identical entries
  and provenance records, the clock pinned;
- lines and commands interleaved through both schedulers' command lane:
  identical lists, bans and ban log;
- the reader's backoff and health and the writer's held report, as
  `tests/faults/test_kafka_faults.py` drives the JAX loops;
- the port's `BanjaxApp` against the fake broker: commands into its
  lists, chain reports and the status heartbeat onto the report topic,
  and a stop that joins at once against a broker that is not there.
"""

import json
import queue
import random
import ssl
import threading
import time
import types
from pathlib import Path

import pytest
import yaml

from banjax_tpu.config.schema import config_from_yaml_text as jax_config
from banjax_tpu.decisions.dynamic_lists import DynamicDecisionLists as JaxLists
from banjax_tpu.ingest import kafka_io as jax_io
from banjax_tpu.ingest import kafka_wire as jax_wire
from banjax_tpu.ingest import reports as jax_reports
from banjax_tpu.obs import provenance as jax_prov
from banjax_tpu.resilience.backoff import Backoff as JaxBackoff
from banjax_tpu.resilience.health import HealthRegistry as JaxHealth
from banjax_tpu_torch import cli as port_cli
from banjax_tpu_torch.config import config_from_yaml_text
from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
from banjax_tpu_torch.ingest import kafka_io as port_io
from banjax_tpu_torch.ingest import kafka_wire as port_wire
from banjax_tpu_torch.ingest import reports as port_reports
from banjax_tpu_torch.obs import provenance as port_prov
from banjax_tpu_torch.resilience.backoff import Backoff
from banjax_tpu_torch.resilience.health import HealthRegistry
from tests.fake_kafka_broker import FakeKafkaBroker
from tests.test_torch_matcher import _one_torch_thread  # noqa: F401
from tests.test_torch_obs import obs_reset  # noqa: F401
from tests.unit.test_kafka_wire import SNAPPY_FIXTURE, _make_certs, _record_batch_with_codec

NOW = 1_790_000_000.5
PKGS = {"port": (port_wire, port_io, config_from_yaml_text, DynamicDecisionLists, port_prov),
        "jax": (jax_wire, jax_io, jax_config, JaxLists, jax_prov)}


@pytest.fixture(autouse=True)
def _clean_module_state():
    """The skip counters and the report queues are module state of both
    packages: start and end empty."""
    def clean():
        for wire, rep in ((port_wire, port_reports), (jax_wire, jax_reports)):
            wire.reset_skipped_batches()
            q = rep.get_message_queue()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
    clean()
    yield
    clean()


def _config_text(port=0, **extra):
    text = ("kafka_command_topic: cmds\nkafka_report_topic: reps\n"
            f"kafka_brokers:\n  - 127.0.0.1:{port}\nkafka_max_wait_ms: 50\n"
            "expiring_decision_ttl_seconds: 30\nblock_ip_ttl_seconds: 600\n"
            "block_session_ttl_seconds: 900\n"
            "sites_to_block_ip_ttl_seconds: {a.example: 77}\n"
            "sites_to_block_session_ttl_seconds: {b.example: 88}\n"
            "sites_to_disable_baskerville: {off.example: true}\n")
    for k, v in extra.items():
        text += f"{k}: {json.dumps(v)}\n"
    return text


# ------------------------------------------------------------ the codecs


def _seeded_payloads(seed, n=24):
    rng = random.Random(seed)
    out = [b"", b"a", b"abcd" * 40, bytes(range(256)) * 3]
    for _ in range(n):
        k = rng.randrange(1, 3000)
        alphabet = bytes(rng.sample(range(256), rng.randrange(2, 40)))
        out.append(bytes(rng.choice(alphabet) for _ in range(k)))
    return out


CODECS = {
    "crc32c": lambda w, p: w.crc32c(p),
    "xxh32": lambda w, p: (w.xxh32(p), w.xxh32(p, seed=7)),
    "varint": lambda w, p: [w._varint(v) for v in (0, 1, -1, 63, -64, len(p), -len(p), 2**31, 2**40)],
    "message_set_v1": lambda w, p: w._encode_message_set_v1(p, 1_700_000_000_123, offset=len(p)),
    "record_batch_v2": lambda w, p: w._encode_record_batch_v2(p, 1_700_000_000_123, offset=len(p)),
    "snappy": lambda w, p: (w.snappy_compress(p), w.snappy_decompress(w.snappy_compress(p))),
    "lz4": lambda w, p: (w.lz4_compress(p), w.lz4_decompress(w.lz4_compress(p))),
    "decode_v2": lambda w, p: w._decode_record_batches(w._encode_record_batch_v2(p, 5, offset=3)),
    "decode_v1": lambda w, p: w._decode_message_set(w._encode_message_set_v1(p, 5, offset=3)),
}


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_codec_is_byte_identical_to_jax(codec):
    fn = CODECS[codec]
    for p in _seeded_payloads(seed=len(codec)):
        assert fn(port_wire, p) == fn(jax_wire, p), (codec, p[:16])


def _gzip_batch():
    import gzip
    import struct

    body = (b"\x00" + port_wire._varint(0) + port_wire._varint(0) + port_wire._varint(-1)
            + port_wire._varint(6) + b"zipped" + port_wire._varint(0))
    after_crc = (struct.pack(">hiqqqhii", 1, 0, 0, 0, -1, -1, -1, 1)
                 + gzip.compress(port_wire._varint(len(body)) + body, mtime=0))
    batch = struct.pack(">ibI", -1, 2, port_wire.crc32c(after_crc)) + after_crc
    return struct.pack(">qi", 0, len(batch)) + batch


def test_fixtures_and_compressed_batches_decode_as_jax():
    """The pre-encoded snappy block, gzip/snappy/lz4/zstd record batches and
    a corrupt batch: the same records, and the same skipped-batch count."""
    cases = [
        _gzip_batch(),
        _record_batch_with_codec(port_wire.snappy_compress(b"x" * 10), 2, 0),
        _record_batch_with_codec(b"\x00" * 8, 4),  # zstd: skipped and counted
        _record_batch_with_codec(b"\xff\xff\xff", 2),  # corrupt snappy
        _record_batch_with_codec(b"\x04\x22\x4d\x18garbage", 3),  # corrupt lz4
    ]
    got = {}
    for name, (wire, *_rest) in PKGS.items():
        wire.reset_skipped_batches()
        got[name] = ([wire._decode_record_batches(c) for c in cases],
                     wire.snappy_decompress(SNAPPY_FIXTURE), wire.skipped_batch_count())
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == [(0, b"zipped")] and got["port"][2] == 3


# ------------------------------------------------------------ the transport


def _produce_then_fetch(wire, cfg_fn, broker, n, tag):
    cfg = cfg_fn(_config_text(broker.port))
    tx = wire.WireKafkaTransport()
    try:
        stream = tx.read_messages(cfg, "cmds", 0)  # positions at the LAST offset
        for i in range(n):
            tx.send(cfg, "cmds", f"{tag}-{i}".encode())
        got = [next(stream) for _ in range(n)]
    finally:
        tx.close()
    return got


@pytest.mark.parametrize("mode", ["legacy", "modern"])
def test_transport_produce_then_fetch_matches_jax(mode):
    broker = FakeKafkaBroker(mode=mode, n_partitions=1).start()
    try:
        broker.append("cmds", 0, b"before-the-reader")  # never read: LAST offset
        jax_got = _produce_then_fetch(jax_wire, jax_config, broker, 5, "m")
        port_got = _produce_then_fetch(port_wire, config_from_yaml_text, broker, 5, "m")
    finally:
        broker.stop()
    assert port_got == jax_got == [f"m-{i}".encode() for i in range(5)]
    assert broker.logs[("cmds", 0)] == [b"before-the-reader"] + jax_got + port_got


def test_transport_round_robins_partitions_as_jax():
    sent = {}
    for name, (wire, _io, cfg_fn, *_r) in PKGS.items():
        broker = FakeKafkaBroker(mode="modern", n_partitions=3).start()
        try:
            tx = wire.WireKafkaTransport()
            for i in range(7):
                tx.send(cfg_fn(_config_text(broker.port)), "reps", f"r{i}".encode())
            tx.close()
            sent[name] = {k: v for k, v in broker.logs.items()}
        finally:
            broker.stop()
    assert sent["port"] == sent["jax"] and len(sent["port"]) == 3


def test_mtls_transport_as_jax(tmp_path):
    certs = _make_certs(tmp_path)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certs / "server.pem", certs / "server.key")
    ctx.load_verify_locations(certs / "ca.pem")
    ctx.verify_mode = ssl.CERT_REQUIRED
    broker = FakeKafkaBroker(mode="modern", ssl_context=ctx).start()
    tls = dict(kafka_security_protocol="ssl", kafka_ssl_ca=str(certs / "ca.pem"))
    mtls = dict(tls, kafka_ssl_cert=str(certs / "client.pem"),
                kafka_ssl_key=str(certs / "client.key"))
    try:
        for name, (wire, _io, cfg_fn, *_r) in PKGS.items():
            tx = wire.WireKafkaTransport()
            tx.send(cfg_fn(_config_text(broker.port, **mtls)), "reps", name.encode())
            tx.close()
            with pytest.raises(ConnectionError):
                wire.WireKafkaTransport().send(cfg_fn(_config_text(broker.port, **tls)),
                                               "reps", b"no client cert")
    finally:
        broker.stop()
    assert broker.logs[("reps", 0)] == [b"port", b"jax"]


# ------------------------------------------------------------ the commands


def command_stream(seed, n):
    """Seeded Baskerville commands: the four names, hosts with per-site TTL
    overrides and a Baskerville-disabled site, session ids with escapes,
    repeats, and about 2 % malformed messages."""
    rng = random.Random(seed)
    names = ("challenge_ip", "block_ip", "challenge_session", "block_session")
    hosts = ("a.example", "b.example", "off.example", "other.example", "")
    out = []
    for i in range(n):
        r = rng.random()
        if r < 0.02:
            out.append(rng.choice([b"not json", b"[1, 2]", b'{"Name": "block_ip", "Value": "1.2"}',
                                   b'{"Name": "shrug", "Value": "9.9.9.9"}']))
            continue
        cmd = {"Name": rng.choice(names), "Value": f"77.{rng.randrange(4)}.{rng.randrange(8)}."
               f"{rng.randrange(1, 40)}", "host": rng.choice(hosts), "source": "bask"}
        if "session" in cmd["Name"]:
            cmd["session_id"] = rng.choice(["abc%2Bdef%3D", "plain", "a+b%20c", "%zz", f"s{i % 7}"])
        if rng.random() < 0.1:
            cmd["print_log"] = True
        out.append(json.dumps(cmd).encode())
    return out


def _lists_view(lists):
    ips = sorted((ip, int(e.decision), e.expires, e.from_baskerville, e.domain)
                 for ip, e in lists.format_ip_entries().items())
    sessions = sorted((sid, e.ip_address, int(e.decision), e.expires, e.from_baskerville,
                       e.domain) for sid, e in lists._by_session_id.items())
    return ips, sessions


def _prov_view(prov):
    return [(r["source"], r["ip"], r["decision"], r["rule"])
            for ip in sorted({r["ip"] for r in prov.get_ledger().tail(100000)})
            for r in prov.get_ledger().explain(ip)]


@pytest.mark.parametrize("debug", [False, True])
def test_dispatch_matches_jax(monkeypatch, debug):
    clock = types.SimpleNamespace(time=lambda: NOW)
    views = {}
    for name, (_w, io_mod, cfg_fn, lists_cls, prov) in PKGS.items():
        monkeypatch.setattr(io_mod, "time", clock)
        prov.configure(enabled=True, ring_size=1 << 16)
        cfg = cfg_fn(_config_text(debug=debug))
        lists = lists_cls(start_sweeper=False)
        reader = io_mod.KafkaReader(types.SimpleNamespace(get=lambda c=cfg: c), lists,
                                    transport=io_mod.NullTransport())
        for raw in command_stream(seed=11, n=600):
            reader.dispatch_raw(raw)
        views[name] = (_lists_view(lists), _prov_view(prov))
    assert views["port"] == views["jax"]
    ips, sessions = views["port"][0]
    # the TTL quirk: block_ip defaults to block_session_ttl_seconds and
    # block_session to block_ip_ttl_seconds; the per-site maps override
    blocks = {(dom, exp - NOW) for _, d, exp, _, dom in ips if d == 3}
    assert ("a.example", 77) in blocks and ("other.example", 900) in blocks
    session_blocks = {(dom, exp - NOW) for _, _, d, exp, _, dom in sessions if d == 3}
    assert ("b.example", 88) in session_blocks and ("other.example", 600) in session_blocks
    assert any(s[0] == "abc+def=" for s in sessions)
    # a Baskerville-disabled site is skipped only under debug
    assert any(dom == "off.example" for *_x, dom in ips) is not debug


# ------------------------------------------- lines and commands interleaved


def test_lines_and_commands_interleaved_match_jax_scheduler():
    from banjax_tpu.pipeline import scheduler as jax_sched_mod
    from banjax_tpu_torch.pipeline import scheduler as port_sched_mod
    from tests.test_torch_pipeline import (
        FIXED_NOW,
        jax_matcher,
        pipeline_lines,
        pipeline_yaml,
        port_matcher,
    )

    text = pipeline_yaml(expiring_decision_ttl_seconds=30, block_ip_ttl_seconds=600,
                         block_session_ttl_seconds=900)
    lines = pipeline_lines(FIXED_NOW, 384, seed=21)
    commands = command_stream(seed=12, n=96)
    out = {}
    for name, sched_mod, matcher, io_mod in (
            ("jax", jax_sched_mod, jax_matcher(text), jax_io),
            ("port", port_sched_mod, port_matcher(text), port_io)):
        cfg = (jax_config if name == "jax" else config_from_yaml_text)(text)
        holder = types.SimpleNamespace(get=lambda c=cfg: c)
        lists = matcher.banner.decision_lists
        reader = io_mod.KafkaReader(holder, lists, transport=io_mod.NullTransport())
        sch = sched_mod.PipelineScheduler(lambda m=matcher: m, now_fn=lambda: FIXED_NOW,
                                          latency_budget_ms=1e9, command_take_max=16)
        sch._sizer.target = lambda: 64
        for k in range(4):
            sch.submit(lines[k * 96:(k + 1) * 96])
            sch.submit_commands(commands[k * 24:(k + 1) * 24], reader.dispatch_raw)
        sch.start()
        try:
            assert sch.flush(120)
        finally:
            sch.stop()
        stats = sch.stats.peek()
        ips, sessions = _lists_view(lists)
        out[name] = (matcher.test_log.getvalue(), matcher.test_bans,
                     [(ip, d, dom) for ip, d, _e, _b, dom in ips],
                     [(s, ip, d, dom) for s, ip, d, _e, _b, dom in sessions],
                     stats["PipelineCommandItems"], stats["PipelineAdmittedLines"],
                     stats["PipelineProcessedLines"])
    assert out["port"] == out["jax"]
    assert out["port"][0].count("\n") > 0 and out["port"][4] == 96
    assert out["port"][5] == out["port"][6] == 384 + 96


# ------------------------------------------------ the loops' resilience


class _Zero(random.Random):
    def random(self):
        return 0.0


class _FlakyRead:
    """Raises on the first `fail_times` reads, then yields one command and
    parks until closed."""

    def __init__(self, fail_times):
        self.fail_times = fail_times
        self.attempts = 0
        self.delivered = threading.Event()
        self._closed = threading.Event()

    def read_messages(self, config, topic, partition):
        self.attempts += 1
        if self.attempts <= self.fail_times:
            raise ConnectionError(f"broker down (attempt {self.attempts})")
        yield b'{"Name": "challenge_ip", "Value": "1.2.3.4", "host": "h"}'
        self.delivered.set()
        while not self._closed.wait(0.02):
            pass

    def send(self, config, topic, value):
        raise ConnectionError("read-only")

    def close(self):
        self._closed.set()


def test_reader_backoff_and_health_match_jax():
    got = {}
    for name, backoff_cls, health_cls in (("port", Backoff, HealthRegistry),
                                          ("jax", JaxBackoff, JaxHealth)):
        _w, io_mod, cfg_fn, lists_cls, _p = PKGS[name]
        sleeps = []
        backoff = backoff_cls(base=1.0, cap=4.0, factor=2.0, jitter=0.5, rng=_Zero(),
                              sleep=lambda d, s=sleeps: (s.append(d), False)[1])
        health = health_cls()
        transport = _FlakyRead(fail_times=5)
        cfg = cfg_fn(_config_text())
        reader = io_mod.KafkaReader(types.SimpleNamespace(get=lambda c=cfg: c),
                                    lists_cls(start_sweeper=False), transport=transport,
                                    backoff=backoff, health=health.register("kafka-reader"))
        reader.start()
        assert transport.delivered.wait(5)
        status, _, _ = health.get("kafka-reader").effective_status()
        got[name] = (sleeps[:5], backoff.attempt, str(status))
        reader.stop()
    assert got["port"] == got["jax"] == ([1.0, 2.0, 4.0, 4.0, 4.0], 0, got["jax"][2])
    assert "healthy" in got["port"][2].lower()


def test_reader_health_degrades_while_reconnecting():
    health = HealthRegistry()
    cfg = config_from_yaml_text(_config_text())
    reader = port_io.KafkaReader(types.SimpleNamespace(get=lambda: cfg),
                                 DynamicDecisionLists(start_sweeper=False),
                                 transport=_FlakyRead(fail_times=10 ** 9),
                                 backoff=Backoff(base=0.01, cap=0.01, jitter=0.0),
                                 health=health.register("kafka-reader"))
    reader.start()
    deadline = time.time() + 5
    while time.time() < deadline:
        status, detail, _ = health.get("kafka-reader").effective_status()
        if "degraded" in str(status).lower():
            break
        time.sleep(0.01)
    reader.stop()
    assert "degraded" in str(status).lower() and "reconnecting" in detail


class _FlakySend(port_io.InMemoryTransport):
    def __init__(self, fail_times):
        super().__init__()
        self.fail_times = fail_times
        self.attempts = 0

    def send(self, config, topic, value):
        self.attempts += 1
        if self.attempts <= self.fail_times:
            raise ConnectionError("producer down")
        super().send(config, topic, value)


def test_writer_holds_the_report_across_send_failures_as_jax():
    """A report taken off the queue survives three send failures (and a
    `kafka.send` failpoint), in order, with the JAX writer's sleeps."""
    from banjax_tpu_torch.resilience import failpoints

    got = {}
    for name, backoff_cls, rep in (("port", Backoff, port_reports),
                                   ("jax", JaxBackoff, jax_reports)):
        _w, io_mod, cfg_fn, *_r = PKGS[name]
        sleeps = []
        transport = _FlakySend(fail_times=3)
        backoff = backoff_cls(base=0.5, cap=2.0, jitter=0.0,
                              sleep=lambda d, s=sleeps: (s.append(d), False)[1])
        cfg = cfg_fn(_config_text())
        writer = io_mod.KafkaWriter(types.SimpleNamespace(get=lambda c=cfg: c),
                                    transport=transport, backoff=backoff)
        for i in range(3):
            rep.get_message_queue().put_nowait(f"report-{i}".encode())
        if name == "port":
            failpoints.arm("kafka.send", "error", count=2)
        writer.start()
        deadline = time.time() + 5
        while len(transport.sent) < 3 and time.time() < deadline:
            time.sleep(0.01)
        writer.stop()
        failpoints.disarm()
        got[name] = (transport.sent, sleeps[:3])
    assert got["port"][0] == got["jax"][0] == [b"report-0", b"report-1", b"report-2"]
    assert got["jax"][1] == [0.5, 1.0, 2.0]
    assert got["port"][1] == [0.5, 1.0, 2.0]  # two failpoint errors, then a failed send


# ------------------------------------------------------------ the app


@pytest.fixture()
def _port_ipset_off(monkeypatch):
    monkeypatch.setattr(port_cli, "init_ipset", lambda *a, **k: None)


FIXTURE = Path(__file__).resolve().parent / "fixtures" / "banjax-config-test.yaml"


def _app_config(tmp_path, broker_port, **extra):
    cfg = yaml.safe_load(FIXTURE.read_text())
    (tmp_path / "access.log").touch()
    cfg.update(disable_kafka=False, kafka_brokers=[f"127.0.0.1:{broker_port}"],
               kafka_command_topic="cmds", kafka_report_topic="reps", kafka_max_wait_ms=50,
               server_log_file=str(tmp_path / "access.log"),
               banning_log_file=str(tmp_path / "bans.log"), gin_log_file="-",
               block_ip_ttl_seconds=600, block_session_ttl_seconds=900)
    cfg.update(extra)
    path = tmp_path / "kafka.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def test_app_reads_commands_and_writes_reports(tmp_path, monkeypatch, _port_ipset_off):
    from banjax_tpu_torch.decisions.model import Decision

    monkeypatch.setattr(port_cli, "KAFKA_STATUS_INTERVAL_SECONDS", 0.2)
    broker = FakeKafkaBroker(mode="modern").start()
    app = port_cli.BanjaxApp(str(_app_config(tmp_path, broker.port)), device="cpu")
    try:
        app.start_workers()
        # the reader starts at the LAST offset: append only once it fetches
        assert _wait(lambda: app.kafka_reader.transport._consumer is not None)
        for cmd in ({"Name": "block_ip", "Value": "55.55.55.55", "host": "other.example"},
                    {"Name": "challenge_session", "Value": "56.56.56.56", "host": "h",
                     "session_id": "x%2By"}):
            broker.append("cmds", 0, json.dumps(cmd).encode())
        assert _wait(lambda: app.dynamic_lists.peek("55.55.55.55") is not None
                     and "x+y" in app.dynamic_lists._by_session_id)
        entry = app.dynamic_lists.peek("55.55.55.55")
        assert entry.decision == Decision.NGINX_BLOCK and entry.from_baskerville
        assert 890 < entry.expires - time.time() <= 900  # block_ip's quirk TTL
        port_reports.report_passed_failed_banned_message(
            app.config_holder.get(), "ip_failed_challenge", "57.57.57.57", "h")
        assert _wait(lambda: len(broker.logs.get(("reps", 0), [])) >= 2)
        names = [json.loads(m)["name"] for m in broker.logs[("reps", 0)]]
        assert "ip_failed_challenge" in names and "status" in names
        comps = app.health.snapshot()["components"]
        assert comps["kafka-reader"]["status"] == comps["kafka-writer"]["status"] == "healthy"
    finally:
        t0 = time.monotonic()
        app.shutdown()
        broker.stop()
    assert time.monotonic() - t0 < 5


def test_app_with_an_absent_broker_stops_at_once(tmp_path, _port_ipset_off):
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens there
    app = port_cli.BanjaxApp(str(_app_config(tmp_path, port, disable_kafka_writer=True)),
                             device="cpu")
    app.start_workers()
    assert _wait(lambda: app.health.snapshot()["components"]["kafka-reader"]["status"]
                 == "degraded")
    assert app.kafka_writer is None
    t0 = time.monotonic()
    app.shutdown()
    assert time.monotonic() - t0 < 3
    assert not app.kafka_reader._thread.is_alive()
