"""The decision fabric (`banjax_tpu_torch/fabric/`, `native/shmring.py`)
against the JAX package's (`banjax_tpu/fabric/`), on the CPU. The
tolerance is exact equality throughout.

- The ring: ownership of 100,000 seeded IPs, after a join and under an
  exclusion, is the JAX ring's.
- The wire: v1 JSON frames and v2 line frames, with and without the
  origin section, are byte-identical, and each package decodes the
  other's.
- Replication and dedup: the commands published and the sequence the
  deduper applies (own echoes, duplicates, untagged and malformed
  commands) are the JAX ones.
- The router: the cases of `tests/unit/test_fabric.py` run through both
  routers with the same fake peers give the same dispositions, journals,
  takeovers, replay filtering and counters.
- SWIM: a scripted sequence of digests, probes and admin transitions on a
  scripted clock gives the same member states, events and router calls.
- The shm ring: frames round-trip through the port's ring, and through a
  ring the JAX package attached.
- The whole app: three port `BanjaxApp(device="cpu")` shards, then three
  JAX `BanjaxApp` shards (the XLA scan, `matcher_backend: auto`), tail their own logs in
  this process, each fabric against a fake Kafka broker of its own; each
  IP enters through one log. Per IP the ban-log lines (log times relative
  to the run's start) equal the JAX fabric's and a single-process port
  app's, every shard's lists hold every ban, and a forwarded line's ban
  names its origin shard in the ledger. Then one shard's node and tailer
  stop abruptly and the survivors are told (T_PEER_DOWN; gossip is off
  here, as the JAX shards' compiles would starve its probes): they take
  its range over, and after more lines through their logs their per-IP
  bans still equal the JAX survivors' and the single-process app's fed
  what they saw. Matcher entry is serialised on both sides (the port's
  app does it itself; the JAX shards get the same lock here).
- Concurrent matcher entry: two threads feeding one port app give the
  per-IP bans of the same batches fed one at a time (the app's lock; the
  native parse's scratch serves one batch at a time).
- The transports: the synchronous JSON path (`fabric_inflight_frames:
  0`), wire v2 and the shm ring give the same per-IP bans; with gossip on,
  the survivors of a stopped shard detect it and take over by themselves.
"""

import json
import random
import socket
import threading
import time
import types

import numpy as np
import pytest
import yaml

from banjax_tpu import cli as jax_cli
from banjax_tpu.decisions.model import Decision as JaxDecision
from banjax_tpu.fabric import hashring as jax_hashring
from banjax_tpu.fabric import membership as jax_membership
from banjax_tpu.fabric import peer as jax_peer
from banjax_tpu.fabric import replication as jax_replication
from banjax_tpu.fabric import router as jax_router
from banjax_tpu.fabric import stats as jax_stats
from banjax_tpu.fabric import wire as jax_wire
from banjax_tpu.native import shmring as jax_shmring
from banjax_tpu_torch import cli as port_cli
from banjax_tpu_torch import workload
from banjax_tpu_torch.decisions.model import Decision as PortDecision
from banjax_tpu_torch.fabric import hashring as port_hashring
from banjax_tpu_torch.fabric import membership as port_membership
from banjax_tpu_torch.fabric import peer as port_peer
from banjax_tpu_torch.fabric import replication as port_replication
from banjax_tpu_torch.fabric import router as port_router
from banjax_tpu_torch.fabric import stats as port_stats
from banjax_tpu_torch.fabric import wire as port_wire
from banjax_tpu_torch.native import shmring as port_shmring
from tests.differential.test_tpu_matcher import CONFIG_YAML
from tests.fake_kafka_broker import FakeKafkaBroker
from tests.test_torch_app import APP_KEYS
from tests.test_torch_matcher import _one_torch_thread  # noqa: F401
from tests.test_torch_obs import obs_reset  # noqa: F401

JAX = types.SimpleNamespace(
    hashring=jax_hashring, router=jax_router, stats=jax_stats, wire=jax_wire,
    peer=jax_peer, membership=jax_membership, replication=jax_replication,
    Decision=JaxDecision,
)
PORT = types.SimpleNamespace(
    hashring=port_hashring, router=port_router, stats=port_stats, wire=port_wire,
    peer=port_peer, membership=port_membership, replication=port_replication,
    Decision=PortDecision,
)


def _seeded_ips(n, seed):
    rng = np.random.default_rng(seed)
    octets = rng.integers(0, 256, size=(n, 4))
    return [".".join(map(str, row)) for row in octets.tolist()]


# ------------------------------------------------------------------ the ring

def test_ring_ownership_of_100k_ips_is_the_jax_rings():
    ips = _seeded_ips(100_000, seed=11)
    ids = ["shard-a", "shard-b", "shard-c"]
    for nodes, alive in ((ids, None), (ids + ["shard-d"], None), (ids, {"shard-a", "shard-c"})):
        j = jax_hashring.ConsistentHashRing(nodes, vnodes=64)
        p = port_hashring.ConsistentHashRing(nodes, vnodes=64)
        assert p._points == j._points
        assert p.partition(ips, alive) == j.partition(ips, alive)
    assert p.ownership_fractions({"shard-b"}) == j.ownership_fractions({"shard-b"})


# ------------------------------------------------------------------ the wire

def _frames(w):
    lines = ["1.5 10.0.0.1 GET a.com GET / HTTP/1.1 ua -", "ünïcode line", ""]
    return [
        w.encode_frame(w.T_LINES, {"lines": lines, "replay": False, "seq": 3}),
        w.encode_frame(w.T_GOSSIP_PING, {"from": "a", "digest": [["a", "alive", 0, "h", 1]],
                                         "health": {"a": 2}}),
        w.encode_frame(w.T_ACK, {}),
        w.encode_lines_v2(7, lines),
        w.encode_lines_v2(2**40, lines, replay=True),
        w.encode_lines_v2(9, lines, origin_node="shard-a", origin_t_read=123.25,
                          origin_runs=[(5, 2), (0, 1)]),
        w.encode_lines_v2(1, [], origin_node="n"),
    ]


def test_frames_are_byte_identical_and_cross_decode():
    pf, jf = _frames(port_wire), _frames(jax_wire)
    assert pf == jf
    assert port_wire.WIRE_VERSION == jax_wire.WIRE_VERSION
    codes = {k: v for k, v in vars(jax_wire).items() if k.startswith("T_")}
    assert codes == {k: v for k, v in vars(port_wire).items() if k.startswith("T_")}
    assert sorted(codes.values())[0] == 1 and sorted(codes.values())[-1] == 32
    for frame in pf:
        length, ftype = jax_wire._HEADER.unpack(frame[:5])
        assert length == len(frame) - 4
        pj, jj = port_wire.decode_body(ftype, frame[5:]), jax_wire.decode_body(ftype, frame[5:])
        if isinstance(jj, dict):
            assert pj == jj
        else:
            assert (pj.seq, pj.replay, pj.lines, pj.origin_node, pj.origin_t_read,
                    pj.origin_runs) == (jj.seq, jj.replay, jj.lines, jj.origin_node,
                                        jj.origin_t_read, jj.origin_runs)
    torn = pf[5][:5] + pf[5][5:-3]
    for w in (port_wire, jax_wire):
        with pytest.raises(w.FrameError):
            w.decode_lines_v2(torn[5:])
        with pytest.raises(w.FrameError):
            w.encode_lines_v2(1, ["a"], origin_node="n", origin_runs=[(1, 2)])


# ------------------------------------------- replication and the deduper

class _Transport:
    def __init__(self, fail_first=0):
        self.sent, self.fail = [], fail_first

    def send(self, config, topic, value):
        if self.fail:
            self.fail -= 1
            raise OSError("broker down")
        self.sent.append((topic, value))


def _replication_trace(pkg):
    applied, local = [], []
    stats = pkg.stats.FabricStats()
    transport = _Transport(fail_first=3)
    rep = pkg.replication.DecisionReplicator("a", transport, "cmds", stats=stats,
                                             local_apply=local.append)
    inner = types.SimpleNamespace(calls=[], ban_or_challenge_ip=lambda *a: inner.calls.append(a[1:]),
                                  log_regex_ban=lambda *a: "inner")
    banner = pkg.replication.ReplicatingBanner(inner, rep)
    for i, d in enumerate((pkg.Decision.NGINX_BLOCK, pkg.Decision.CHALLENGE,
                           pkg.Decision.IPTABLES_BLOCK, pkg.Decision.NGINX_BLOCK)):
        banner.ban_or_challenge_ip(None, f"10.0.0.{i}", d, "a.com" if i % 2 else "")
    assert banner.log_regex_ban() == "inner"
    dedup = pkg.replication.FabricDeduper("b", applied.append, stats=stats, max_seen=4)
    rng = random.Random(5)
    raws = [value for _t, value in transport.sent]
    for i in range(60):
        k = rng.random()
        if k < 0.2:
            raw = raws[rng.randrange(len(raws))]
        elif k < 0.3:
            raw = json.dumps({"Name": "block_ip", "Value": "1.2.3.4", "fabric_origin": "b",
                              "fabric_seq": i})
        elif k < 0.4:
            raw = json.dumps({"Name": "challenge_ip", "Value": f"9.9.9.{i}"}).encode()
        elif k < 0.45:
            raw = b"{not json"
        elif k < 0.5:
            raw = b"[1, 2]"
        else:
            raw = json.dumps({"Name": "block_ip", "Value": f"8.8.{i}.1", "fabric_origin": "c",
                              "fabric_seq": rng.randrange(8)})
        dedup.dispatch(raw)
    return transport.sent, local, inner.calls, applied, stats.peek()


def test_replicator_and_deduper_sequences_match_jax():
    port, jax = _replication_trace(PORT), _replication_trace(JAX)
    assert [(t, json.loads(v)) for t, v in port[0]] == [(t, json.loads(v)) for t, v in jax[0]]
    assert port[0] == jax[0]
    assert port[1] == jax[1]
    assert [(ip, str(d), dom) for ip, d, dom in port[2]] == \
        [(ip, str(d), dom) for ip, d, dom in jax[2]]
    assert port[3] == jax[3] and port[4] == jax[4]
    assert port[4]["FabricReplicationErrors"] == 3 and port[4]["FabricDuplicatesSuppressed"] > 0


# ------------------------------------------------------------------ the router

class _FakePeer:
    """PeerClient's request, recording lines; dead on demand."""

    def __init__(self, pkg, peer_id, gossip=None):
        self.pkg, self.peer_id = pkg, peer_id
        self.host, self.port = "127.0.0.1", 0
        self.breaker = types.SimpleNamespace(state="closed")
        self.lines, self.dead, self.gossip = [], False, gossip

    def request(self, ftype, payload):
        if self.dead:
            raise self.pkg.peer.PeerUnavailable(f"{self.peer_id} dead")
        self.lines.extend(payload["lines"])
        out = {"n": len(payload["lines"])}
        if self.gossip:
            out["gossip"] = self.gossip
        return self.pkg.wire.T_ACK, out

    def connect_to(self, host, port):
        self.dead = False


def _lines(n, base=1):
    return [f"1000.0 10.{base}.{i >> 8}.{i & 255} GET h GET / HTTP/1.1 ua -" for i in range(n)]


class _Case:
    def __init__(self, pkg, n=3, now=None):
        ids = [f"w{i}" for i in range(n)]
        self.pkg = pkg
        self.local, self.events = [], []
        self.peers = {w: (None if w == "w0" else _FakePeer(pkg, w)) for w in ids}
        self.stats = pkg.stats.FabricStats()
        self.now = now
        self.parked = threading.Event()
        kw = {}
        if now is not None:
            kw = dict(clock=lambda: self.now[0], sleep=lambda s: self.parked.wait(30.0))
        self.r = pkg.router.FabricRouter(
            "w0", pkg.hashring.ConsistentHashRing(ids, vnodes=64), self.peers,
            lambda ls: self.local.extend(ls) or len(ls), stats=self.stats,
            takeover_grace_ms=0.0 if now is None else 10_000.0, **kw)

    def note(self, what):
        peek = self.stats.peek()
        d = self.r.describe()
        for p in d["peers"].values():
            p.pop("breaker", None)
        if d["last_takeover"]:
            d["last_takeover"] = {k: v for k, v in d["last_takeover"].items() if k != "duration_s"}
        self.events.append((what, list(self.local), {k: list(p.lines) for k, p in self.peers.items()
                                                    if p}, peek, d,
                            {k: [list(c) for c in j] for k, j in self.r._journal.items()}))


def _case_dispositions(c):
    c.events.append(c.r.route(_lines(300)))
    c.note("routed")


def _case_takeover(c):
    c.r.route(_lines(200))
    c.peers["w1"].dead = True
    c.events.append(c.r.route(_lines(50, base=2)))
    c.note("took over")


def _case_all_dead(c):
    c.peers["w1"].dead = True
    c.events.append(c.r.route(_lines(40)))
    c.note("one survivor")
    c.r.alive.clear()
    c.events.append(c.r.route(_lines(8)))
    c.events.append(c.stats.peek())


def _case_replay_filter(c):
    chunk = _lines(120)
    c.r.route(chunk)
    c.peers["w1"].dead = True
    c.r._journal["w1"].clear()
    c.r.mark_dead("w1", reason="SIGKILL")
    c.events.append(c.r.route(chunk, replay=True))
    c.note("replayed")


def _case_replay_passthrough(c):
    c.events.append(c.r.route(_lines(60), replay=True))
    c.peers["w1"].dead = True
    c.r.mark_dead("w1", reason="test")
    c.peers["w1"].dead = False
    c.r.mark_alive("w1", host="127.0.0.1", port=1)
    c.events.append(c.r.route(_lines(60), replay=True))
    c.events.append(c.r.route(_lines(80, base=3)))
    c.note("passthrough")


def _case_deadline(c):
    try:
        c.r.route(_lines(200))
        c.peers["w1"].dead = True
        c.r.mark_dead("w1", reason="test")
        c.events.append(c.r.takeover_pending("w1"))
        c.events.append(c.r.route(_lines(30, base=2)))
        c.note("in the window")
        c.now[0] += 11.0
        c.r.route(_lines(5, base=3))
        c.events.append(c.r.takeover_pending())
        c.note("deadline passed")
    finally:
        c.parked.set()


def _case_poll(c):
    try:
        c.r.route(_lines(120))
        c.peers["w1"].dead = True
        c.r.mark_dead("w1", reason="test")
        c.r.poll()
        c.events.append(c.r.takeover_pending("w1"))
        c.now[0] += 11.0
        c.r.poll()
        c.note("polled")
    finally:
        c.parked.set()


def _case_add_node(c):
    c.r.add_node("w3", _FakePeer(c.pkg, "w3"))
    c.peers["w3"] = c.r.peers["w3"]
    c.events.append(c.r.route(_lines(400)))
    ring = c.r.ring
    c.r.add_node("w1", c.peers["w1"])
    c.events.append(c.r.ring is ring)
    c.note("joined")


def _case_mark_left(c):
    c.r.route(_lines(300))
    c.r.mark_left("w1")
    c.events.append(c.r.route(_lines(50, base=2)))
    c.r.mark_left("w0")
    c.events.append(c.r.route(_lines(40, base=3)))
    c.note("left")


def _case_gossip(c):
    merged = []
    c.peers["w1"].gossip = [["w9", "alive", 3, "127.0.0.1", 1]]
    c.r.gossip_merge = merged.append
    c.r.route(_lines(64))
    c.events.append(merged)
    c.events.append(c.r.owner_of("10.1.0.7"))
    c.events.append(sorted(c.r.alive_peers()))
    c.note("gossip")


@pytest.mark.parametrize("case, scripted", [
    (_case_dispositions, False), (_case_takeover, False), (_case_all_dead, False),
    (_case_replay_filter, False), (_case_replay_passthrough, False), (_case_deadline, True),
    (_case_poll, True), (_case_add_node, False), (_case_mark_left, False),
    (_case_gossip, False),
])
def test_router_cases_match_jax(case, scripted):
    traces = []
    for pkg in (PORT, JAX):
        c = _Case(pkg, now=[1000.0] if scripted else None)
        case(c)
        traces.append(c.events)
    assert traces[0] == traces[1]
    assert traces[0]


# ------------------------------------------------------------------ SWIM

class _RecRouter:
    def __init__(self, pkg, calls):
        self.calls = calls
        self.ring = pkg.hashring.ConsistentHashRing(["n0", "n1", "n2", "n3"], vnodes=8)

    def mark_dead(self, nid, reason=""):
        self.calls.append(("dead", nid, reason))

    def mark_alive(self, nid, host=None, port=None):
        self.calls.append(("alive", nid, host, port))

    def add_node(self, nid, client):
        self.calls.append(("add", nid, client))

    def mark_left(self, nid):
        self.calls.append(("left", nid))

    def poll(self):
        self.calls.append(("poll",))


def _swim_trace(pkg):
    now = [100.0]
    calls, out = [], []
    stats = pkg.stats.FabricStats()
    m = pkg.membership.SwimMembership(
        "n0", "127.0.0.1", 4000, router=_RecRouter(pkg, calls), stats=stats,
        gossip_interval_ms=50, suspect_timeout_ms=300, indirect_probes=2,
        peer_factory=lambda nid, h, p: f"client:{nid}:{p}", clock=lambda: now[0], rng_seed=7,
        health_provider=lambda: 4)
    m.seed({"n0": ("127.0.0.1", 4000), "n1": ("127.0.0.1", 4001),
            "n2": ("127.0.0.1", 4002), "n3": ("127.0.0.1", 4003)})
    reachable = {4001: True, 4002: False, 4003: True, 4004: True}
    sent = []

    def send(host, port, ftype, payload):
        sent.append((port, ftype, payload.get("target")))
        if ftype == pkg.wire.T_GOSSIP_PING_REQ:
            return {"ok": reachable.get(4000 + int(payload["target"][1:]), False),
                    "digest": [], "health": {"n3": 1}}
        return {"digest": [["n1", "alive", 0, "127.0.0.1", 4001]], "health": {"n1": 2}} \
            if reachable.get(port) else None

    m._send = send

    def snap(what):
        out.append((what, m.digest(), m.describe(), stats.peek(),
                    stats.member_states_snapshot(), stats.peer_health_snapshot(),
                    stats.detection_snapshot(), list(calls), list(sent)))

    for _ in range(6):
        m.tick()
        now[0] += 0.05
    snap("probed")
    now[0] += 0.4
    m.tick()
    snap("expired")
    out.append(m.merge([["n1", "suspect", 0, "127.0.0.1", 4001], ["n0", "suspect", 0, "", 0],
                        ["n4", "alive", 0, "127.0.0.1", 4004], ["bad"], ["n3", "left", 5, "h", 1]]))
    snap("merged")
    out.append(m.merge([["n1", "alive", 1, "127.0.0.1", 4001], ["n2", "alive", 2, "127.0.0.1", 4012]]))
    out.append(m.note_peer_down("n4"))
    out.append(m.note_peer_down("n4"))
    out.append(m.note_peer_up("n4", host="127.0.0.1", port=4014))
    out.append(m.note_peer_up("n4"))
    out.append(m.handle_ping({"from": "n1", "digest": [["n5", "suspect", 0, "h", 5]],
                              "health": {"n1": 3, "n0": 9}}))
    out.append(m.handle_join({"node_id": "n6", "host": "127.0.0.1", "port": 4006}))
    now[0] += 1.0
    m._expire_suspicions()
    snap("admin")
    out.append(m.begin_leave())
    out.append([m.status_of(n) for n in ("n0", "n1", "n2", "n3", "n4", "n5", "n6", "nx")])
    return out


def test_swim_state_sequences_match_jax():
    port, jax = _swim_trace(PORT), _swim_trace(JAX)
    assert len(port) == len(jax)
    for p, j in zip(port, jax):
        assert p == j
    events = [c[0] for c in port[-3][7]]
    assert {"dead", "alive", "add", "left", "poll"} <= set(events)


# ------------------------------------------------------------------ the shm ring

def test_shm_ring_round_trip_and_jax_attach():
    frames = _frames(port_wire)
    ring = port_shmring.ShmRing(capacity=1 << 12)
    peer = port_shmring.ShmRing(name=ring.name)
    jax_side = jax_shmring.ShmRing(name=ring.name)
    try:
        assert peer.capacity == jax_side.capacity == 1 << 12
        for k in range(40):  # wraps the ring several times
            frame = frames[k % len(frames)]
            port_shmring.write_frame(ring, frame, 1.0)
            assert ring.readable() == len(frame) and 0 < ring.occupancy() <= 1.0
            reader = (peer, jax_side)[k % 2]
            mod = (port_shmring, jax_shmring)[k % 2]
            assert mod.read_frame(reader, 1.0) == (frame[4], frame[5:])
        assert port_shmring.read_frame(peer, 0.01) is None
        with pytest.raises(port_wire.FrameError):
            ring.write(b"x" * (1 << 13), 0.1)
        ring.write(b"y" * (1 << 12), 0.1)
        with pytest.raises(port_shmring.RingTimeout):
            ring.write(b"z", 0.05)
        with pytest.raises(port_shmring.ShmRingError):
            port_shmring.ShmRing(name="/banjax-no-such-ring")
        with pytest.raises(ValueError):
            port_shmring.ShmRing(capacity=1000)
    finally:
        jax_side.close()
        peer.close()
        ring.close()


# ------------------------------------------------------------------ the whole app

FABRIC_KEYS = dict(fabric_enabled=True, fabric_gossip_interval_ms=0,
                   fabric_suspect_timeout_ms=1500, fabric_takeover_grace_ms=50,
                   fabric_send_timeout_ms=10000, fabric_trace_propagation=True,
                   kafka_max_wait_ms=50, gin_log_file="-", disable_kafka=False,
                   disable_kafka_writer=True,
                   # decisions outlive the run (the test config's TTLs are 0; a
                   # replicated block_ip takes block_session_ttl_seconds, the
                   # reference's quirk)
                   expiring_decision_ttl_seconds=600, block_ip_ttl_seconds=600,
                   block_session_ttl_seconds=600)
IDS = ("a", "b", "c")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _shard_config(tmp_path, name, fabric=None, broker_port=None):
    cfg = yaml.safe_load(CONFIG_YAML)
    extra = yaml.safe_load(workload.rules_config(workload.generate_rules(8, seed=31), seed=3))
    cfg["regexes_with_rates"] += extra["regexes_with_rates"]
    cfg["regexes_with_rates"][0]["hits_per_interval"] = 2
    cfg.update(yaml.safe_load(APP_KEYS))
    cfg.update(server_log_file=str(tmp_path / f"{name}-access.log"),
               banning_log_file=str(tmp_path / f"{name}-bans.log"),
               metrics_log_file=str(tmp_path / f"{name}-metrics.log"), gin_log_file="-")
    if fabric is not None:
        cfg.update(FABRIC_KEYS)
        cfg.update(kafka_brokers=[f"127.0.0.1:{broker_port}"], **fabric)
    (tmp_path / f"{name}-access.log").write_text("")
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _lines_for(log_k, now, n, seed):
    """One log's lines: its own IPs (each IP enters through one log), a
    mix of offenders, per-site rules, skipped hosts, generated-rule
    attacks and benign lines, in log-time order."""
    rng = random.Random(seed)
    pats = workload.generate_rules(8, seed=31)
    out = []
    for i in range(n):
        ip = f"10.{log_k}.{rng.randrange(4)}.{rng.randrange(8)}"
        ts = now - 1.5 + i / n
        kind = rng.random()
        if kind < 0.3:
            rest = f"GET example.com GET /page{i % 5} HTTP/1.1 ua -"
        elif kind < 0.36:
            rest = "POST example.com POST /submit HTTP/1.1 ua -"
        elif kind < 0.4:
            rest = "GET per-site.com GET /blockme HTTP/1.1 ua -"
        elif kind < 0.42:
            rest = "DELETE skipme.com DELETE /x HTTP/1.1 ua -"
        elif kind < 0.55:
            rest = workload.synthesize_match(pats[rng.randrange(len(pats))], rng)
        else:
            rest = f"GET news.net GET /benign/{i % 11} HTTP/1.1 Mozilla/5.0 -"
        out.append(f"{ts:f} {ip} {rest}")
    return out


class _Tailed:
    """Counts the lines a tailer handed on."""

    def __init__(self, app):
        self.inner, self.n = app.tailer.on_lines, 0
        app.tailer.on_lines = self

    def __call__(self, batch):
        self.inner(batch)
        self.n += len(batch)


def _wait(cond, what, timeout=40.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.02)


class Fabric:
    """Three shards of one package in this process, each tailing its own
    log, on loopback ports, against one fake broker of their own."""

    def __init__(self, tmp_path, kind, transport="v2", gossip_ms=0, extra_keys=None,
                 http=False):
        self.kind, self.tmp = kind, tmp_path / kind
        self.tmp.mkdir()
        self.broker = FakeKafkaBroker(mode="modern").start()
        peers = {n: f"127.0.0.1:{_free_port()}" for n in IDS}
        extra = {"json": dict(fabric_inflight_frames=0), "v2": {},
                 "shm": dict(fabric_shm_enabled=True, fabric_shm_ring_bytes=1 << 21)}[transport]
        self.apps, self.tailed = {}, {}
        try:
            for n in IDS:
                path = _shard_config(self.tmp, n, dict(fabric_node_id=n, fabric_listen=peers[n],
                                                       fabric_peers=peers,
                                                       fabric_gossip_interval_ms=gossip_ms,
                                                       **extra, **(extra_keys or {})),
                                     self.broker.port)
                if kind == "port":
                    app = port_cli.BanjaxApp(path, device="cpu")
                else:
                    app = jax_cli.BanjaxApp(path)
                    # the JAX runner takes no lock at entry: serialise it
                    # here as the port's app does, so both run one batch
                    # at a time through the matcher
                    app._fabric_local_submit = _locked(app._fabric_local_submit)
                    app.fabric.router.local_submit = app._fabric_local_submit
                    app.fabric._local_submit = app._fabric_local_submit
                self.apps[n] = app
                self.tailed[n] = _Tailed(app)
            self.http = http
            for app in self.apps.values():
                if http:
                    app.start_background(port=0)  # the workers, and HTTP on app.port
                else:
                    app.start_workers()
            _wait(lambda: all(a.kafka_reader.transport._consumer is not None
                              and a.tailer.opened.is_set() for a in self.apps.values()),
                  "readers and tailers up")
            # build and compile each matcher on one benign line of an IP no
            # test line has, before the timed lines arrive
            for app in self.apps.values():
                app._fabric_local_submit(
                    [f"{time.time():f} 192.0.2.1 GET news.net GET / HTTP/1.1 ua -"])
        except BaseException:
            self.close()
            raise
        self.live = list(IDS)

    def append(self, n, lines):
        with open(self.tmp / f"{n}-access.log", "a", encoding="utf-8") as f:
            f.write("".join(ln + "\n" for ln in lines))

    def settle(self, expected_tailed, timeout=60.0):
        def done():
            # a stopped shard's counters stay as they were: its acked
            # forwards count on both sides of the sum
            peeks = {n: self.apps[n].fabric.stats.peek() for n in IDS}
            if sum(self.tailed[n].n for n in IDS) != expected_tailed:
                return False
            for n, p in peeks.items():
                if p["FabricLocalLines"] + p["FabricForwardedLines"] + p["FabricShedLines"] + \
                        p["FabricReplaySkippedLines"] != \
                        self.tailed[n].n + p["FabricReceivedLines"] + p["FabricReplayedLines"]:
                    return False
            return sum(p["FabricForwardedLines"] for p in peeks.values()) == \
                sum(p["FabricReceivedLines"] for p in peeks.values())
        try:
            _wait(done, f"{self.kind} fabric settled", timeout)
        except AssertionError:
            raise AssertionError(f"{self.kind} fabric did not settle: expected {expected_tailed} "
                                 f"tailed lines, {self.state()}") from None

    def state(self):
        return {n: (self.tailed[n].n, self.apps[n].fabric.stats.peek()) for n in IDS}

    def bans(self, names=None):
        out = {}
        for n in names or self.live:
            for line in (self.tmp / f"{n}-bans.log").read_text().splitlines():
                out.setdefault(json.loads(line)["client_ip"], []).append(line)
        return out

    def wait_replicated(self, ips):
        def missing():
            return [(n, ip) for n in self.live for ip in ips
                    if self.apps[n].dynamic_lists.peek(ip) is None]
        try:
            _wait(lambda: not missing(), f"{self.kind} bans replicated", 60.0)
        except AssertionError:
            raise AssertionError(
                f"{self.kind} bans not replicated: {missing()[:6]}; entries "
                f"{ {n: len(self.apps[n].dynamic_lists.format_ip_entries()) for n in self.live} }; "
                f"{ {n: self.apps[n].fabric.stats.peek() for n in self.live} }") from None

    def kill(self, n, announce=False):
        """Stop one shard's gossip, node, pipes and tailer at once. With
        `announce`, tell the survivors over the admin frame (T_PEER_DOWN),
        as an operator would where no gossip runs."""
        fab = self.apps[n].fabric
        if fab.membership is not None:
            fab.membership.stop()
        fab.node.stop()
        for conn in fab.node._conn_threads:  # the open connections end too
            conn.join(2.0)
        fab.router.close()
        self.apps[n].tailer.stop()
        self.live.remove(n)
        pkg = PORT if self.kind == "port" else JAX
        for s in self.live if announce else ():
            node = self.apps[s].fabric.node
            client = pkg.peer.PeerClient(s, node.host, node.port)
            try:
                assert client.request(pkg.wire.T_PEER_DOWN, {"peer": n})[0] == pkg.wire.T_ACK
            finally:
                client.close()

    def close(self):
        for app in self.apps.values():
            if getattr(self, "http", False):
                app.stop_background()
            else:
                app.shutdown()
        self.broker.stop()


def _locked(fn):
    lock = threading.Lock()

    def call(lines, t_read=None, hop="local"):
        with lock:
            return fn(lines, t_read=t_read, hop=hop)
    return call


def _reference_bans(tmp_path, name, batches):
    """A single-process port app (no fabric) fed `batches`, each a (lines,
    now) pair: the clock is pinned to when the fabric saw those lines,
    so the stale-line rule (10 s) judges them as it did there."""
    (tmp_path / name).mkdir()
    app = port_cli.BanjaxApp(_shard_config(tmp_path / name, "ref"), device="cpu")
    try:
        for lines, now in batches:
            app._current_matcher()[1].consume_lines(lines, now_unix=now)
    finally:
        app.shutdown()
    out = {}
    for line in (tmp_path / name / "ref-bans.log").read_text().splitlines():
        out.setdefault(json.loads(line)["client_ip"], []).append(line)
    return out


def _concurrent_entry_bans(tmp_path, name, feeds, concurrent):
    """A port app on the deploy file's native parse, its feeds entering
    `_consume_serial` (the tailer's and the fabric's way in with the
    pipeline off) from one thread each, or one feed after another."""
    path = _shard_config(tmp_path, name)
    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg.update(matcher_native_parse=True, slotmgr_native=True,
               expiring_decision_ttl_seconds=600, block_ip_ttl_seconds=600)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    app = port_cli.BanjaxApp(path, device="cpu")
    errors = []

    def feed(batches):
        try:
            for batch in batches:
                app._consume_serial(batch)
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)

    try:
        if concurrent:
            threads = [threading.Thread(target=feed, args=(b,)) for b in feeds]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        else:
            for batches in feeds:
                feed(batches)
    finally:
        app.shutdown()
    assert not errors, errors
    out = {}
    for line in (tmp_path / f"{name}-bans.log").read_text().splitlines():
        out.setdefault(json.loads(line)["client_ip"], []).append(line)
    return out


def test_concurrent_matcher_entry_bans_as_one_batch_at_a_time(tmp_path):
    """With the pipeline off, the tailer thread and the fabric's connection
    threads enter one matcher at once. Its native parse writes into one
    scratch per matcher, which a parsed batch's views alias until the next
    parse, so the port's app serialises entry: two threads feeding it
    batches of disjoint IPs give the per-IP ban-log lines of the same
    batches fed one at a time. (Without the lock, nearly every IP's lines
    differed.)"""
    now = time.time() + 600
    feeds = [_lines_for(k, now, 1200, seed=50 + k) for k in (1, 2)]
    feeds = [[f[i:i + 100] for i in range(0, len(f), 100)] for f in feeds]
    serial = _concurrent_entry_bans(tmp_path, "serial", feeds, concurrent=False)
    together = _concurrent_entry_bans(tmp_path, "together", feeds, concurrent=True)
    assert len(serial) > 8
    assert together == serial


@pytest.fixture(autouse=True)
def _ipset_off(monkeypatch):
    monkeypatch.setattr(port_cli, "init_ipset", lambda *a, **k: None)
    monkeypatch.setattr(jax_cli, "init_ipset", lambda *a, **k: None)


def _owner(ip):
    return port_hashring.ConsistentHashRing(IDS, vnodes=64).owner(ip)


def _relative(bans, base):
    """Ban lines with their log-time timestring made relative to `base`
    (whole seconds), so runs started at different times compare."""
    from datetime import datetime

    from banjax_tpu_torch.effectors.banner import _format_ban_time

    t0 = datetime.fromisoformat(_format_ban_time(base))
    out = {}
    for ip, lines in bans.items():
        rows = []
        for line in lines:
            row = json.loads(line)
            row["timestring"] = (datetime.fromisoformat(row["timestring"]) - t0).total_seconds()
            rows.append(row)
        out[ip] = rows
    return out


VICTIM, SURVIVORS = "b", ("a", "c")


def _kill_scenario(tmp_path, kind):
    """One package's three shards: the first lines through all three
    logs, then the victim stops, the survivors take over, and more lines
    go through the survivors' logs. Returns the lines, the time base and
    the per-IP bans before and after."""
    f = Fabric(tmp_path, kind)
    try:
        now = float(int(time.time()) + 1)
        # log times 600 s ahead: a takeover replays lines after a while, and
        # the 10 s stale rule must not judge them differently here and in
        # the single process
        phase1 = {n: _lines_for(k, now + 600, 240, seed=k) for k, n in enumerate(IDS)}
        for n in IDS:
            f.append(n, phase1[n])
        f.settle(sum(map(len, phase1.values())))
        before = f.bans()
        origins = {}
        if kind == "port":
            # a ban minted from a forwarded line names its origin shard
            from banjax_tpu_torch.obs import provenance

            for ip in before:
                recs = [r for r in provenance.get_ledger().explain(ip)
                        if r["source"] == "rate_limit"]
                origins[ip] = {r.get("origin_node", "") for r in recs}
        f.wait_replicated(list(before))
        shed = [a.fabric.stats.peek()["FabricShedLines"] for a in f.apps.values()]

        f.kill(VICTIM, announce=True)
        _wait(lambda: all(f.apps[n].fabric.stats.peek()["FabricTakeovers"] == 1
                          and not f.apps[n].fabric.router.takeover_pending()
                          for n in SURVIVORS), f"{kind} takeover")
        phase2 = {n: _lines_for(IDS.index(n), now + 601.0, 120, seed=10 + IDS.index(n))
                  for n in SURVIVORS}
        for n in SURVIVORS:
            f.append(n, phase2[n])
        f.settle(sum(map(len, phase1.values())) + sum(map(len, phase2.values())))
        after = f.bans(SURVIVORS)
        replayed = sum(f.apps[n].fabric.stats.peek()["FabricReplayedLines"] for n in SURVIVORS)
    finally:
        f.close()
    return dict(now=now, phase1=phase1, phase2=phase2, before=_relative(before, now),
                after=_relative(after, now), replayed=replayed, origins=origins, shed=shed)


def test_three_shards_ban_as_the_jax_fabric_and_one_process_before_and_after_a_kill(tmp_path):
    """The JAX fabric runs first, then the port's (a package's shards
    alone at a time: the JAX shards' compiles would otherwise starve the
    port's gossip); each run's log times start at a whole second, and the
    ban lines compare with their times relative to it."""
    jax = _kill_scenario(tmp_path, "jax")
    port = _kill_scenario(tmp_path, "port")
    now, phase1, phase2 = port["now"], port["phase1"], port["phase2"]
    # about two thirds of each log's lines belong to another shard
    for n, lines in phase1.items():
        foreign = sum(_owner(ln.split(" ")[1]) != n for ln in lines)
        assert 0.4 < foreign / len(lines) < 0.9
    ref = _reference_bans(tmp_path, "ref-all", [(phase1[n], now + 3) for n in IDS])
    assert len(ref) > 8
    assert port["before"] == _relative(ref, now), "the port's shards against one process"
    assert jax["before"] == port["before"], "the JAX shards against the port's"
    assert port["shed"] == jax["shed"] == [0, 0, 0]
    forwarded = [ip for ip in port["before"] if _owner(ip) != IDS[int(ip.split(".")[1])]]
    assert forwarded
    for ip in forwarded:
        assert port["origins"][ip] == {IDS[int(ip.split(".")[1])]}
    # the survivors against one process fed what entered through their
    # logs, plus the victim's acked forwards
    seen = [(phase1[n], now + 3) for n in SURVIVORS] + \
        [([ln for ln in phase1[VICTIM] if _owner(ln.split(" ")[1]) != VICTIM], now + 3)] + \
        [(phase2[n], now + 3) for n in SURVIVORS]
    ref_after = _reference_bans(tmp_path, "ref-survivors", seen)
    assert port["after"] == _relative(ref_after, now), "the port's survivors against one process"
    assert jax["after"] == port["after"], "the JAX survivors against the port's"
    assert port["replayed"] == jax["replayed"] > 0


@pytest.mark.parametrize("transport", ["json", "shm"])
def test_transports_give_the_same_bans(tmp_path, transport):
    """Gossip on (80 ms probes): after the flood one shard stops, and the
    survivors detect it and take its range over on their own."""
    f = Fabric(tmp_path, "port", transport, gossip_ms=80)
    try:
        now = time.time()
        lines = {n: _lines_for(k, now, 160, seed=20 + k) for k, n in enumerate(IDS)}
        for n in IDS:
            f.append(n, lines[n])
        f.settle(sum(map(len, lines.values())))
        got = f.bans()
        modes = {p["transport"] for app in f.apps.values()
                 for p in app.fabric.describe()["peers"].values()}
        f.kill(VICTIM)
        _wait(lambda: all(f.apps[n].fabric.stats.peek()["FabricTakeovers"] == 1
                          and f.apps[n].fabric.membership.status_of(VICTIM) == "dead"
                          for n in SURVIVORS), "gossip-detected takeover")
        shed = [f.apps[n].fabric.stats.peek()["FabricShedLines"] for n in SURVIVORS]
    finally:
        f.close()
    assert got == _reference_bans(tmp_path, "ref", [(lines[n], now + 3) for n in IDS])
    assert modes == ({"sync-json"} if transport == "json" else {"sync-json", "v2/shm[0]"})
    assert shed == [0, 0]
