"""The kernel edge (ipset + the netlink batch writer) against the JAX
package's, on the CPU and without root: no `ipset` or `iptables` command
and no netlink message reaches the machine's kernel here (`_run` is
recorded, the writer's `_socket` is a fake, and the one subprocess test
runs scripts from a temporary directory put first on `PATH`).

- The encoders: the golden frame and 1,000 seeded (ip, timeout, seq)
  cases, IPv6 and garbage entries routed to the fallback, and
  `parse_acks` on seeded ack buffers (errors, foreign messages,
  truncation), byte for byte against JAX.
- `IpsetBatchWriter` against the JAX writer under the same fake socket
  and fake ipset: coalescing, a failing socket, a NACK, an open breaker,
  shedding the oldest entries on overflow, draining on close, and
  concurrent producers: the same frames, fallback calls and counters.
- `init_ipset`'s command sequences, and one ban stream through both
  Banners (subprocess and batched): the same ipset calls.
"""

import os
import random
import socket
import stat
import struct
import threading
import time

import pytest
import yaml

from banjax_tpu.config.schema import config_from_yaml_text as jax_config
from banjax_tpu.decisions.dynamic_lists import DynamicDecisionLists as JaxDynamicLists
from banjax_tpu.decisions.model import Decision as JaxDecision
from banjax_tpu.effectors import banner as jax_banner_mod
from banjax_tpu.effectors import ipset as jax_ipset
from banjax_tpu.effectors import ipset_netlink as jax_nl
from banjax_tpu.effectors.ipset_stats import get_stats as jax_ipset_stats
from banjax_tpu.resilience import breaker as jax_breaker
from banjax_tpu.resilience import failpoints as jax_fp
from banjax_tpu_torch.config import config_from_yaml_text
from banjax_tpu_torch.decisions.dynamic_lists import DynamicDecisionLists
from banjax_tpu_torch.decisions.model import Decision
from banjax_tpu_torch.effectors import banner as port_banner_mod
from banjax_tpu_torch.effectors import ipset as port_ipset
from banjax_tpu_torch.effectors import ipset_netlink as port_nl
from banjax_tpu_torch.effectors.ipset_stats import IpsetStats
from banjax_tpu_torch.resilience import breaker as port_breaker
from banjax_tpu_torch.resilience import failpoints as port_fp

GOLDEN_ADD = bytes.fromhex(
    "400000000906050007000000000000000200000005000100060000000b000200"
    "62616e6a61780000180007800c0001800800014001020304080006400000012c"
)


@pytest.fixture(autouse=True)
def _clean():
    """The JAX writer counts on a process-wide singleton and both
    failpoint modules keep module state: start and end clean."""
    jax_ipset_stats().reset()
    jax_fp.disarm()
    port_fp.disarm()
    yield
    jax_fp.disarm()
    port_fp.disarm()
    jax_ipset_stats().reset()


# ------------------------------------------------------------ encoders


def _seeded_ip(rng):
    r = rng.random()
    if r < 0.05:
        return f"2001:db8::{rng.randrange(1 << 16):x}"
    if r < 0.08:
        return rng.choice(["garbage", "", "1.2.3", "256.1.1.1", "::1"])
    return ".".join(str(rng.randrange(256)) for _ in range(4))


def test_encoders_give_the_jax_bytes():
    assert port_nl.encode_ipset_add("banjax", "1.2.3.4", 300, seq=7) == GOLDEN_ADD
    rng = random.Random(11)
    for _ in range(1000):
        ip, timeout, seq = _seeded_ip(rng), rng.randrange(1 << 32), rng.randrange(1 << 32)
        name = rng.choice(["banjax_ipset", "b", "a-longer-set-name"])
        try:
            want = jax_nl.encode_ipset_add(name, ip, timeout, seq)
        except OSError:
            with pytest.raises(OSError):
                port_nl.encode_ipset_add(name, ip, timeout, seq)
            continue
        assert port_nl.encode_ipset_add(name, ip, timeout, seq) == want
    for k in range(50):
        entries = [(_seeded_ip(rng), rng.randrange(1, 3600)) for _ in range(rng.randrange(12))]
        seq0 = rng.randrange(1, 1000)
        assert port_nl.encode_batch("banjax_ipset", entries, seq0) == \
            jax_nl.encode_batch("banjax_ipset", entries, seq0), k


def _ack(err, seq=1):
    return struct.pack("=IHHII", 20, port_nl.NLMSG_ERROR, 0, seq, 0) + struct.pack("=i", err)


def test_parse_acks_matches_jax():
    rng = random.Random(5)
    for _ in range(200):
        parts = []
        for _ in range(rng.randrange(6)):
            kind = rng.random()
            if kind < 0.7:
                parts.append(_ack(rng.choice([0, 0, -17, -2, -1]), rng.randrange(100)))
            elif kind < 0.9:
                parts.append(struct.pack("=IHHII", 16, 0x42, 0, 9, 0))
            else:
                parts.append(struct.pack("=IHHII", rng.randrange(16), 0, 0, 0, 0))
        buf = b"".join(parts)
        buf = buf[: rng.randrange(len(buf) + 1)] if rng.random() < 0.3 else buf
        assert port_nl.parse_acks(buf) == jax_nl.parse_acks(buf)


# ------------------------------------------------------------- writer


class FakeSock:
    """Stands in for the AF_NETLINK socket: records each send and acks
    every message of it, NACKing the first `nack`; `fail` raises."""

    def __init__(self, fail=False, nack=0):
        self.sent, self.fail, self.nack = [], fail, nack

    def send(self, buf):
        if self.fail:
            raise OSError(1, "EPERM")
        self.sent.append(buf)

    def recv(self, _n):
        n = len(_messages(self.sent[-1]))
        return b"".join(_ack(-17 if i < self.nack else 0, i + 1) for i in range(n))

    def close(self):
        pass


def _messages(buf):
    out, off = [], 0
    while off + 16 <= len(buf):
        (length,) = struct.unpack_from("=I", buf, off)
        out.append(buf[off : off + length])
        off += (length + 3) & ~3
    return out


def _entries(frames):
    """(ip, timeout) of every message sent, from the IPv4 address and the
    timeout at the message's tail."""
    return sorted((socket.inet_ntoa(m[-12:-8]), struct.unpack(">I", m[-4:])[0])
                  for f in frames for m in _messages(f))


class FakeIpset:
    """The subprocess shim's stand-in: records per-entry fallback adds."""

    name = "banjax_ipset"

    def __init__(self, fail=False):
        self.added, self.fail = [], fail

    def add(self, ip, timeout):
        if self.fail:
            raise RuntimeError("ipset binary missing")
        self.added.append((ip, timeout))


def _writers(sock_kw=None, ipset_kw=None, open_breaker=False, **kw):
    out = []
    for nl, br_mod, stats in ((port_nl, port_breaker, IpsetStats()), (jax_nl, jax_breaker, None)):
        sock, ipset = FakeSock(**(sock_kw or {})), FakeIpset(**(ipset_kw or {}))
        breaker = None
        if open_breaker:
            breaker = br_mod.CircuitBreaker(failure_threshold=1, recovery_seconds=3600.0)
            breaker.record_failure()
        args = dict(kw, breaker=breaker)
        if stats is not None:
            args["stats"] = stats
        w = nl.IpsetBatchWriter(ipset, **args)
        w._socket = lambda s=sock: s
        out.append((w, sock, ipset))
    return out


def _counters(w):
    snap = w.stats.prom_snapshot()
    snap.pop("queue_depth")
    return snap


def _run_both(entries, **kw):
    """Both writers over one entry list; `flush_interval` long enough that
    every entry is queued before the drain takes its batch, then close()
    (which flushes what is queued): the frames, fallbacks and counters."""
    kw.setdefault("flush_interval", 5.0)
    out = []
    for w, sock, ipset in _writers(**kw):
        for ip, t in entries:
            w.enqueue(ip, t)
        w.close()
        assert not w._thread.is_alive() and w.queue_depth() == 0
        out.append((sock.sent, sorted(ipset.added), _counters(w)))
    return out


ENTRIES = [("10.0.0.1", 300), ("10.0.0.2", 60), ("2001:db8::1", 60), ("10.0.0.3", 300),
           ("garbage", 10), ("10.0.0.4", 600)]


@pytest.mark.parametrize("case, kw", [
    ("coalesced", {}),
    ("socket fails", {"sock_kw": {"fail": True}}),
    ("nack", {"sock_kw": {"nack": 1}}),
    ("breaker open", {"open_breaker": True}),
    ("fallback fails too", {"sock_kw": {"fail": True}, "ipset_kw": {"fail": True}}),
    ("overflow sheds the oldest", {"max_queue": 3}),
])
def test_writer_matches_jax(case, kw):
    port, jax = _run_both(ENTRIES, **kw)
    assert port == jax, case
    frames, fallback, counters = port
    if case == "coalesced":
        assert len(frames) == 1 and counters["batch_sends_total"] == 1
        assert counters["batch_entries_total"] == 4 and fallback == [("2001:db8::1", 60),
                                                                     ("garbage", 10)]
    if case == "overflow sheds the oldest":
        assert counters["queue_shed_total"] == 3
        assert _entries(frames) == [("10.0.0.3", 300), ("10.0.0.4", 600)]
        assert fallback == [("garbage", 10)]


def test_writer_failpoint_falls_back_as_jax():
    port_fp.arm("ipset.netlink.send", "error", count=1)
    jax_fp.arm("ipset.netlink.send", "error", count=1)
    port, jax = _run_both(ENTRIES[:2])
    assert port == jax
    assert port[0] == [] and port[1] == sorted(ENTRIES[:2])
    assert port[2]["errors"] == {"netlink": 1}


def test_writer_concurrent_producers_lose_nothing():
    entries = [(f"10.{p}.{i // 250}.{i % 250}", 60 + p) for p in range(4) for i in range(300)]
    sent = []
    for w, sock, ipset in _writers(flush_interval=0.005, max_queue=100_000):
        threads = [threading.Thread(target=lambda p=p: [w.enqueue(*e) for e in entries[p::4]])
                   for p in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        w.close()
        c = _counters(w)
        assert c["batch_entries_total"] == len(entries) and c["errors_total"] == 0
        assert c["queue_shed_total"] == 0 and ipset.added == []
        sent.append(_entries(sock.sent))
    assert sent[0] == sent[1] == sorted(entries)


def test_writer_depth_gauge_and_activity():
    (w, _, _), (jw, _, _) = _writers(flush_interval=5.0)
    try:
        assert w.stats.active() and jw.stats.active()
        w.enqueue("10.0.0.1", 1)
        jw.enqueue("10.0.0.1", 1)
        assert w.stats.prom_snapshot()["queue_depth"] == 1 == jw.stats.prom_snapshot()["queue_depth"]
    finally:
        w.close()
        jw.close()
    assert not IpsetStats().active()


# ------------------------------------------------------------ init_ipset


class _Recorder:
    def __init__(self, codes):
        self.calls, self.codes = [], dict(codes)

    def __call__(self, args):
        self.calls.append(list(args))
        return self.codes.get(tuple(args[:2]), 0), "out"


@pytest.mark.parametrize("codes", [
    {},                                      # the rule is there already
    {("iptables", "-C"): 1},                 # inserted
    {("ipset", "create"): 1},                # the set cannot be made
    {("iptables", "-C"): 1, ("iptables", "-I"): 1},  # the insert fails
])
def test_init_ipset_runs_the_jax_commands(codes, monkeypatch):
    results = []
    for mod in (port_ipset, jax_ipset):
        rec = _Recorder(codes)
        monkeypatch.setattr(mod, "_run", rec)
        try:
            inst = mod.init_ipset(600, False)
            out = ("ok", inst.name)
        except mod.IpsetError as e:
            out = ("error", str(e))
        results.append((list(rec.calls), out))
        rec.calls.clear()
        assert mod.init_ipset(600, True) is None and rec.calls == []
    assert results[0] == results[1]
    assert results[0][0][0] == ["ipset", "create", "banjax_ipset", "hash:ip", "timeout", "600",
                                "-exist"]


def test_instance_parses_the_list_and_raises_as_jax(monkeypatch):
    listing = "Name: banjax_ipset\nType: hash:ip\nMembers:\n1.2.3.4 timeout 298\n\n5.6.7.8 timeout 5\n"
    outs = []
    for mod in (port_ipset, jax_ipset):
        monkeypatch.setattr(mod, "_run", lambda args: (0 if args[1] != "del" else 1, listing))
        inst = mod.IpsetInstance()
        with pytest.raises(mod.IpsetError) as err:
            inst.delete("1.2.3.4")
        outs.append((inst.list_entries(), inst.test("1.2.3.4"), str(err.value)))
    assert outs[0] == outs[1] and outs[0][0] == ["1.2.3.4 timeout 298", "5.6.7.8 timeout 5"]


def test_subprocess_shim_runs_the_binaries_on_path(tmp_path, monkeypatch):
    """The real `_run` through stand-in `ipset` and `iptables` scripts put
    first on PATH: the calls a ban stream makes, as the JAX shim makes
    them."""
    calls = tmp_path / "calls"
    for name in ("ipset", "iptables"):
        script = tmp_path / name
        script.write_text(f'#!/bin/sh\necho "{name} $*" >> "{calls}"\n'
                          '[ "$1" = "test" ] && exit 1\n[ "$1" = "-C" ] && exit 1\nexit 0\n')
        script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    seen = []
    for mod in (port_ipset, jax_ipset):
        calls.write_text("")
        inst = mod.init_ipset(600, False)
        inst.add("10.0.0.1", 600)
        assert inst.test("10.0.0.1") is False
        seen.append(calls.read_text().splitlines())
    assert seen[0] == seen[1] == [
        "ipset create banjax_ipset hash:ip timeout 600 -exist",
        "iptables -C INPUT -m set --match-set banjax_ipset src -j DROP",
        "iptables -I INPUT 1 -m set --match-set banjax_ipset src -j DROP",
        "ipset add banjax_ipset 10.0.0.1 timeout 600 -exist",
        "ipset test banjax_ipset 10.0.0.1",
    ]


# ------------------------------------------------------------ the Banner


class RecordingIpset:
    """An IpsetInstance stand-in that keeps the set and records calls."""

    name = "banjax_ipset"

    def __init__(self):
        self.calls, self.members = [], set()

    def add(self, ip, timeout):
        self.calls.append(("add", ip, timeout))
        self.members.add(ip)

    def test(self, ip):
        self.calls.append(("test", ip))
        return ip in self.members

    def list_entries(self):
        return [f"{ip} timeout 1" for ip in sorted(self.members)]

    def delete(self, ip):
        self.calls.append(("del", ip))
        self.members.discard(ip)


BAN_STREAM = [
    ("10.0.0.1", "IptablesBlock"), ("10.0.0.1", "IptablesBlock"), ("127.0.0.1", "IptablesBlock"),
    ("10.0.0.2", "NginxBlock"), ("10.0.0.3", "Challenge"), ("2001:db8::7", "IptablesBlock"),
    ("10.0.0.4", "IptablesBlock"), ("10.0.0.2", "IptablesBlock"),
]


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("standalone", [False, True])
def test_one_ban_stream_makes_the_jax_ipset_calls(batched, standalone):
    text = yaml.safe_dump({"iptables_ban_seconds": 600, "expiring_decision_ttl_seconds": 60,
                           "standalone_testing": standalone})
    runs = []
    for cfg, lists, banner_mod, dec, nl in (
        (config_from_yaml_text(text), DynamicDecisionLists(start_sweeper=False), port_banner_mod,
         Decision, port_nl),
        (jax_config(text), JaxDynamicLists(start_sweeper=False), jax_banner_mod, JaxDecision,
         jax_nl),
    ):
        ipset = RecordingIpset()
        writer = None
        if batched:
            writer = nl.IpsetBatchWriter(ipset, flush_interval=5.0)
            sock = FakeSock()
            writer._socket = lambda: sock
        banner = banner_mod.Banner(lists, None, None, ipset_instance=ipset, netlink_writer=writer)
        for ip, d in BAN_STREAM:
            banner.ban_or_challenge_ip(cfg, ip, dec[_DECISIONS[d]], "example.com")
        if writer is not None:
            writer.close()
            ipset.calls.append(("netlink", _entries(sock.sent)))
        bans = list(ipset.calls)
        runs.append((bans, banner.ipset_test(cfg, "10.0.0.1"), banner.ipset_list()))
        banner.ipset_del("10.0.0.4")
        runs[-1] += (ipset.calls[-1], banner.ipset_batching)
        lists.close()
    assert runs[0] == runs[1]
    added = [c for c in runs[0][0] if c[0] == "add"] + [
        e for c in runs[0][0] if c[0] == "netlink" for e in c[1]]
    # standalone testing adds nothing; otherwise every IPv4 IptablesBlock
    # but localhost reaches the set (IPv6 through the fallback when batched)
    assert bool(added) is not standalone


_DECISIONS = {"IptablesBlock": "IPTABLES_BLOCK", "NginxBlock": "NGINX_BLOCK",
              "Challenge": "CHALLENGE"}


def test_a_banner_without_ipset_answers_as_jax():
    text = yaml.safe_dump({"iptables_ban_seconds": 600})
    port = port_banner_mod.Banner(DynamicDecisionLists(start_sweeper=False), None, None)
    jax = jax_banner_mod.Banner(JaxDynamicLists(start_sweeper=False), None, None, None)
    for b, cfg in ((port, config_from_yaml_text(text)), (jax, jax_config(text))):
        b.ipset_add(cfg, "10.0.0.1")
        b.ipset_del("10.0.0.1")
        assert (b.ipset_test(cfg, "10.0.0.1"), b.ipset_list(), b.ipset_batching) == \
            (False, [], False)
        b.decision_lists.close()


def test_writer_close_is_prompt():
    (w, _, _), (jw, _, _) = _writers(flush_interval=5.0)
    t0 = time.monotonic()
    w.close()
    jw.close()
    assert time.monotonic() - t0 < 2.0
