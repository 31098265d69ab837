"""dryrun_fabric harness: N real worker processes, real sockets, one box
(a port of `banjax_tpu/fabric/harness.py`).

The harness spawns N `python -m banjax_tpu_torch.fabric.worker` processes
(each a FULL engine — TorchMatcher with device windows, pipeline
scheduler — with its own CUDA context on the card, or on the CPU when the
harness is asked for it: `device="cpu"` passes `--device cpu` on), wires
them into a fabric over real TCP sockets plus an in-process Kafka broker
(`ingest/broker_standin.KafkaBrokerStandIn`) for decision replication, and
feeds a scenario shape round-robin at the workers.  Each worker routes
non-owned lines to the owning shard itself, so worker→worker socket
traffic is real, not simulated.

The chaos move is a mid-flood SIGKILL of one worker.  Detection is a
failed send; recovery is deterministic journal replay from BOTH sides:

  * the harness broadcasts T_PEER_DOWN so every survivor replays its
    own forward-journal for the victim (lines survivors had routed to
    it), and
  * the harness replays its per-worker chunk journal (chunks it had fed
    the victim directly).

The two journals are disjoint line sets whose union is every line the
victim ever held, so the consistent-hash successors re-derive every
ban the victim would have emitted: recall vs the oracle is 1.0, by
construction, with a shard killed mid-flood.  Double-processing can
only ADD bans (precision is reported, recall is gated).  A frame whose
ack comes later than the pipe's deadline is sent again and drained
twice (the JAX semantics, kept): the report counts resent frames and
the survivors' lines received beyond what was fed to them.

Accounting is the fabric-wide ledger: every harness chunk is acked by a
live worker (fed == acked), every worker satisfies
admitted == processed + shed + drain_errors (pipeline) and
local + forwarded + shed + replay_skipped == received + replayed
(fabric) — admitted work is processed or counted shed, never silently
lost.  Harness-replayed chunks carry `replay: true` so the receiving
router skips lines whose pre-death owner is still alive (they were
processed once already — re-routing them double-counts rate-limit hits
and mints duplicate bans).

The `transport` knob picks the worker-to-worker data path: "json" is
the synchronous per-group path (the differential oracle), "v2" the
pipelined binary frame path over TCP, "shm" the same frames over
co-located shared-memory rings.  `run_forward_path` is the transport
micro-benchmark: two shards, every line owned by the remote peer, so
the measured rate is pure forwarding.

Every report carries `launches`: kernels A, B and C launched in the
workers (each worker's last T_STATS, the leaver's T_LEAVE ack).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from banjax_tpu_torch.fabric import wire
from banjax_tpu_torch.fabric.peer import PeerClient, PeerUnavailable

_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# harness→worker requests ride the same PeerClient as worker→worker
# forwards; the harness's timeout must cover a synchronous takeover
# (grace + full journal replay) behind a T_PEER_DOWN ack
_HARNESS_TIMEOUT_MS = 120_000.0


class _Worker:
    """One spawned shard process + the harness's client to it."""

    def __init__(self, wid: str, proc: subprocess.Popen):
        self.wid = wid
        self.proc = proc
        self.port: Optional[int] = None
        self.client: Optional[PeerClient] = None
        self.ready_error: Optional[str] = None
        self.ready_info: Dict[str, object] = {}

    def read_ready(self, timeout_s: float) -> None:
        """Block until the worker prints its READY line (post-warmup,
        post-kafka-attach) — in a thread so N workers warm in parallel."""
        result: Dict[str, object] = {}

        def _read():
            for raw in iter(self.proc.stdout.readline, b""):
                try:
                    msg = json.loads(raw)
                except ValueError:
                    continue  # stray non-JSON noise on stdout
                if isinstance(msg, dict) and "ready" in msg:
                    result.update(msg)
                    return

        t = threading.Thread(target=_read, daemon=True)
        t.start()
        t.join(timeout_s)
        if not result.get("ready"):
            self.ready_error = str(
                result.get("error") or f"no READY within {timeout_s}s"
            )
            return
        self.ready_info = dict(result)
        self.port = int(result["port"])
        self.client = PeerClient(
            self.wid, "127.0.0.1", self.port,
            send_timeout_ms=_HARNESS_TIMEOUT_MS, max_attempts=2,
        )

    def request(self, ftype: int, payload: dict) -> dict:
        assert self.client is not None, f"{self.wid} has no client"
        _rtype, rpayload = self.client.request(ftype, payload)
        return rpayload

    def kill(self) -> None:
        self.proc.kill()

    def shutdown(self) -> None:
        try:
            if self.client is not None:
                self.client.request(wire.T_SHUTDOWN, {})
        except OSError:
            pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=5)
        if self.client is not None:
            self.client.close()


def _spawn(wid: str, broker_port: int, stderr_path: Optional[str],
           extra_args: Tuple[str, ...] = (),
           device: Optional[str] = None) -> _Worker:
    """Start one worker: on the card (the worker's default, `cuda:0`)
    unless `device` names another (`--device cpu` for a CPU run, whose
    workers take one intra-op thread each beside their peers)."""
    env = dict(os.environ)
    if device is not None:
        extra_args = ("--device", device, *extra_args)
        if device == "cpu":
            env.setdefault("OMP_NUM_THREADS", "1")
    if stderr_path:
        os.makedirs(os.path.dirname(stderr_path), exist_ok=True)
        stderr = open(stderr_path, "ab")
    else:
        stderr = subprocess.DEVNULL
    proc = subprocess.Popen(
        [sys.executable, "-m", "banjax_tpu_torch.fabric.worker",
         "--node-id", wid, "--broker-port", str(broker_port),
         *extra_args],
        stdout=subprocess.PIPE, stderr=stderr, cwd=_REPO, env=env,
    )
    return _Worker(wid, proc)


class FabricDryrun:
    """One dryrun episode.  `run()` returns the report dict; every
    invariant it computes is in report["invariants"] (all must hold)."""

    def __init__(
        self,
        n_workers: int = 2,
        shape: str = "flash_crowd",
        seed: int = 20260804,
        scale: float = 1.0,
        kill: bool = True,
        rejoin: bool = False,
        churn: bool = False,
        gossip_interval_ms: float = 250.0,
        suspect_timeout_ms: float = 1200.0,
        kill_frac: float = 0.45,
        ready_timeout_s: float = 420.0,
        settle_timeout_s: float = 120.0,
        log_dir: Optional[str] = None,
        transport: str = "v2",
        inflight_frames: int = 8,
        fleet_obs: bool = False,
        device: Optional[str] = None,
    ):
        if transport not in ("json", "v2", "shm"):
            raise ValueError(f"unknown transport {transport!r}")
        self.schedule = None
        if churn:
            from banjax_tpu_torch.scenarios.chaos import MembershipChurnSchedule

            kill, rejoin = True, False  # churn runs its own join phase
            self.schedule = MembershipChurnSchedule(seed)
            kill_frac = self.schedule.kill_frac
        if kill and n_workers < 2:
            raise ValueError("kill needs n_workers >= 2")
        self.n_workers = n_workers
        self.shape = shape
        self.seed = seed
        self.scale = scale
        self.kill = kill
        self.rejoin = rejoin
        self.churn = churn
        self.gossip_interval_ms = gossip_interval_ms
        self.suspect_timeout_ms = suspect_timeout_ms
        self.kill_frac = kill_frac
        self.transport = transport
        self.inflight_frames = inflight_frames
        # fleet observability drill arm: workers propagate origin trace
        # context on every forward and serve the T_EXPLAIN/T_FLIGHTREC/
        # T_STATS-metrics fleet surface — decisions must not change
        self.fleet_obs = fleet_obs
        self.device = device
        self.ready_timeout_s = ready_timeout_s
        self.settle_timeout_s = settle_timeout_s
        self.log_dir = log_dir
        self.workers: Dict[str, _Worker] = {}
        self.alive: List[str] = []
        self.victim: Optional[str] = None
        # harness-side journal: every chunk acked per worker, so the
        # harness can replay a dead worker's direct feed
        self._journal: Dict[str, List[List[str]]] = {}
        self._rr = 0
        self.fed_lines = 0
        self.acked_lines = 0
        self.takeover: Dict[str, object] = {}
        # churn mode: per-survivor kill -> gossip-confirmed-dead seconds
        self.detection: Dict[str, float] = {}
        # each worker's launch counts and resends as of its last T_STATS
        # (or its T_LEAVE ack): a killed worker keeps what it last said
        self._last_seen: Dict[str, dict] = {}

    # ---- plumbing ----

    def _stats(self, wid: str) -> dict:
        snap = self.workers[wid].request(wire.T_STATS, {})
        self._note_seen(wid, snap)
        return snap

    def _note_seen(self, wid: str, snap: dict) -> None:
        self._last_seen[wid] = {"launches": dict(snap.get("launches") or {}),
                                "resent": dict(snap.get("resent") or {})}

    def _totals(self) -> dict:
        """Kernel launches and resent frames/lines summed over every
        worker this run started."""
        launches: Dict[str, int] = {}
        resent = {"frames": 0, "lines": 0}
        for seen in self._last_seen.values():
            for k, v in seen["launches"].items():
                launches[k] = launches.get(k, 0) + int(v)
            for k in resent:
                resent[k] += int(seen["resent"].get(k, 0))
        return {"launches": launches, "resent": resent}

    def _broadcast(self, ftype: int, payload: dict,
                   only: Optional[List[str]] = None) -> None:
        for wid in list(only if only is not None else self.alive):
            self.workers[wid].request(ftype, payload)

    def _send_chunk(self, lines: List[str], count_ack: bool = True,
                    replay: bool = False) -> str:
        """Round-robin one chunk at a live worker; a dead target turns
        into detection + takeover + reroute, never a lost chunk.
        Replayed chunks pass count_ack=False (the victim already acked
        them once, so the fed==acked ledger counts each chunk once) and
        replay=True (the receiving router skips lines whose pre-death
        owner is still alive — the duplicate-ban dedupe)."""
        while True:
            if not self.alive:
                raise RuntimeError("no live workers left")
            target = self.alive[self._rr % len(self.alive)]
            self._rr += 1
            try:
                payload = {"lines": lines, "route": True}
                if replay:
                    payload["replay"] = True
                self.workers[target].request(wire.T_LINES, payload)
            except (PeerUnavailable, OSError):
                self._on_death(target)
                continue
            self._journal[target].append(lines)
            if count_ack:
                self.acked_lines += len(lines)
            return target

    def _on_death(self, wid: str) -> None:
        """A send to `wid` failed: declare it dead fabric-wide and
        replay the harness's direct feed to the survivors."""
        if wid not in self.alive:
            return
        self.alive.remove(wid)
        t0 = time.perf_counter()
        pre = {w: self._stats(w) for w in self.alive}
        # survivors schedule their forward-journal replays behind the
        # deadline-polled grace — the ack returns promptly, so wait for
        # the takeovers to actually complete before auditing the window
        self._broadcast(wire.T_PEER_DOWN, {"peer": wid})
        self._await_takeovers(wid)
        replayed = 0
        for chunk in self._journal[wid]:
            self._send_chunk(chunk, count_ack=False, replay=True)
            replayed += len(chunk)
        self._journal[wid] = []
        post = {w: self._stats(w) for w in self.alive}

        def _shed(snap: dict) -> int:
            return int(snap["sched"]["PipelineShedLines"]) + int(
                snap["fabric"]["FabricShedLines"]
            )

        shed_in_window = sum(
            _shed(post[w]) - _shed(pre[w]) for w in post
        )
        survivor_replayed = sum(
            int(post[w]["fabric"]["FabricReplayedLines"])
            - int(pre[w]["fabric"]["FabricReplayedLines"])
            for w in post
        )
        fed_in_window = replayed + survivor_replayed
        self.takeover = {
            "victim": wid,
            "detect_after_lines": self.fed_lines,
            "harness_replayed_lines": replayed,
            "survivor_replayed_lines": survivor_replayed,
            "shed_in_window": shed_in_window,
            "fed_in_window": fed_in_window,
            "shed_ratio_in_window": round(
                shed_in_window / max(1, fed_in_window), 6
            ),
            "window_s": round(time.perf_counter() - t0, 3),
        }

    def _await_takeovers(self, victim: str, timeout_s: float = 60.0) -> None:
        """Block until every live worker has removed `victim` from its
        alive set AND completed (not merely scheduled) any pending
        takeover — mark_dead no longer replays inline."""
        deadline = time.monotonic() + timeout_s
        while True:
            done = True
            for w in self.alive:
                r = self._stats(w).get("router") or {}
                if victim in (r.get("alive") or ()) or r.get(
                    "pending_takeovers"
                ):
                    done = False
                    break
            if done:
                return
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"takeover of {victim} never completed on {w}"
                )
            time.sleep(0.05)

    def _settle(self, tagged_floor: Optional[int] = None,
                skip_kafka_check: Optional[List[str]] = None) -> None:
        """FLUSH everyone, then poll STATS until counters quiesce (and
        each long-lived worker has consumed every fabric-tagged command
        the broker holds — suppressed + applied covers the topic)."""
        self._broadcast(wire.T_FLUSH, {"timeout": 600})
        deadline = time.monotonic() + self.settle_timeout_s
        stable, prev = 0, None
        skip = set(skip_kafka_check or ())
        while stable < 3:
            if time.monotonic() > deadline:
                raise RuntimeError(f"fabric settle timed out: {prev}")
            snaps = {w: self._stats(w) for w in self.alive}
            kafka_ok = True
            if tagged_floor is not None:
                tagged = self._tagged_commands()
                for w, s in snaps.items():
                    if w in skip:
                        continue
                    seen = int(
                        s["fabric"]["FabricDuplicatesSuppressed"]
                    ) + int(s["fabric"]["FabricReplicatedApplied"])
                    if seen < tagged:
                        kafka_ok = False
            key = tuple(
                (w,
                 s["sched"]["PipelineAdmittedLines"],
                 s["sched"]["PipelineProcessedLines"],
                 s["sched"]["PipelineShedLines"],
                 len(s["bans"]),
                 s["fabric"]["FabricReplicatedApplied"],
                 s["fabric"]["FabricDuplicatesSuppressed"])
                for w, s in sorted(snaps.items())
            )
            if key == prev and kafka_ok:
                stable += 1
            else:
                stable = 0
            prev = key
            time.sleep(0.2)

    def _tagged_commands(self) -> int:
        log = self.broker.messages("fabric.commands")
        return sum(
            1 for m in log
            if b"fabric_origin" in m and b"fabric_ping" not in m
        )

    # ---- the run ----

    def run(self) -> dict:
        from banjax_tpu_torch.config import config_from_yaml_text
        from banjax_tpu_torch.ingest.broker_standin import KafkaBrokerStandIn
        from banjax_tpu_torch.scenarios import oracle as oracle_mod
        from banjax_tpu_torch.scenarios.shapes import LineChunk, generate

        sc = generate(self.shape, self.seed, self.scale)
        chunks = [
            list(ev.lines) for ev in sc.events if isinstance(ev, LineChunk)
        ]
        n_lines = sum(len(c) for c in chunks)

        self.broker = KafkaBrokerStandIn().start()
        wids = [f"w{i}" for i in range(self.n_workers)]
        try:
            return self._run_inner(sc, chunks, n_lines, wids,
                                   config_from_yaml_text, oracle_mod)
        finally:
            for w in self.workers.values():
                w.shutdown()
            self.broker.stop()

    def _hello_payload(self) -> dict:
        payload = {
            "peers": {
                w.wid: ["127.0.0.1", w.port]
                for w in self.workers.values() if w.port is not None
            },
            "vnodes": 64,
            "send_timeout_ms": 2000.0,
            "grace_ms": 200.0,
            # worker-to-worker data path ("json" = inflight 0, the
            # synchronous oracle)
            "inflight_frames": (
                0 if self.transport == "json" else self.inflight_frames
            ),
            "wire_v2": self.transport != "json",
            "shm": self.transport == "shm",
            "trace_propagation": self.fleet_obs,
        }
        if self.churn:
            payload.update({
                "gossip_interval_ms": self.gossip_interval_ms,
                "suspect_timeout_ms": self.suspect_timeout_ms,
                "indirect_probes": 2,
            })
        return payload

    def _spawn_and_hello(self, wids: List[str]) -> None:
        for wid in wids:
            err_path = (
                os.path.join(self.log_dir, f"{wid}.err")
                if self.log_dir else None
            )
            extra = (
                ("--trace-propagation", "1") if self.fleet_obs else ()
            )
            self.workers[wid] = _spawn(
                wid, self.broker.port, err_path, extra_args=extra,
                device=self.device,
            )
        threads = [
            threading.Thread(
                target=w.read_ready, args=(self.ready_timeout_s,),
                daemon=True,
            )
            for w in self.workers.values() if w.wid in wids
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.ready_timeout_s + 5)
        bad = [
            f"{w.wid}: {w.ready_error}"
            for w in self.workers.values() if w.wid in wids and w.port is None
        ]
        if bad:
            raise RuntimeError(f"workers failed to start: {bad}")

    def _run_inner(self, sc, chunks, n_lines, wids,
                   config_from_yaml_text, oracle_mod) -> dict:
        self._spawn_and_hello(wids)
        self.alive = list(wids)
        self._journal = {w: [] for w in wids}
        hello = self._hello_payload()
        self._broadcast(wire.T_HELLO, hello)
        base = {w: self._stats(w) for w in self.alive}

        kill_at = (
            int(self.kill_frac * len(chunks)) if self.kill else -1
        )
        self.victim = wids[-1] if self.kill else None

        t_feed = time.perf_counter()
        for i, chunk in enumerate(chunks):
            if i == kill_at and self.victim in self.alive:
                if self.churn:
                    # churn mode: SIGKILL with the feed PAUSED — no
                    # forwarded line ever touches the victim again, so
                    # detection is gossip's alone (the acceptance gate)
                    self._churn_kill()
                else:
                    # SIGKILL mid-flood: no goodbye, no flush — the next
                    # send to it is the detection
                    self.workers[self.victim].kill()
            self._send_chunk(chunk)
            self.fed_lines += len(chunk)
        # a victim killed on the very last chunks may never be hit by
        # the round-robin again: force detection so takeover happens
        if self.victim is not None and self.victim in self.alive:
            try:
                self.workers[self.victim].request(wire.T_PING, {})
            except (PeerUnavailable, OSError):
                self._on_death(self.victim)
        self._settle(tagged_floor=0)
        # second settle pass with the final tagged count: every
        # survivor must have consumed the whole replicated topic
        self._settle(tagged_floor=self._tagged_commands())
        feed_s = max(1e-9, time.perf_counter() - t_feed)

        final = {w: self._stats(w) for w in self.alive}
        report = self._report(
            sc, n_lines, feed_s, base, final,
            config_from_yaml_text, oracle_mod,
        )
        if self.rejoin and self.victim is not None:
            report["rejoin"] = self._rejoin_phase()
        if self.churn:
            report["join"] = self._join_phase()
            report["suspect_refute"] = self._suspect_refute_phase()
            report["leave"] = self._leave_phase()
            if self.schedule is not None:
                self.schedule.record("kill", dict(self.takeover))
                self.schedule.record("join", {
                    k: v for k, v in report["join"].items()
                    if k != "invariants"
                })
                self.schedule.record(
                    "slow_node",
                    {k: v for k, v in report["suspect_refute"].items()
                     if k != "invariants"},
                )
                self.schedule.record("leave", {
                    k: v for k, v in report["leave"].items()
                    if k != "invariants"
                })
                report["churn_schedule"] = self.schedule.rows()
            report["invariants"].update({
                f"join_{k}": v
                for k, v in report["join"]["invariants"].items()
            })
            report["invariants"].update({
                f"churn_{k}": v
                for k, v in report["suspect_refute"]["invariants"].items()
            })
            report["invariants"].update({
                f"leave_{k}": v
                for k, v in report["leave"]["invariants"].items()
            })
        report.update(self._totals())
        return report

    # ---- rejoin / handback ----

    def _rejoin_phase(self) -> dict:
        from banjax_tpu_torch.scenarios.shapes import LineChunk, generate

        victim = self.victim
        survivor = self.alive[0]
        # warm-start state for the newcomer: a survivor's decision
        # snapshot, applied idempotently over the wire
        snap = self.workers[survivor].request(wire.T_SNAPSHOT, {})
        self._spawn_and_hello([victim])
        newcomer = self.workers[victim]
        newcomer.request(wire.T_HELLO, self._hello_payload())
        sync_ack = newcomer.request(
            wire.T_SYNC, {"decisions": snap["decisions"]}
        )
        # handback is pure membership: ring recomputation, NO replay
        self._broadcast(
            wire.T_PEER_UP,
            {"peer": victim, "host": "127.0.0.1", "port": newcomer.port},
        )
        self.alive.append(victim)

        base = {w: self._stats(w) for w in self.alive}
        wave = generate(self.shape, self.seed + 1,
                        max(0.25, self.scale * 0.25))
        wave_chunks = [
            list(ev.lines) for ev in wave.events
            if isinstance(ev, LineChunk)
        ]
        wave_lines = sum(len(c) for c in wave_chunks)
        for chunk in wave_chunks:
            self._send_chunk(chunk)
            self.fed_lines += len(chunk)
        # the rejoined worker's reader attached at the topic tail; the
        # whole-topic floor only applies to the original survivors
        self._settle(tagged_floor=self._tagged_commands(),
                     skip_kafka_check=[victim])
        final = {w: self._stats(w) for w in self.alive}

        def _local(w: str) -> int:
            return int(final[w]["fabric"]["FabricLocalLines"]) - int(
                base[w]["fabric"]["FabricLocalLines"]
            )

        locals_sum = sum(_local(w) for w in self.alive)
        return {
            "snapshot_decisions": len(snap["decisions"]),
            "sync_applied": int(sync_ack.get("applied", 0)),
            "wave_lines": wave_lines,
            "wave_locals_sum": locals_sum,
            "newcomer_local_lines": _local(victim),
            "invariants": {
                # every handed-back line processed EXACTLY once
                # fabric-wide — no double-processing on rejoin
                "wave_exactly_once": locals_sum == wave_lines,
                "newcomer_took_lines": _local(victim) > 0,
                "sync_idempotent_applied":
                    int(sync_ack.get("applied", 0))
                    == len(snap["decisions"]),
            },
        }

    # ---- membership churn (gossip mode) ----

    def _member_status(self, observer: str, target: str) -> Optional[str]:
        snap = self._stats(observer)
        members = (snap.get("membership") or {}).get("members") or {}
        entry = members.get(target)
        return entry.get("status") if entry else None

    def _churn_kill(self) -> None:
        """SIGKILL the victim with the feed paused: detection must come
        from the gossip probe schedule alone (no forwarded line ever
        fails against it).  Returns once every survivor has confirmed
        the death AND completed its takeover."""
        victim = self.victim
        self.workers[victim].kill()
        t_kill = time.monotonic()
        self.alive.remove(victim)  # the harness stops feeding it; NO broadcast
        pre = {w: self._stats(w) for w in self.alive}
        suspect_s = self.suspect_timeout_ms / 1000.0
        interval_s = self.gossip_interval_ms / 1000.0
        # worst case: full probe rotation to reach the victim, a failed
        # direct + indirect round, then the suspicion window — plus CI
        # slack (the measured distribution is what gets banked)
        deadline = t_kill + suspect_s + interval_s * (
            len(self.alive) + 6
        ) + 30.0
        confirmed: Dict[str, float] = {}
        while len(confirmed) < len(self.alive):
            if time.monotonic() > deadline:
                missing = [w for w in self.alive if w not in confirmed]
                raise RuntimeError(
                    f"gossip never confirmed {victim} dead on {missing}"
                )
            for w in self.alive:
                if w in confirmed:
                    continue
                if self._member_status(w, victim) in ("dead", "left"):
                    confirmed[w] = round(time.monotonic() - t_kill, 3)
            time.sleep(0.05)
        self.detection = confirmed
        self._await_takeovers(victim)
        # the harness's own direct-feed journal for the victim
        replayed = 0
        for chunk in self._journal[victim]:
            self._send_chunk(chunk, count_ack=False, replay=True)
            replayed += len(chunk)
        self._journal[victim] = []
        post = {w: self._stats(w) for w in self.alive}
        survivor_replayed = sum(
            int(post[w]["fabric"]["FabricReplayedLines"])
            - int(pre[w]["fabric"]["FabricReplayedLines"])
            for w in post
        )
        self.takeover = {
            "victim": victim,
            "mode": "gossip",
            "detect_after_lines": self.fed_lines,
            "detect_s": dict(confirmed),
            "max_detect_s": max(confirmed.values()),
            "suspect_timeout_s": suspect_s,
            "gossip_interval_s": interval_s,
            "harness_replayed_lines": replayed,
            "survivor_replayed_lines": survivor_replayed,
            "window_s": round(time.monotonic() - t_kill, 3),
        }

    def _join_phase(self) -> dict:
        """Automatic join: a brand-new worker announces itself to ONE
        live member (T_JOIN + snapshot pull, no harness HELLO, no
        PEER_UP broadcast) and the fleet discovers it by gossip — then
        a feed wave proves exactly-once handoff of its new ranges."""
        from banjax_tpu_torch.scenarios.shapes import LineChunk, generate

        nid = f"w{self.n_workers}"
        seed_worker = self.workers[self.alive[0]]
        err_path = (
            os.path.join(self.log_dir, f"{nid}.err")
            if self.log_dir else None
        )
        extra = [
            "--join", f"127.0.0.1:{seed_worker.port}",
            "--gossip-interval-ms", str(self.gossip_interval_ms),
            "--suspect-timeout-ms", str(self.suspect_timeout_ms),
            "--grace-ms", "200.0",
        ]
        if self.transport == "json":
            extra += ["--inflight-frames", "0", "--wire-v2", "0"]
        elif self.transport == "shm":
            extra += ["--shm", "1"]
        newcomer = _spawn(
            nid, self.broker.port, err_path, extra_args=tuple(extra),
            device=self.device,
        )
        self.workers[nid] = newcomer
        newcomer.read_ready(self.ready_timeout_s)
        if newcomer.port is None:
            raise RuntimeError(f"join worker failed: {newcomer.ready_error}")
        # the fleet must converge on the newcomer WITHOUT any broadcast:
        # the seed learned it from T_JOIN, everyone else from gossip
        deadline = time.monotonic() + 60.0
        while any(
            self._member_status(w, nid) != "alive" for w in self.alive
        ):
            if time.monotonic() > deadline:
                raise RuntimeError(f"fleet never converged on joiner {nid}")
            time.sleep(0.05)
        self.alive.append(nid)
        self._journal[nid] = []

        base = {w: self._stats(w) for w in self.alive}
        wave = generate(self.shape, self.seed + 1,
                        max(0.25, self.scale * 0.25))
        wave_chunks = [
            list(ev.lines) for ev in wave.events
            if isinstance(ev, LineChunk)
        ]
        wave_lines = sum(len(c) for c in wave_chunks)
        for chunk in wave_chunks:
            self._send_chunk(chunk)
            self.fed_lines += len(chunk)
        # the joiner's kafka reader attached at the topic tail
        self._settle(tagged_floor=self._tagged_commands(),
                     skip_kafka_check=[nid])
        final = {w: self._stats(w) for w in self.alive}

        def _local(w: str) -> int:
            cur = int(final[w]["fabric"]["FabricLocalLines"])
            prev = int(base[w]["fabric"]["FabricLocalLines"]) \
                if w in base else 0
            return cur - prev

        locals_sum = sum(_local(w) for w in self.alive)
        synced = int(newcomer.ready_info.get("synced", 0))
        return {
            "joiner": nid,
            "seed_member": seed_worker.wid,
            "synced_decisions": synced,
            "wave_lines": wave_lines,
            "wave_locals_sum": locals_sum,
            "joiner_local_lines": _local(nid),
            "invariants": {
                "wave_exactly_once": locals_sum == wave_lines,
                "joiner_took_lines": _local(nid) > 0,
                "snapshot_synced": synced > 0,
                "no_survivor_restart": True,  # by construction: no
                # respawn, no HELLO re-push — convergence was gossip
            },
        }

    def _suspect_refute_phase(self) -> dict:
        """Slow-node cycle: arm a sleep failpoint on one member's gossip
        ack path so every probe against it times out — the fleet must
        SUSPECT it, and once disarmed the member must refute its own
        suspicion (incarnation bump) and return to ALIVE everywhere.
        Confirmed-dead during the window is tolerated (a slow node CAN
        time out — refute-after-dead heals it; recall is unaffected)."""
        target = self.alive[-1]
        observers = [w for w in self.alive if w != target]
        pre = {w: self._stats(w) for w in self.alive}
        delay_x = self.schedule.slow_delay_x if self.schedule else 3.0
        self.workers[target].request(wire.T_FAILPOINT, {
            "name": "fabric.gossip.ack", "mode": "sleep",
            "delay_s": (self.gossip_interval_ms / 1000.0) * delay_x,
        })
        suspected = False
        deadline = time.monotonic() + 60.0
        while not suspected and time.monotonic() < deadline:
            for w in observers:
                snap = self._stats(w)
                d = int(snap["fabric"]["FabricMembershipSuspects"]) - int(
                    pre[w]["fabric"]["FabricMembershipSuspects"]
                )
                if d >= 1:
                    suspected = True
                    break
            time.sleep(0.05)
        self.workers[target].request(wire.T_FAILPOINT, {
            "name": "fabric.gossip.ack", "disarm": True,
        })
        deadline = time.monotonic() + 60.0
        while any(
            self._member_status(w, target) != "alive" for w in observers
        ):
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"{target} never refuted back to alive"
                )
            time.sleep(0.05)
        final = {w: self._stats(w) for w in self.alive}

        def _delta(key: str) -> int:
            return sum(
                int(final[w]["fabric"][key]) - int(pre[w]["fabric"][key])
                for w in self.alive
            )

        refuted = _delta("FabricMembershipRefuted")
        return {
            "target": target,
            "suspects_delta": _delta("FabricMembershipSuspects"),
            "refuted_delta": refuted,
            "confirmed_dead_delta": _delta("FabricMembershipConfirmedDead"),
            "invariants": {
                "suspicion_observed": suspected,
                "refutation_observed": refuted >= 1,
                "target_alive_everywhere": True,  # the wait above gates it
            },
        }

    def _leave_phase(self) -> dict:
        """Planned leave: the newest member drains and departs.  Zero
        shed, zero replay, LEFT visible everywhere, and a follow-up wave
        lands exactly-once on the remaining fleet."""
        from banjax_tpu_torch.scenarios.shapes import LineChunk, generate

        leaver = self.alive[-1]
        rest = [w for w in self.alive if w != leaver]
        pre = {w: self._stats(w) for w in self.alive}
        ack = self.workers[leaver].request(wire.T_LEAVE, {})
        self._note_seen(leaver, ack)
        self.alive.remove(leaver)
        try:
            self.workers[leaver].proc.wait(timeout=30)
            departed = True
        except subprocess.TimeoutExpired:
            departed = False
        # the LEFT digest was announced synchronously before the ack:
        # nobody may still believe the leaver owns anything
        observed_left = all(
            self._member_status(w, leaver) == "left" for w in rest
        )

        base = {w: self._stats(w) for w in rest}
        wave = generate(self.shape, self.seed + 2,
                        max(0.25, self.scale * 0.25))
        wave_chunks = [
            list(ev.lines) for ev in wave.events
            if isinstance(ev, LineChunk)
        ]
        wave_lines = sum(len(c) for c in wave_chunks)
        for chunk in wave_chunks:
            self._send_chunk(chunk)
            self.fed_lines += len(chunk)
        self._settle(tagged_floor=self._tagged_commands())
        final = {w: self._stats(w) for w in rest}

        def _shed(snap: dict) -> int:
            return int(snap["sched"]["PipelineShedLines"]) + int(
                snap["fabric"]["FabricShedLines"]
            )

        # the leaver's own final ledger rides the T_LEAVE ack (the
        # process is gone by now)
        leaver_shed = _shed(ack) - _shed(pre[leaver])
        rest_shed = sum(_shed(final[w]) - _shed(pre[w]) for w in rest)
        replay_delta = sum(
            int(final[w]["fabric"]["FabricReplayedLines"])
            - int(pre[w]["fabric"]["FabricReplayedLines"])
            for w in rest
        ) + (
            int(ack["fabric"]["FabricReplayedLines"])
            - int(pre[leaver]["fabric"]["FabricReplayedLines"])
        )
        locals_sum = sum(
            int(final[w]["fabric"]["FabricLocalLines"])
            - int(base[w]["fabric"]["FabricLocalLines"])
            for w in rest
        )
        return {
            "leaver": leaver,
            "drain_ms": ack.get("drain_ms"),
            "announced": ack.get("announced"),
            "wave_lines": wave_lines,
            "wave_locals_sum": locals_sum,
            "shed_leaver": leaver_shed,
            "shed_rest": rest_shed,
            "replayed_lines": replay_delta,
            "invariants": {
                "drain_flushed": bool(ack.get("flushed")),
                "departed": departed,
                "left_observed_everywhere": observed_left,
                "zero_shed": leaver_shed == 0 and rest_shed == 0,
                "zero_replay": replay_delta == 0,
                "wave_exactly_once": locals_sum == wave_lines,
            },
        }

    # ---- reporting ----

    def _report(self, sc, n_lines, feed_s, base, final,
                config_from_yaml_text, oracle_mod) -> dict:
        engine_bans: List[Tuple[str, str]] = []
        for w in self.alive:
            engine_bans.extend(
                (ip, rule) for ip, rule in final[w]["bans"]
            )
        cfg = config_from_yaml_text(sc.rules_yaml)
        oracle_bans = oracle_mod.expected_bans(sc, cfg)
        precision, recall, tp = oracle_mod.precision_recall(
            engine_bans, oracle_bans
        )

        per_worker = {}
        invariants: Dict[str, bool] = {}
        dup_total = 0
        for w in self.alive:
            sched_d = {
                k: int(final[w]["sched"][k]) - int(base[w]["sched"][k])
                for k in ("PipelineAdmittedLines", "PipelineProcessedLines",
                          "PipelineShedLines", "PipelineDrainErrorLines")
            }
            fab = {k: int(v) for k, v in final[w]["fabric"].items()}
            dup_total += fab["FabricDuplicatesSuppressed"]
            per_worker[w] = {"sched_delta": sched_d, "fabric": fab,
                             "router": final[w]["router"]}
            invariants[f"{w}_pipeline_accounting"] = (
                sched_d["PipelineAdmittedLines"]
                == sched_d["PipelineProcessedLines"]
                + sched_d["PipelineShedLines"]
                + sched_d["PipelineDrainErrorLines"]
            )
            # fabric ledger: every line that ENTERED this worker
            # (received over the wire, or re-materialized from its
            # journal at takeover) left as exactly one of
            # local/forwarded/shed/replay-skipped
            invariants[f"{w}_fabric_ledger"] = (
                fab["FabricLocalLines"] + fab["FabricForwardedLines"]
                + fab["FabricShedLines"]
                + fab.get("FabricReplaySkippedLines", 0)
                == fab["FabricReceivedLines"] + fab["FabricReplayedLines"]
            )
        invariants["harness_fed_equals_acked"] = (
            self.fed_lines == self.acked_lines
        )
        invariants["recall_one"] = recall == 1.0
        if self.kill:
            invariants["takeover_happened"] = bool(self.takeover)
            invariants["survivors_took_over"] = all(
                per_worker[w]["fabric"]["FabricTakeovers"] >= 1
                for w in self.alive
            )
            invariants["victim_in_last_takeover"] = all(
                ((final[w]["router"] or {}).get("last_takeover") or {})
                .get("peer") == self.victim
                for w in self.alive
            )
        if self.n_workers > 1 and engine_bans:
            # every replicated decision echoes back to its origin and
            # is suppressed there: the idempotency witness
            invariants["duplicates_suppressed"] = dup_total > 0

        return {
            "harness": "dryrun_fabric",
            "n_workers": self.n_workers,
            "transport": self.transport,
            "shape": self.shape,
            "seed": self.seed,
            "scale": self.scale,
            "killed": self.victim,
            "n_lines": n_lines,
            "fed_lines": self.fed_lines,
            "acked_lines": self.acked_lines,
            "feed_s": round(feed_s, 3),
            "lines_per_sec": round(n_lines / feed_s, 1),
            "engine_bans": len(engine_bans),
            # canonical ban log: the transport-differential suites
            # compare this byte-for-byte between wire encodings
            "ban_log": sorted(f"{ip} {rule}" for ip, rule in engine_bans),
            "oracle_bans": len(oracle_bans),
            "true_positives": tp,
            "precision": round(precision, 6),
            "recall": round(recall, 6),
            "duplicates_suppressed": dup_total,
            "takeover": self.takeover,
            "per_worker": per_worker,
            "invariants": invariants,
        }


def run_fabric(**kwargs) -> dict:
    """Convenience wrapper: one episode, report dict back."""
    return FabricDryrun(**kwargs).run()


def run_forward_path(
    transport: str = "v2",
    n_chunks: int = 200,
    chunk_lines: int = 64,
    inflight_frames: int = 8,
    ready_timeout_s: float = 420.0,
    log_dir: Optional[str] = None,
    device: Optional[str] = None,
) -> dict:
    """Transport micro-benchmark: two shards, w0 fed chunks whose lines
    are ALL owned by w1, so every line crosses the peer data path
    ("json" sync / "v2" pipelined TCP / "shm" rings).  The measured
    window covers feed AND drain (T_FLUSH lands every in-flight frame),
    so pipelining cannot hide undelivered lines; the audit is
    transport-lossless delivery (w1 received == w0 forwarded == fed).
    The destination pipeline buffer (131072 lines) is sized above the
    row, so acks measure the wire, not the matcher."""
    from banjax_tpu_torch.fabric.hashring import ConsistentHashRing
    from banjax_tpu_torch.scenarios.shapes import T0

    ring = ConsistentHashRing(("w0", "w1"), vnodes=64)
    ips: List[str] = []
    i = 0
    while len(ips) < 64:
        ip = f"10.{(i >> 8) & 255}.{i & 255}.7"
        if ring.owner(ip) == "w1":
            ips.append(ip)
        i += 1
    chunks = [
        [
            f"{T0 + c * 0.001:.6f} "
            f"{ips[(c * chunk_lines + j) % len(ips)]} "
            "GET fwd.example GET /about HTTP/1.1 fp -"
            for j in range(chunk_lines)
        ]
        for c in range(n_chunks)
    ]
    n_lines = n_chunks * chunk_lines

    workers: Dict[str, _Worker] = {}
    try:
        for wid in ("w0", "w1"):
            err = (
                os.path.join(log_dir, f"fwd_{wid}.err")
                if log_dir else None
            )
            workers[wid] = _spawn(wid, 0, err, device=device)
        threads = [
            threading.Thread(
                target=w.read_ready, args=(ready_timeout_s,), daemon=True
            )
            for w in workers.values()
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(ready_timeout_s + 5)
        bad = [
            f"{w.wid}: {w.ready_error}"
            for w in workers.values() if w.port is None
        ]
        if bad:
            raise RuntimeError(f"forward-path workers failed: {bad}")
        hello = {
            "peers": {
                w.wid: ["127.0.0.1", w.port] for w in workers.values()
            },
            "vnodes": 64,
            "send_timeout_ms": 2000.0,
            "grace_ms": 200.0,
            "inflight_frames": (
                0 if transport == "json" else inflight_frames
            ),
            "wire_v2": transport != "json",
            "shm": transport == "shm",
        }
        for w in workers.values():
            w.request(wire.T_HELLO, hello)

        t0 = time.perf_counter()
        for chunk in chunks:
            workers["w0"].request(
                wire.T_LINES, {"lines": chunk, "route": True}
            )
        drained = workers["w0"].request(wire.T_FLUSH, {"timeout": 600})
        elapsed = max(1e-9, time.perf_counter() - t0)

        s0 = workers["w0"].request(wire.T_STATS, {})
        s1 = workers["w1"].request(wire.T_STATS, {})
        received = int(s1["fabric"]["FabricReceivedLines"])
        forwarded = int(s0["fabric"]["FabricForwardedLines"])
        peer_desc = (
            (s0.get("router") or {}).get("peers") or {}
        ).get("w1", {})
        return {
            "harness": "forward_path",
            "transport": transport,
            "peer_transport": peer_desc.get("transport"),
            "n_lines": n_lines,
            "chunk_lines": chunk_lines,
            "feed_s": round(elapsed, 3),
            "lines_per_sec": round(n_lines / elapsed, 1),
            "forwarded": forwarded,
            "received": received,
            "frames_sent": int(s0["fabric"].get("FabricFramesSent", 0)),
            "invariants": {
                "drained": bool(drained.get("flushed")),
                "all_lines_crossed": (
                    received == n_lines and forwarded == n_lines
                ),
            },
        }
    finally:
        for w in workers.values():
            w.shutdown()
