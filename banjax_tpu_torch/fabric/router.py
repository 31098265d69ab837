"""Ownership routing, the per-peer line journal, and takeover.

(A copy of `banjax_tpu/fabric/router.py`.)

The router is the zero-lost-ban mechanism.  Every chunk successfully
forwarded to a peer is also appended to that peer's journal (bounded
deque of recent chunks).  When a peer is declared dead — a send
exhausted its retry budget, its breaker opened, a membership frame
said so, or gossip confirmed a suspicion (fabric/membership.py) — the
router:

  1. passes the `fabric.takeover` failpoint (armable chaos),
  2. removes the peer from the alive set (the consistent-hash ring
     then hands its ranges to the next alive points automatically),
  3. schedules the journal replay for `fabric_takeover_grace_ms`
     later — the grace is a DEADLINE, not a sleep: `mark_dead`
     returns immediately, so a death event mid-flood never stalls the
     routing caller.  The replay fires from whichever comes first of
     a `route()` call observing the deadline passed, a `poll()` tick
     (the gossip loop calls it every interval), or the dedicated
     grace timer thread,
  4. replays the dead peer's entire journal through normal routing, so
     the successor re-derives every window state the dead shard held.

Replayed lines are counted (`FabricReplayedLines`) and re-journaled
against their new owners (cascading failures still replay).  A replay
is also the one place double-processing used to leak in: a replayed
chunk can contain lines whose owner never died (a feeder replays
whole direct-feed chunks).  Re-routing those would double-count their
rate-limit hits on a live shard and mint a duplicate ban (the banked
n2 precision 0.969697 bug) — so replay recomputes ownership under the
pre-death view (alive ∪ crashed) and SKIPS lines whose pre-death owner
is still alive (`FabricReplaySkippedLines`): they were delivered once
on the normal path and their window state never died.  Lines with no
alive owner are counted shed, never silently dropped.

When a pipe factory is installed (wire v2), forwards ride per-peer
pipelined windows (`fabric/peer.py` LinePipe): the group is journaled
at submit, `route()` returns to matching while frames are in flight,
and acks stream back on the pipe's I/O thread (which must never take
the router lock — gossip piggybacks are queued and merged by poll()).
Without a factory the synchronous per-group JSON path is preserved
verbatim as the negotiated fallback and differential oracle.

Dynamic membership adds two transitions the static fabric never
needed: `add_node` (a gossip-discovered joiner — the ring is rebuilt
to include it, which steals keys only from the joiner's ring
successors) and `mark_left` (a graceful leaver — removed from the
alive set with its journal CLEARED, no replay: the leaver drained its
pipeline and replicated its decisions before departing, so a replay
could only double-process).
"""

from __future__ import annotations

import inspect
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from banjax_tpu_torch.fabric.hashring import ConsistentHashRing
from banjax_tpu_torch.fabric.peer import LinePipe, PeerClient, PeerUnavailable
from banjax_tpu_torch.fabric.stats import FabricStats
from banjax_tpu_torch.fabric import wire
from banjax_tpu_torch.obs import trace
from banjax_tpu_torch.resilience import failpoints
from banjax_tpu_torch.resilience.health import HealthRegistry

# pipe_factory(peer_id, host, port, on_ack) -> LinePipe: installed by
# service/worker wiring when the pipelined data path is configured
# (fabric_inflight_frames > 0); absent => the synchronous per-group
# JSON path below, byte-for-byte the static fabric's behavior (the differential
# oracle for the transport rewrite)
PipeFactory = Callable[[str, str, int, Callable], LinePipe]


def ip_of_line(line: str) -> str:
    """The reference log format's client address (field 2)."""
    parts = line.split(" ", 2)
    return parts[1] if len(parts) > 2 else line


class FabricRouter:
    def __init__(
        self,
        node_id: str,
        ring: ConsistentHashRing,
        peers: Dict[str, PeerClient],
        local_submit: Callable[[Sequence[str]], int],
        stats: Optional[FabricStats] = None,
        health: Optional[HealthRegistry] = None,
        takeover_grace_ms: float = 500.0,
        journal_chunks: int = 4096,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        pipe_factory: Optional[PipeFactory] = None,
        trace_propagation: bool = False,
    ):
        self.node_id = node_id
        self.ring = ring
        self.peers = peers
        self.local_submit = local_submit
        # origin trace ids ride forwarded chunks only when configured
        # (fabric_trace_propagation) — inert with the tracer off, since
        # new_trace() then returns 0 and the wire omits the section
        self.trace_propagation = bool(trace_propagation)
        # whether local_submit accepts the (t_read, hop) latency-stamp
        # keywords — probed once so plain `lambda lines: n` callables
        # (tests, simple feeders) keep working unchanged
        try:
            params = inspect.signature(local_submit).parameters
            self._local_kw = "t_read" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values()
            )
        except (TypeError, ValueError):
            self._local_kw = False
        self.stats = stats or FabricStats()
        self.health = health
        self.takeover_grace_s = float(takeover_grace_ms) / 1000.0
        self._journal_chunks = int(journal_chunks)
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.RLock()
        self.alive = set(ring.node_ids)
        # peers that crashed (mark_dead) and have not come back: the
        # pre-death ownership view for replay dedupe is alive ∪ crashed
        self._crashed: set = set()
        self._pipe_factory = pipe_factory
        self._pipes: Dict[str, LinePipe] = {}
        self._resent_closed = [0, 0]  # resends of pipes already dropped
        # gossip digests from pipelined acks, drained by poll() — the
        # pipe's I/O thread must never take the router lock (it could
        # be the thread route() is waiting on for window space)
        self._gossip_inbox: deque = deque(maxlen=256)
        # graceful-membership hook: a merge callable installed by
        # SwimMembership so digests piggybacked on T_LINES acks feed
        # the membership table (convergence rides the data path)
        self.gossip_merge: Optional[Callable[[list], None]] = None
        # peer -> (declared_dead_at, replay_deadline): takeovers whose
        # grace window is still open (deadline-polled, never slept-on)
        self._pending_takeover: Dict[str, tuple] = {}
        self._journal: Dict[str, deque] = {
            p: deque(maxlen=journal_chunks) for p in ring.node_ids
        }
        for pid in ring.node_ids:
            self.stats.note_peer(pid, True)
            if self.health is not None and pid != node_id:
                self.health.register(f"fabric.peer.{pid}").ok()

    # ---- routing ----

    def route(
        self, lines: Sequence[str], replay: bool = False,
        t_read: Optional[float] = None,
    ) -> Dict[str, int]:
        """Deliver every line to its owner.  Returns the disposition
        ledger {local, forwarded, shed, skipped} — their sum is always
        len(lines).  `skipped` is only ever nonzero on a replay: lines
        whose pre-death owner is still alive were already processed
        once, and replaying them would double-count rate-limit hits
        (the n2 duplicate-ban bug).  `t_read` is the tailer-read
        monotonic stamp of the chunk (e2e latency; rides the wire with
        forwarded groups)."""
        self.poll()  # complete any takeover whose grace deadline passed
        out = {"local": 0, "forwarded": 0, "shed": 0, "skipped": 0}
        # the origin trace: allocated HERE, before ownership fans the
        # chunk out, so a ban minted on any owner shard joins back to
        # this admission batch (0 = tracer off: the wire section and
        # every span call no-op)
        tid = trace.new_trace() if self.trace_propagation else 0
        span = trace.begin("fabric.route", tid, args={"lines": len(lines)})
        try:
            with self._lock:
                self._route_locked(list(lines), out, replay, tid, t_read)
        finally:
            span.note("disposition", dict(out))
            trace.end(span)
        return out

    def _local_call(
        self, group: List[str], t_read: Optional[float], hop: str
    ) -> None:
        if self._local_kw:
            self.local_submit(group, t_read=t_read, hop=hop)
        else:
            self.local_submit(group)

    def _route_locked(
        self, lines: List[str], out: Dict[str, int], replay: bool,
        trace_id: int = 0, t_read: Optional[float] = None,
    ) -> None:
        if not lines:
            return
        if not self.alive:
            self.stats.note_shed(len(lines))
            out["shed"] += len(lines)
            return
        if replay:
            lines = self._filter_replay_locked(lines, out)
            if not lines:
                return
        by_owner = self.ring.partition(
            [ip_of_line(ln) for ln in lines], self.alive
        )
        for owner, idxs in by_owner.items():
            group = [lines[i] for i in idxs]
            if owner == self.node_id or self.peers.get(owner) is None:
                self._local_call(group, t_read, "local")
                self.stats.note_local(len(group))
                out["local"] += len(group)
                continue
            pipe = self._pipe_for_locked(owner)
            if pipe is not None:
                self._forward_pipelined_locked(
                    owner, pipe, group, out, replay, trace_id, t_read
                )
            else:
                self._forward_sync_locked(
                    owner, group, out, replay, trace_id, t_read
                )

    def _filter_replay_locked(
        self, lines: List[str], out: Dict[str, int]
    ) -> List[str]:
        """Replay dedupe: recompute ownership under the pre-death view
        (alive ∪ crashed).  A replayed line whose pre-death owner is
        still alive was delivered to that owner on the normal path
        before the crash — it is skipped, not re-processed.  Lines the
        crashed peers owned are kept: those window states died with
        their shard and MUST be re-derived (zero-lost-ban)."""
        if not self._crashed:
            return lines
        view = self.alive | self._crashed
        pre = self.ring.partition([ip_of_line(ln) for ln in lines], view)
        keep: List[str] = []
        skipped = 0
        for owner, idxs in pre.items():
            if owner in self._crashed:
                keep.extend(lines[i] for i in idxs)
            else:
                skipped += len(idxs)
        if skipped:
            self.stats.note_replay_skipped(skipped)
            out["skipped"] += skipped
        return keep

    def _forward_pipelined_locked(
        self, owner: str, pipe: LinePipe, group: List[str],
        out: Dict[str, int], replay: bool,
        trace_id: int = 0, t_read: Optional[float] = None,
    ) -> None:
        """Wire v2 data path: journal at submit (the takeover replay
        source), hand the group to the peer's pipelined window, return
        to matching — acks stream back on the pipe's I/O thread."""
        entry = tuple(group)
        self._journal[owner].append(entry)
        try:
            pipe.submit(group, replay=replay, trace_id=trace_id,
                        t_read=t_read)
        except PeerUnavailable:
            # the group never entered the window: pull it back out of
            # the journal (first equal chunk — same multiset) and
            # reroute it NOW; the takeover replay covers the rest
            try:
                self._journal[owner].remove(entry)
            except ValueError:
                pass
            self.mark_dead(owner, reason="pipe dead")
            self._route_locked(group, out, replay, trace_id, t_read)
            return
        self.stats.note_forwarded(len(group))
        out["forwarded"] += len(group)

    def _forward_sync_locked(
        self, owner: str, group: List[str],
        out: Dict[str, int], replay: bool,
        trace_id: int = 0, t_read: Optional[float] = None,
    ) -> None:
        """The synchronous JSON path — kept verbatim as the
        negotiated fallback and the differential oracle
        (fabric_inflight_frames = 0)."""
        payload: Dict[str, object] = {"lines": group, "replay": replay}
        if self.trace_propagation and self.node_id:
            # same origin section the v2 binary frame carries; old
            # receivers ignore the unknown key
            payload["origin"] = {
                "node": self.node_id,
                "runs": [[trace_id, len(group)]],
                "t_read": t_read,
            }
        try:
            _rt, rpayload = self.peers[owner].request(wire.T_LINES, payload)
        except PeerUnavailable:
            self.mark_dead(owner, reason="send failed")
            self._route_locked(group, out, replay, trace_id, t_read)
            return
        self.stats.note_forwarded(len(group))
        out["forwarded"] += len(group)
        self._journal[owner].append(tuple(group))
        if self.health is not None:
            comp = self.health.get(f"fabric.peer.{owner}")
            if comp is not None:
                comp.beat()
        if self.gossip_merge is not None:
            piggy = rpayload.get("gossip")
            if piggy:
                self.gossip_merge(piggy)

    def owner_of(self, ip: str) -> Optional[str]:
        """Current owner of one key under the alive view (the
        cross-shard /decisions/explain proxy asks this before deciding
        whether to answer locally or over the peer wire)."""
        with self._lock:
            if not self.alive:
                return None
            return self.ring.owner(ip, self.alive)

    def alive_peers(self) -> Dict[str, PeerClient]:
        """{peer_id: client} for every ALIVE remote member — the fleet
        scrape / incident-capture fan-out set."""
        with self._lock:
            return {
                pid: c for pid, c in self.peers.items()
                if c is not None and pid in self.alive
            }

    # ---- pipelined data path plumbing ----

    def _pipe_for_locked(self, owner: str) -> Optional[LinePipe]:
        if self._pipe_factory is None:
            return None
        pipe = self._pipes.get(owner)
        if pipe is None:
            client = self.peers.get(owner)
            if client is None:
                return None
            pipe = self._pipe_factory(
                owner, client.host, client.port, self._ack_handler(owner)
            )
            self._pipes[owner] = pipe
        return pipe

    def _ack_handler(self, owner: str) -> Callable[[Dict[str, object]], None]:
        """Runs on the pipe's I/O thread: liveness beat + gossip
        piggyback capture.  MUST NOT take the router lock (route() may
        hold it while waiting for this very thread to open window
        space)."""
        def _on_ack(payload: Dict[str, object]) -> None:
            if self.health is not None:
                comp = self.health.get(f"fabric.peer.{owner}")
                if comp is not None:
                    comp.beat()
            piggy = payload.get("gossip")
            if piggy:
                self._gossip_inbox.append(piggy)
        return _on_ack

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Drain every pipe: all submitted groups sent AND acked.  The
        routed feed path (`route:true` chunk handlers) and the
        settle/leave audits call this so an upstream ack means LANDED
        at the final owner, not parked in a window — the replay dedupe
        filter's soundness rests on exactly that.  A pipe found dead
        here triggers its peer's takeover immediately (journal replay
        through live routing) and the reroutes are drained in the next
        pass.  True iff fully drained."""
        deadline = time.monotonic() + timeout_s
        while True:
            self.poll()  # complete any takeover whose deadline passed
            with self._lock:
                pipes = dict(self._pipes)
            ok = True
            for pipe in pipes.values():
                if pipe.dead:
                    continue
                left = deadline - time.monotonic()
                ok = pipe.flush(max(0.0, left)) and ok
            dead = [pid for pid, p in pipes.items() if p.dead]
            if not dead:
                return ok
            for pid in dead:
                self.mark_dead(pid, reason="pipe dead at flush")
                with self._lock:
                    self._drop_pipe_locked(pid)  # even if already !alive
            if time.monotonic() >= deadline:
                return False

    def _drop_pipe_locked(self, owner: str) -> None:
        pipe = self._pipes.pop(owner, None)
        if pipe is not None:
            self._resent_closed[0] += pipe.resent_frames
            self._resent_closed[1] += pipe.resent_lines
            pipe.close()

    def resent(self) -> Dict[str, int]:
        """Frames and lines this router's pipes sent again (a reconnect's
        retransmit of the unacked window), dropped pipes included."""
        with self._lock:
            frames, lines = self._resent_closed
            for pipe in self._pipes.values():
                frames += pipe.resent_frames
                lines += pipe.resent_lines
        return {"frames": frames, "lines": lines}

    def close(self) -> None:
        """Shut down every pipe (service/worker teardown)."""
        with self._lock:
            pipes = list(self._pipes.values())
            self._pipes.clear()
        for pipe in pipes:
            pipe.close()

    # ---- membership / takeover ----

    def mark_dead(self, peer_id: str, reason: str = "") -> None:
        """Declare a peer dead and schedule the takeover of its range.
        Returns immediately: the grace window is a deadline (completed
        by route()/poll()/the grace timer), never an inline sleep — a
        death event mid-flood must not stall the routing caller."""
        with self._lock:
            if peer_id not in self.alive or peer_id == self.node_id:
                return
            try:
                failpoints.check("fabric.takeover")
            except failpoints.FaultInjected:
                # chaos: the takeover path itself faults once — the
                # takeover must still complete (retried immediately;
                # the episode is visible in failpoints.snapshot())
                pass
            self.alive.discard(peer_id)
            self._crashed.add(peer_id)
            self._drop_pipe_locked(peer_id)
            self.stats.note_peer(peer_id, False)
            if self.health is not None:
                comp = self.health.get(f"fabric.peer.{peer_id}")
                if comp is not None:
                    comp.failed(reason or "declared dead")
            t0 = self._clock()
            self._pending_takeover[peer_id] = (
                t0, t0 + self.takeover_grace_s
            )
        if self.takeover_grace_s <= 0:
            self._complete_takeover(peer_id)
            return
        threading.Thread(
            target=self._grace_then_complete, args=(peer_id,),
            name=f"fabric-takeover-{peer_id}", daemon=True,
        ).start()

    def _grace_then_complete(self, peer_id: str) -> None:
        self._sleep(self.takeover_grace_s)
        self._complete_takeover(peer_id)

    def poll(self) -> None:
        """Complete every pending takeover whose grace deadline has
        passed, and merge gossip digests captured from pipelined acks.
        Cheap when nothing is pending; called at route() entry and
        from the gossip tick."""
        if self.gossip_merge is not None:
            while self._gossip_inbox:
                try:
                    piggy = self._gossip_inbox.popleft()
                except IndexError:
                    break
                self.gossip_merge(piggy)
        if not self._pending_takeover:
            return
        now = self._clock()
        with self._lock:
            due = [
                p for p, (_t0, deadline)
                in self._pending_takeover.items() if now >= deadline
            ]
        for peer_id in due:
            self._complete_takeover(peer_id)

    def _complete_takeover(self, peer_id: str) -> None:
        """Drain the dead peer's journal through normal routing —
        idempotent: the pending entry is popped under the lock, so the
        grace timer, route() and poll() can race without replaying
        twice."""
        with self._lock:
            ent = self._pending_takeover.pop(peer_id, None)
            if ent is None:
                return
            t0, _deadline = ent
            chunks = list(self._journal[peer_id])
            self._journal[peer_id].clear()
            replayed = 0
            out = {"local": 0, "forwarded": 0, "shed": 0, "skipped": 0}
            for chunk in chunks:
                replayed += len(chunk)
                self.stats.note_replayed(len(chunk))
                self._route_locked(list(chunk), out, replay=True)
            self.stats.note_takeover(peer_id, self._clock() - t0, replayed)

    def takeover_pending(self, peer_id: Optional[str] = None) -> bool:
        with self._lock:
            if peer_id is None:
                return bool(self._pending_takeover)
            return peer_id in self._pending_takeover

    def mark_alive(
        self, peer_id: str,
        host: Optional[str] = None, port: Optional[int] = None,
    ) -> None:
        """A peer rejoined (possibly at a new address).  Its old ranges
        return to it by ring recomputation alone — no journal replay, so
        a rejoin never double-processes.  A peer this router still holds
        alive at the same address (a refuted suspicion) keeps its pipe:
        the JAX router drops it there too, and with it the unacked window
        and the pending groups, lines counted forwarded and never
        delivered."""
        with self._lock:
            if peer_id == self.node_id:
                self.alive.add(peer_id)  # undo a self-drain (aborted leave)
                return
            # a revival during the grace window voids the takeover: the
            # peer is back, its journal is its own again
            self._pending_takeover.pop(peer_id, None)
            self._crashed.discard(peer_id)
            client = self.peers.get(peer_id)
            moved = (client is not None and host is not None and port is not None
                     and (client.host, client.port) != (host, int(port)))
            if peer_id not in self.alive or moved:
                self._drop_pipe_locked(peer_id)  # a fresh pipe dials the new addr
            if client is not None and host is not None and port is not None:
                client.connect_to(host, port)
            self.alive.add(peer_id)
            self.stats.note_peer(peer_id, True)
            if self.health is not None and peer_id in self.ring.node_ids:
                self.health.register(f"fabric.peer.{peer_id}").ok("rejoined")

    def add_node(
        self, peer_id: str, client: Optional[PeerClient],
    ) -> None:
        """A brand-new member (gossip join): rebuild the ring to
        include it.  Ring insertion steals keys only from the joiner's
        ring successors (tests/unit/test_fabric.py proves the bound);
        nobody else's ownership moves."""
        with self._lock:
            if peer_id in self.ring.node_ids:
                self.mark_alive(
                    peer_id,
                    host=getattr(client, "host", None),
                    port=getattr(client, "port", None),
                )
                return
            self.ring = ConsistentHashRing(
                self.ring.node_ids + (peer_id,), vnodes=self.ring.vnodes
            )
            if peer_id != self.node_id:
                self.peers[peer_id] = client
            self._journal[peer_id] = deque(maxlen=self._journal_chunks)
            self._crashed.discard(peer_id)
            self.alive.add(peer_id)
            self.stats.note_peer(peer_id, True)
            if self.health is not None and peer_id != self.node_id:
                self.health.register(f"fabric.peer.{peer_id}").ok("joined")

    def mark_left(self, peer_id: str, reason: str = "graceful leave") -> None:
        """A peer departed gracefully: it drained its pipeline and
        replicated its decisions before announcing LEFT, so its journal
        is CLEARED without replay — a replay could only double-process.
        Calling it on our own id is the leaver's self-drain: drop out
        of the alive set so every subsequent line forwards to its new
        owner (the pure-membership handback)."""
        with self._lock:
            self.alive.discard(peer_id)
            self._crashed.discard(peer_id)
            self._pending_takeover.pop(peer_id, None)
            self._drop_pipe_locked(peer_id)
            journal = self._journal.get(peer_id)
            if journal is not None:
                journal.clear()
            if peer_id == self.node_id:
                return
            self.stats.note_peer(peer_id, False)
            if self.health is not None:
                comp = self.health.get(f"fabric.peer.{peer_id}")
                if comp is not None:
                    comp.ok(reason)  # a planned leave is not a failure

    # ---- introspection (fabric.json / /metrics) ----

    def describe(self) -> Dict[str, object]:
        with self._lock:
            alive = sorted(self.alive)
            pending = sorted(self._pending_takeover)
            peers = {
                pid: {
                    "alive": pid in self.alive,
                    "addr": (
                        f"{self.peers[pid].host}:{self.peers[pid].port}"
                        if self.peers.get(pid) is not None else "local"
                    ),
                    "journal_chunks": len(self._journal.get(pid, ())),
                    "breaker": (
                        self.peers[pid].breaker.state
                        if self.peers.get(pid) is not None else ""
                    ),
                    "transport": (
                        f"{self._pipes[pid].mode}/{self._pipes[pid].transport}"
                        f"[{self._pipes[pid].inflight()}]"
                        if pid in self._pipes and not self._pipes[pid].dead
                        else "sync-json"
                    ),
                }
                for pid in self.ring.node_ids
            }
        return {
            "node_id": self.node_id,
            "vnodes": self.ring.vnodes,
            "alive": alive,
            "pending_takeovers": pending,
            "peers": peers,
            "ownership": self.ring.ownership_fractions(set(alive)),
            "last_takeover": self.stats.last_takeover,
        }
