"""SWIM-style gossip membership for the decision fabric.

(A copy of `banjax_tpu/fabric/membership.py`.)

A static fabric freezes its topology at startup: `fabric_peers` was the
authority and a dead shard was only discovered when a *forwarded line*
failed to send — unbounded detection latency on quiet keyspace ranges,
and no way to grow or shrink the fleet without restarting it.  This
module turns `fabric_peers` into a seed list and makes membership a
live, gossiped protocol:

  * **Probing** — every `fabric_gossip_interval_ms` the node direct-
    pings one member (round-robin over a per-round shuffled order, the
    SWIM schedule that bounds time-to-first-probe).  A failed direct
    ping fans out `fabric_indirect_probes` ping-req relays through
    other members; only when nobody can reach the target does it become
    SUSPECT.
  * **Suspicion + incarnation** — a SUSPECT member has
    `fabric_suspect_timeout_ms` to produce liveness evidence before it
    is confirmed DEAD.  Every member carries an incarnation number; a
    slow-but-alive node that learns of its own suspicion (the suspicion
    rides every digest) refutes it by bumping its incarnation and
    gossiping ALIVE(i+1), which outranks SUSPECT(i) everywhere.
  * **Piggybacking** — the membership digest rides every gossip frame
    AND every forwarded-chunk ack (router.py merges it), so under load
    convergence is carried by the data path for free and the dedicated
    probe traffic stays a few hundred bytes per interval.
  * **Events drive the existing machinery** — confirmed-dead calls
    `router.mark_dead` (journal-replay takeover, now deadline-polled),
    refuted/revived calls `router.mark_alive`, a brand-new member calls
    `router.add_node` (ring insertion), and a graceful LEFT calls
    `router.mark_left` (journal cleared, NO replay: the leaver drained
    before departing, so replay could only double-process).

State precedence is standard SWIM: a higher incarnation always wins;
at equal incarnation the more severe status wins
(alive < suspect < dead < left).  LEFT is terminal per incarnation —
only the node itself (rejoining with a bumped incarnation) can revive
it.

Failpoints: `fabric.gossip.ping` (before every outgoing probe frame),
`fabric.gossip.ack` (before answering a probe — arm it with
mode=sleep to fake a slow node and drive the suspect/refute cycle),
`fabric.membership.update` (before merging a received digest; an
injected fault drops that update — gossip re-delivers).
"""

from __future__ import annotations

import json
import random
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from banjax_tpu_torch.fabric import wire
from banjax_tpu_torch.fabric.stats import FabricStats
from banjax_tpu_torch.resilience import failpoints

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"
LEFT = "left"

# severity order at EQUAL incarnation; a higher incarnation beats all
_RANK = {ALIVE: 0, SUSPECT: 1, DEAD: 2, LEFT: 3}


class Member:
    __slots__ = ("node_id", "host", "port", "incarnation", "status")

    def __init__(self, node_id: str, host: str, port: int,
                 incarnation: int = 0, status: str = ALIVE):
        self.node_id = node_id
        self.host = host
        self.port = int(port)
        self.incarnation = int(incarnation)
        self.status = status

    def entry(self) -> List[Any]:
        """One digest row: [id, status, incarnation, host, port]."""
        return [self.node_id, self.status, self.incarnation,
                self.host, self.port]


class SwimMembership:
    """The per-node membership table + probe loop.

    Thread-safe; the probe loop runs on one daemon thread.  All
    transitions funnel through `_apply`, which is what makes the
    announce-once contract hold: an admin READY/PEER_UP handshake
    and gossip discovery both land here, and only an actual status
    transition fires a router action — a rejoining worker is announced
    exactly once no matter how many paths observe it.
    """

    def __init__(
        self,
        node_id: str,
        host: str,
        port: int,
        router: Any = None,
        stats: Optional[FabricStats] = None,
        gossip_interval_ms: float = 1000.0,
        suspect_timeout_ms: float = 3000.0,
        indirect_probes: int = 2,
        peer_factory: Optional[Callable[[str, str, int], Any]] = None,
        clock: Callable[[], float] = time.monotonic,
        rng_seed: Optional[int] = None,
        health_provider: Optional[Callable[[], int]] = None,
    ):
        self.node_id = node_id
        self.router = router
        self.stats = stats or FabricStats()
        # compact per-node health bits (obs/fleet.py encoding) that ride
        # every gossip frame as a parallel "health" key — digest rows
        # stay the strict 5-tuple old nodes unpack
        self.health_provider = health_provider
        self.interval_s = float(gossip_interval_ms) / 1000.0
        self.suspect_timeout_s = float(suspect_timeout_ms) / 1000.0
        self.indirect_probes = int(indirect_probes)
        self.peer_factory = peer_factory
        self._clock = clock
        self._rng = random.Random(
            rng_seed if rng_seed is not None else node_id
        )
        self._lock = threading.RLock()
        self._members: Dict[str, Member] = {
            node_id: Member(node_id, host, port)
        }
        self._suspect_deadline: Dict[str, float] = {}
        self._last_alive: Dict[str, float] = {}
        self._probe_order: List[str] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats.note_member_state(node_id, ALIVE)

    # ---- seeding / lifecycle ----

    def seed(self, peers: Dict[str, Tuple[str, int]]) -> None:
        """Install the static seed list (fabric_peers / HELLO payload)
        as ALIVE members at incarnation 0."""
        now = self._clock()
        with self._lock:
            for nid, (host, port) in peers.items():
                if nid == self.node_id:
                    me = self._members[self.node_id]
                    me.host, me.port = host, int(port)
                    continue
                if nid not in self._members:
                    self._members[nid] = Member(nid, host, int(port))
                    self._last_alive[nid] = now
                    self.stats.note_member_state(nid, ALIVE)

    def start(self) -> "SwimMembership":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="fabric-gossip", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # ---- digests ----

    def digest(self) -> List[List[Any]]:
        with self._lock:
            return [m.entry() for m in self._members.values()]

    def merge(self, digest: Optional[Sequence[Sequence[Any]]],
              via: str = "") -> List[Tuple[str, str]]:
        """Apply a received digest; returns [(event, node_id), ...].
        The `fabric.membership.update` failpoint drops the whole update
        (gossip re-delivers it on a later frame)."""
        if not digest:
            return []
        try:
            failpoints.check("fabric.membership.update")
        except failpoints.FaultInjected:
            return []
        events: List[Tuple[str, str]] = []
        for row in digest:
            try:
                nid, status, inc, host, port = row
            except (TypeError, ValueError):
                continue
            events.extend(self._apply(
                str(nid), str(status), int(inc), str(host), int(port)
            ))
        self._dispatch(events)
        return events

    def _health_map(self) -> Dict[str, int]:
        """Everything this node knows about fleet health: learned peer
        bits plus its own freshly-sampled bits (last writer wins on the
        receiving side; our own entry is always recomputed, never
        echoed back stale)."""
        out = self.stats.peer_health_snapshot()
        if self.health_provider is not None:
            try:
                out[self.node_id] = int(self.health_provider())
            except Exception:  # health must never break gossip
                pass
        return out

    def merge_health(self, health: Any) -> None:
        """Absorb a received "health" piggyback map."""
        if not isinstance(health, dict):
            return
        for nid, bits in health.items():
            if str(nid) == self.node_id:
                continue  # own bits come from health_provider only
            try:
                self.stats.note_peer_health(str(nid), int(bits))
            except (TypeError, ValueError):
                continue

    # ---- transitions (the one funnel) ----

    def _apply(self, nid: str, status: str, inc: int,
               host: str, port: int) -> List[Tuple[str, str]]:
        """Pure state transition under the membership lock; returns the
        committed events WITHOUT firing side effects — callers dispatch
        after releasing the lock (the router path re-enters membership
        via ack piggybacks, so calling the router under this lock would
        be an ABBA deadlock)."""
        if status not in _RANK:
            return []
        actions: List[Tuple[str, str]] = []
        with self._lock:
            if nid == self.node_id:
                # refutation: someone thinks we are suspect/dead/left at
                # an incarnation that covers ours — outbid it
                me = self._members[nid]
                if status != ALIVE and inc >= me.incarnation:
                    me.incarnation = inc + 1
                    me.status = ALIVE
                    actions.append(("self_refute", nid))
                elif inc > me.incarnation:
                    me.incarnation = inc
                return actions
            cur = self._members.get(nid)
            if cur is None:
                m = Member(nid, host, port, inc, status)
                self._members[nid] = m
                self.stats.note_member_state(nid, status)
                if status == ALIVE:
                    self._last_alive[nid] = self._clock()
                    actions.append(("joined", nid))
                elif status == SUSPECT:
                    self._suspect_deadline[nid] = (
                        self._clock() + self.suspect_timeout_s
                    )
                    actions.append(("suspect", nid))
                return actions
            if inc < cur.incarnation or (
                inc == cur.incarnation
                and _RANK[status] <= _RANK[cur.status]
            ):
                if status == ALIVE and inc == cur.incarnation \
                        and cur.status == ALIVE:
                    self._last_alive[nid] = self._clock()
                return actions
            prev = cur.status
            cur.incarnation = inc
            cur.status = status
            if host and port:
                cur.host, cur.port = host, int(port)
            self.stats.note_member_state(nid, status)
            now = self._clock()
            if status == ALIVE:
                self._suspect_deadline.pop(nid, None)
                self._last_alive[nid] = now
                if prev == SUSPECT:
                    actions.append(("refuted", nid))
                elif prev in (DEAD, LEFT):
                    actions.append(("joined", nid))
            elif status == SUSPECT:
                self._suspect_deadline.setdefault(
                    nid, now + self.suspect_timeout_s
                )
                if prev == ALIVE:
                    actions.append(("suspect", nid))
            elif status == DEAD:
                self._suspect_deadline.pop(nid, None)
                if prev != DEAD:
                    self.stats.note_detection(
                        now - self._last_alive.get(nid, now)
                    )
                    actions.append(("confirmed_dead", nid))
            elif status == LEFT:
                self._suspect_deadline.pop(nid, None)
                if prev != LEFT:
                    actions.append(("left", nid))
            return actions

    def _dispatch(self, actions: List[Tuple[str, str]]
                  ) -> List[Tuple[str, str]]:
        """Fire the router/stats side effects for committed transitions.
        MUST be called without self._lock held (see _apply)."""
        for event, nid in actions:
            if event == "self_refute":
                self.stats.note_membership_event("refuted")
                continue
            self.stats.note_membership_event(event)
            if self.router is None:
                continue
            with self._lock:
                m = self._members.get(nid)
            if event == "confirmed_dead":
                self.router.mark_dead(nid, reason="gossip: suspicion "
                                                  "timeout expired")
            elif event in ("refuted", "joined"):
                if m is not None and nid not in self.router.ring.node_ids:
                    client = (
                        self.peer_factory(nid, m.host, m.port)
                        if self.peer_factory is not None else None
                    )
                    self.router.add_node(nid, client)
                elif m is not None:
                    self.router.mark_alive(nid, host=m.host, port=m.port)
            elif event == "left":
                self.router.mark_left(nid)
            elif event == "suspect":
                # suspicion alone does not reroute: the member keeps its
                # ranges until confirmed dead (or refutes)
                pass
        return actions

    # ---- externally-driven transitions ----

    def note_peer_up(self, nid: str, host: Optional[str] = None,
                     port: Optional[int] = None) -> bool:
        """The admin PEER_UP path.  Revives a non-alive member
        by outbidding its current incarnation; a second notification
        for an already-alive member is a no-op — this is the
        exactly-once announcement funnel."""
        with self._lock:
            cur = self._members.get(nid)
            if cur is not None and cur.status == ALIVE:
                if host and port:
                    cur.host, cur.port = host, int(port)
                return False
            inc = cur.incarnation + 1 if cur is not None else 0
            h = host or (cur.host if cur is not None else "")
            p = port or (cur.port if cur is not None else 0)
            actions = self._apply(nid, ALIVE, inc, h, int(p or 0))
        self._dispatch(actions)
        return bool(actions)

    def note_peer_down(self, nid: str) -> bool:
        """The admin PEER_DOWN path: declare dead at the
        member's current incarnation (a live node will refute)."""
        with self._lock:
            cur = self._members.get(nid)
            if cur is None or cur.status in (DEAD, LEFT):
                return False
            actions = self._apply(
                nid, DEAD, cur.incarnation, cur.host, cur.port
            )
        self._dispatch(actions)
        return bool(actions)

    def begin_leave(self) -> List[List[Any]]:
        """Mark self LEFT at a bumped incarnation and return the digest
        to announce.  The caller drains first (stop owning, flush);
        this is the final goodbye."""
        with self._lock:
            me = self._members[self.node_id]
            me.incarnation += 1
            me.status = LEFT
            self.stats.note_member_state(self.node_id, LEFT)
            self.stats.note_membership_event("left")
            return [m.entry() for m in self._members.values()]

    # ---- wire handlers (installed on the FabricNode) ----

    def handle_ping(self, payload: dict) -> Tuple[int, dict]:
        """T_GOSSIP_PING: merge the prober's digest, answer ours.  The
        `fabric.gossip.ack` failpoint sits before the answer — arm it
        with mode=sleep to fake a slow-but-alive node."""
        failpoints.check("fabric.gossip.ack")
        self.merge(payload.get("digest"), via=str(payload.get("from", "")))
        self.merge_health(payload.get("health"))
        return wire.T_GOSSIP_ACK, {
            "node_id": self.node_id, "digest": self.digest(),
            "health": self._health_map(),
        }

    def handle_ping_req(self, payload: dict) -> Tuple[int, dict]:
        """T_GOSSIP_PING_REQ: probe `target` on the requester's behalf
        (SWIM indirect probe — a one-hop path around a partitioned
        direct link)."""
        self.merge(payload.get("digest"), via=str(payload.get("from", "")))
        self.merge_health(payload.get("health"))
        target = str(payload.get("target", ""))
        with self._lock:
            m = self._members.get(target)
            addr = (m.host, m.port) if m is not None else None
        ok = False
        if addr is not None:
            ok = self._probe(target, addr[0], addr[1])
        return wire.T_GOSSIP_ACK, {
            "node_id": self.node_id, "ok": ok, "digest": self.digest(),
            "health": self._health_map(),
        }

    def handle_join(self, payload: dict) -> Tuple[int, dict]:
        """T_JOIN: a newcomer announces itself to this seed.  Insert it
        (gossip spreads the news) and answer the full membership so the
        joiner starts convergent."""
        nid = str(payload.get("node_id", ""))
        host = str(payload.get("host", ""))
        port = int(payload.get("port", 0))
        if nid:
            self.note_peer_up(nid, host=host, port=port)
        return wire.T_JOIN_R, {
            "node_id": self.node_id, "members": self.digest()
        }

    # ---- the probe loop ----

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # the gossip loop must never die
                pass

    def tick(self) -> None:
        """One protocol round: expire suspicions, complete any pending
        deadline-polled takeovers, probe the next member."""
        self._expire_suspicions()
        if self.router is not None:
            self.router.poll()
        target = self._next_probe_target()
        if target is None:
            return
        nid, host, port = target
        if self._probe(nid, host, port):
            self._apply_alive_evidence(nid)
            return
        if self._indirect_probe(nid):
            self._apply_alive_evidence(nid)
            return
        self._suspect_locally(nid)

    def _expire_suspicions(self) -> None:
        now = self._clock()
        actions: List[Tuple[str, str]] = []
        with self._lock:
            due = [nid for nid, dl in self._suspect_deadline.items()
                   if now >= dl]
            for nid in due:
                cur = self._members.get(nid)
                if cur is None or cur.status != SUSPECT:
                    self._suspect_deadline.pop(nid, None)
                    continue
                actions.extend(self._apply(
                    nid, DEAD, cur.incarnation, cur.host, cur.port
                ))
        self._dispatch(actions)

    def _next_probe_target(self) -> Optional[Tuple[str, str, int]]:
        with self._lock:
            candidates = {
                nid: m for nid, m in self._members.items()
                if nid != self.node_id and m.status in (ALIVE, SUSPECT)
            }
            if not candidates:
                return None
            self._probe_order = [
                nid for nid in self._probe_order if nid in candidates
            ]
            if not self._probe_order:
                self._probe_order = list(candidates)
                self._rng.shuffle(self._probe_order)
            nid = self._probe_order.pop(0)
            m = candidates[nid]
            return nid, m.host, m.port

    def _apply_alive_evidence(self, nid: str) -> None:
        with self._lock:
            cur = self._members.get(nid)
            if cur is None:
                return
            actions = self._apply(
                nid, ALIVE, cur.incarnation, cur.host, cur.port
            )
            self._last_alive[nid] = self._clock()
        self._dispatch(actions)

    def _suspect_locally(self, nid: str) -> None:
        with self._lock:
            cur = self._members.get(nid)
            if cur is None or cur.status != ALIVE:
                return
            actions = self._apply(
                nid, SUSPECT, cur.incarnation, cur.host, cur.port
            )
        self._dispatch(actions)

    def _indirect_probe(self, target: str) -> bool:
        """Ask up to `indirect_probes` other alive members to probe the
        target for us; any success is liveness evidence."""
        with self._lock:
            relays = [
                m for nid, m in self._members.items()
                if nid not in (self.node_id, target) and m.status == ALIVE
            ]
            self._rng.shuffle(relays)
            relays = relays[: self.indirect_probes]
        for relay in relays:
            resp = self._send(
                relay.host, relay.port, wire.T_GOSSIP_PING_REQ,
                {"from": self.node_id, "target": target,
                 "digest": self.digest(), "health": self._health_map()},
            )
            if resp is not None:
                self.merge(resp.get("digest"), via=relay.node_id)
                self.merge_health(resp.get("health"))
                if resp.get("ok"):
                    return True
        return False

    def _probe(self, nid: str, host: str, port: int) -> bool:
        resp = self._send(
            host, port, wire.T_GOSSIP_PING,
            {"from": self.node_id, "digest": self.digest(),
             "health": self._health_map()},
        )
        if resp is None:
            return False
        self.merge(resp.get("digest"), via=nid)
        self.merge_health(resp.get("health"))
        return True

    def _send(self, host: str, port: int, ftype: int,
              payload: dict) -> Optional[dict]:
        """One ephemeral request/response exchange.  Deliberately NOT
        the data-path PeerClient: a probe must not queue behind a large
        forwarded chunk, and its timeout is the gossip interval, not
        the send timeout."""
        try:
            failpoints.check("fabric.gossip.ping")
        except failpoints.FaultInjected:
            return None
        timeout = max(0.05, self.interval_s)
        try:
            with socket.create_connection(
                (host, port), timeout=timeout
            ) as sock:
                sock.settimeout(timeout)
                wire.send_frame(sock, ftype, payload)
                rtype, rpayload = wire.recv_frame(sock)
        except (OSError, ValueError):
            return None
        self.stats.note_gossip_bytes(
            len(json.dumps(payload, separators=(",", ":"))) + 5
        )
        if rtype != wire.T_GOSSIP_ACK:
            return None
        return rpayload

    # ---- introspection (fabric.json / T_STATS) ----

    def describe(self) -> Dict[str, object]:
        with self._lock:
            return {
                "node_id": self.node_id,
                "incarnation": self._members[self.node_id].incarnation,
                "members": {
                    nid: {
                        "status": m.status,
                        "incarnation": m.incarnation,
                        "addr": f"{m.host}:{m.port}",
                    }
                    for nid, m in sorted(self._members.items())
                },
                "suspects": sorted(self._suspect_deadline),
            }

    def status_of(self, nid: str) -> Optional[str]:
        with self._lock:
            m = self._members.get(nid)
            return m.status if m is not None else None
