"""Production assembly of the decision fabric for cli.BanjaxApp.

(A copy of `banjax_tpu/fabric/service.py`.)

One FabricService per process, built only when `fabric_enabled`.  It
owns the fabric pieces and exposes exactly the seams the app needs:

  * ``submit(lines)`` — the tailer's consume path: lines this shard
    owns go down the local pipeline, everything else rides a peer
    socket to its owner (router.py);
  * ``wrap_banner(banner)`` — decisions fan out to the command topic
    (replication.py) on top of whatever the inner banner effects;
  * ``dispatch_raw(raw)`` — the KafkaReader drain hook: own-origin
    echoes and duplicate (origin, seq) pairs are suppressed, fresh
    peer decisions are applied (idempotently) to the dynamic lists;
  * ``describe()`` — the flight recorder's fabric.json and the
    /metrics peer table.

Topology: `fabric_peers` seeds the ring.  With gossip membership on
(`fabric_gossip_interval_ms > 0`, the default) the SWIM layer
(membership.py) owns liveness from there — periodic probes confirm
deaths within the suspect timeout without waiting for a forwarded line
to fail, newcomers announce with T_JOIN and are ring-inserted live,
and graceful leavers gossip LEFT.  PEER_DOWN/PEER_UP admin frames
funnel through the same membership table so a rejoining worker is
announced exactly once.  With gossip off the fabric degrades to
the static behavior (death discovered by a failed send or an admin
frame only).

Where the JAX service stays on TCP when `fabric_shm_enabled` is set and
the shm ring cannot be built or mapped, the port raises: at construction
when the ring's library cannot be built, and from the pipe
(`ShmRingError`) when a ring cannot be created or the peer declines it.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional, Sequence

from banjax_tpu_torch.fabric import wire
from banjax_tpu_torch.fabric.hashring import ConsistentHashRing
from banjax_tpu_torch.fabric.membership import SwimMembership
from banjax_tpu_torch.fabric.node import FabricNode
from banjax_tpu_torch.fabric.peer import LinePipe, PeerClient, PeerUnavailable
from banjax_tpu_torch.fabric.replication import (
    DecisionReplicator,
    FabricDeduper,
    ReplicatingBanner,
)
from banjax_tpu_torch.fabric.router import FabricRouter, ip_of_line
from banjax_tpu_torch.fabric.stats import FabricStats


def _split_addr(addr: str) -> tuple:
    host, _, port = str(addr).rpartition(":")
    return host or "127.0.0.1", int(port)


class FabricService:
    def __init__(
        self,
        config: Any,
        local_submit: Callable[[Sequence[str]], int],
        apply_command: Callable[[Dict[str, Any]], None],
        health=None,
        transport: Any = None,
        metrics_text_fn: Optional[Callable[[], str]] = None,
        explain_fn: Optional[Callable[[str], Dict[str, Any]]] = None,
        health_bits_fn: Optional[Callable[[], int]] = None,
    ):
        if transport is None:
            from banjax_tpu_torch.ingest.kafka_wire import WireKafkaTransport

            transport = WireKafkaTransport()
        if config.fabric_shm_enabled:
            # the shm transport builds its ring library now: a shard that
            # cannot have it fails here, not at its first forward
            from banjax_tpu_torch.native import shmring

            shmring.ensure_built()
        self.node_id = config.fabric_node_id
        self.stats = FabricStats()
        self._send_timeout_ms = config.fabric_send_timeout_ms
        self._metrics_text_fn = metrics_text_fn
        self._explain_fn = explain_fn
        peers_cfg = dict(config.fabric_peers or {})
        node_ids = sorted(peers_cfg) if peers_cfg else [self.node_id]
        ring = ConsistentHashRing(node_ids, vnodes=config.fabric_vnodes)
        clients: Dict[str, Optional[PeerClient]] = {}
        for pid in node_ids:
            if pid == self.node_id:
                clients[pid] = None
                continue
            phost, pport = _split_addr(peers_cfg[pid])
            clients[pid] = PeerClient(
                pid, phost, pport,
                send_timeout_ms=config.fabric_send_timeout_ms,
            )
        self.replicator = DecisionReplicator(
            self.node_id, transport, config.kafka_command_topic,
            stats=self.stats, config=config, local_apply=apply_command,
        )
        self.deduper = FabricDeduper(
            self.node_id, apply_command, stats=self.stats
        )
        self._config = config
        self.router = FabricRouter(
            self.node_id, ring, clients, local_submit,
            stats=self.stats, health=health,
            takeover_grace_ms=config.fabric_takeover_grace_ms,
            pipe_factory=(
                self._make_pipe
                if getattr(config, "fabric_inflight_frames", 0) > 0
                else None
            ),
            trace_propagation=getattr(
                config, "fabric_trace_propagation", False
            ),
        )
        lhost, lport = _split_addr(config.fabric_listen)
        self.membership: Optional[SwimMembership] = None
        handlers = {
            wire.T_LINES: self._h_lines,
            wire.T_LINES_V2: self._h_lines_v2,
            wire.T_PING: self._h_ping,
            wire.T_PEER_DOWN: self._h_peer_down,
            wire.T_PEER_UP: self._h_peer_up,
            wire.T_STATS: self._h_stats,
            wire.T_EXPLAIN: self._h_explain,
            wire.T_FLIGHTREC: self._h_flightrec,
        }
        if getattr(config, "fabric_gossip_interval_ms", 0) > 0:
            self.membership = SwimMembership(
                self.node_id, lhost, lport,
                router=self.router, stats=self.stats,
                gossip_interval_ms=config.fabric_gossip_interval_ms,
                suspect_timeout_ms=config.fabric_suspect_timeout_ms,
                indirect_probes=config.fabric_indirect_probes,
                peer_factory=self._make_client,
                health_provider=health_bits_fn,
            )
            self.membership.seed({
                pid: _split_addr(addr) for pid, addr in peers_cfg.items()
            })
            # convergence rides the data path: digests piggybacked on
            # forwarded-chunk acks feed the membership table
            self.router.gossip_merge = self.membership.merge
            handlers[wire.T_GOSSIP_PING] = self.membership.handle_ping
            handlers[wire.T_GOSSIP_PING_REQ] = self.membership.handle_ping_req
            handlers[wire.T_JOIN] = self.membership.handle_join
        self.node = FabricNode(lhost, lport, handlers=handlers)
        self._local_submit = local_submit
        # keyword-capable submit seam (pipeline e2e latency):
        # probed ONCE — a plain `lambda lines: n` test double keeps
        # working, a (lines, t_read=, hop=) callable gets the hop stamp
        try:
            params = inspect.signature(local_submit).parameters
            self._local_kw = "t_read" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values()
            )
        except (TypeError, ValueError):
            self._local_kw = False

    def _make_client(self, pid: str, host: str, port: int) -> PeerClient:
        return PeerClient(
            pid, host, port, send_timeout_ms=self._send_timeout_ms
        )

    def _make_pipe(self, pid: str, host: str, port: int, on_ack) -> LinePipe:
        """Router's pipelined data-path factory (fabric_inflight_frames
        > 0): one windowed LinePipe per forwarded-to peer."""
        c = self._config
        return LinePipe(
            pid, host, port, node_id=self.node_id,
            send_timeout_ms=c.fabric_send_timeout_ms,
            inflight_frames=c.fabric_inflight_frames,
            frame_max_bytes=c.fabric_frame_max_bytes,
            wire_v2=c.fabric_wire_v2,
            shm=c.fabric_shm_enabled,
            shm_ring_bytes=c.fabric_shm_ring_bytes,
            stats=self.stats, on_ack=on_ack,
            trace_propagation=getattr(c, "fabric_trace_propagation", False),
        )

    # ---- lifecycle ----

    def start(self) -> "FabricService":
        self.node.start()
        if self.membership is not None:
            self.membership.start()
        return self

    def stop(self) -> None:
        if self.membership is not None:
            self.membership.stop()
        self.router.flush(2.0)  # land in-flight forwards, best effort
        self.router.close()
        self.node.stop()
        for client in self.router.peers.values():
            if client is not None:
                client.close()

    # ---- app seams ----

    def submit(self, lines: Sequence[str],
               t_read: Optional[float] = None) -> Dict[str, int]:
        """The tailer's consume path: route every line to its owner.
        ``t_read`` is the tailer's monotonic read stamp — it rides the
        wire with forwarded chunks so the owner's e2e histogram charges
        the fabric hop its true cost."""
        return self.router.route(lines, t_read=t_read)

    def wrap_banner(self, banner: Any) -> ReplicatingBanner:
        return ReplicatingBanner(banner, self.replicator)

    def dispatch_raw(self, raw: Any) -> None:
        """KafkaReader drain hook (replaces the default dispatch)."""
        self.deduper.dispatch(raw)

    def describe(self) -> Dict[str, object]:
        out: Dict[str, object] = {"enabled": True}
        out.update(self.router.describe())
        out["stats"] = self.stats.peek()
        if self.membership is not None:
            out["membership"] = self.membership.describe()
        return out

    # ---- wire handlers (peer side) ----

    def _drain_forwarded(self, lines, origin_node: str = "",
                         origin_runs=(), origin_t_read=None) -> None:
        """Owner-side drain of a forwarded chunk.

        When the sender propagated origin attribution, three things
        happen here (the cross-host half of the tentpole): each line's
        IP is noted in the OriginIndex so a ban fired from this chunk
        carries ``(origin_node, origin_trace_id)`` in its provenance
        record; a linked ``fabric.remote-drain`` span opens under the
        ORIGIN trace id (same trace as the admission batch tailed on
        the sender); and the submit is stamped hop="fabric" with the
        sender's read time so the e2e histogram spans the wire."""
        from banjax_tpu_torch.obs import trace

        spans = []
        if origin_node:
            runs = [(int(t), int(c)) for t, c in (origin_runs or ())]
            if not runs:
                runs = [(0, len(lines))]
            from banjax_tpu_torch.obs import fleet

            idx = fleet.get_origin_index()
            pos = 0
            for tid, count in runs:
                for ln in lines[pos:pos + count]:
                    idx.note(ip_of_line(ln), origin_node, tid)
                if tid:
                    spans.append(trace.begin(
                        "fabric.remote-drain", tid,
                        args={"origin_node": origin_node, "lines": count},
                    ))
                pos += count
        try:
            if self._local_kw:
                # 0.0 is the wire's "unset" stamp (monotonic time is
                # never 0 on a live sender) — don't charge the epoch
                t_read = float(origin_t_read) if origin_t_read else None
                self._local_submit(lines, t_read=t_read, hop="fabric")
            else:
                self._local_submit(lines)
        finally:
            for sp in spans:
                trace.end(sp)

    @staticmethod
    def _parse_json_origin(payload: dict):
        """(origin_node, runs, t_read) from a JSON T_LINES ``origin``
        key; empty/None triple when absent or malformed."""
        origin = payload.get("origin")
        if not isinstance(origin, dict):
            return "", (), None
        node = str(origin.get("node", ""))
        runs = []
        try:
            for t, c in origin.get("runs") or ():
                runs.append((int(t), int(c)))
        except (TypeError, ValueError):
            runs = []
        t_read = origin.get("t_read")
        try:
            t_read = float(t_read) if t_read is not None else None
        except (TypeError, ValueError):
            t_read = None
        return node, tuple(runs), t_read

    def _h_lines(self, payload: dict):
        lines = payload.get("lines", [])
        self.stats.note_received(len(lines))
        piggy = (
            {"gossip": self.membership.digest()}
            if self.membership is not None else {}
        )
        if "seq" in payload:
            # a pipelined JSON-mode sender matches acks FIFO by seq
            piggy["seq"] = payload["seq"]
        if payload.get("route"):
            out = self.router.route(
                lines, replay=bool(payload.get("replay"))
            )
            if out["forwarded"]:
                # ack upstream == landed at the final owner (the replay
                # dedupe filter's soundness rests on this)
                self.router.flush(15.0)
            return wire.T_ACK, {"n": len(lines), **out, **piggy}
        node, runs, t_read = self._parse_json_origin(payload)
        self._drain_forwarded(lines, node, runs, t_read)
        self.stats.note_local(len(lines))
        return wire.T_ACK, {"n": len(lines), "local": len(lines), **piggy}

    def _h_lines_v2(self, fr):
        # binary data frame (wire.LinesV2): a peer's pipelined forward —
        # the sender computed ownership, the lines are ours
        lines = list(fr.lines)
        self.stats.note_received(len(lines))
        self._drain_forwarded(
            lines, fr.origin_node, fr.origin_runs,
            fr.origin_t_read if fr.origin_node else None,
        )
        self.stats.note_local(len(lines))
        ack = {"seq": fr.seq, "n": len(lines), "local": len(lines)}
        if self.membership is not None:
            ack["gossip"] = self.membership.digest()
        return wire.T_ACK, ack

    def _h_ping(self, payload: dict):
        return wire.T_PONG, {"node_id": self.node_id}

    def _h_peer_down(self, payload: dict):
        pid = str(payload.get("peer", ""))
        if self.membership is not None:
            self.membership.note_peer_down(pid)
        else:
            self.router.mark_dead(pid, reason="peer_down frame")
        return wire.T_ACK, {}

    def _h_peer_up(self, payload: dict):
        pid = str(payload.get("peer", ""))
        host, port = payload.get("host"), payload.get("port")
        if self.membership is not None:
            # exactly-once funnel: a duplicate notification (a dry-run
            # handshake racing gossip discovery) is a no-op
            self.membership.note_peer_up(pid, host=host, port=port)
        else:
            self.router.mark_alive(pid, host=host, port=port)
        return wire.T_ACK, {}

    def _h_stats(self, payload: dict):
        out = {
            "node_id": self.node_id,
            "fabric": self.stats.peek(),
            "router": self.router.describe(),
        }
        if self.membership is not None:
            out["membership"] = self.membership.describe()
        if payload.get("metrics") and self._metrics_text_fn is not None:
            # federated scrape pull (obs/fleet.py FleetScraper): the
            # peer's FULL exposition rides the stats reply — one frame,
            # no second HTTP surface to reach into the fleet
            try:
                out["metrics_text"] = self._metrics_text_fn()
            except Exception as e:  # noqa: BLE001 — a render bug must not kill the link
                out["metrics_error"] = str(e)
        return wire.T_STATS_R, out

    def _h_explain(self, payload: dict):
        # cross-shard /decisions/explain: the shard that OWNS the IP
        # answers from its local ledger; the asking node tags the
        # response with our id (httpapi/server.py proxy branch)
        ip = str(payload.get("ip", ""))
        if self._explain_fn is None:
            raise ValueError("explain unavailable on this node")
        out = dict(self._explain_fn(ip) or {})
        out["node_id"] = self.node_id
        return wire.T_EXPLAIN_R, out

    def _h_flightrec(self, payload: dict):
        # a peer's incident capture fan-out: answer with THIS node's
        # snapshot files (never re-fan-out — the origin node owns the
        # incident; a capture storm cannot echo)
        from banjax_tpu_torch.obs import fleet

        return wire.T_FLIGHTREC_R, {
            "node_id": self.node_id,
            "incident": str(payload.get("incident", "")),
            "files": fleet.local_capture_files(
                metrics_text_fn=self._metrics_text_fn,
                fabric_fn=self.describe,
            ),
        }

    # ---- fleet observability seams (obs/fleet.py) ----

    def fleet_pull_peers(self) -> Dict[str, Callable[[], str]]:
        """{node_id: pull} over every ALIVE remote member for the
        federated scrape — pull() raises on an unreachable/mute peer."""
        out: Dict[str, Callable[[], str]] = {}
        for pid, client in sorted(self.router.alive_peers().items()):
            def pull(c=client) -> str:
                rtype, rpayload = c.request(wire.T_STATS, {"metrics": True})
                text = rpayload.get("metrics_text")
                if rtype != wire.T_STATS_R or not isinstance(text, str):
                    raise OSError(
                        rpayload.get("metrics_error", "no metrics in reply")
                    )
                return text
            out[pid] = pull
        return out

    def fleet_capture_peers(
        self,
    ) -> Dict[str, Callable[[str], Dict[str, str]]]:
        """{node_id: capture} for obs.fleet.capture_fleet — capture()
        performs the T_FLIGHTREC exchange and returns the peer's file
        map for the bundle's peers/<node_id>/ tree."""
        out: Dict[str, Callable[[str], Dict[str, str]]] = {}
        for pid, client in sorted(self.router.alive_peers().items()):
            def cap(incident_id: str, c=client) -> Dict[str, str]:
                rtype, rpayload = c.request(
                    wire.T_FLIGHTREC,
                    {"incident": incident_id, "from": self.node_id},
                )
                files = rpayload.get("files")
                if rtype != wire.T_FLIGHTREC_R or not isinstance(files, dict):
                    raise OSError("no capture files in reply")
                return files
            out[pid] = cap
        return out

    def explain_remote(self, owner: str, ip: str) -> Dict[str, Any]:
        """One cross-shard explain exchange (httpapi proxy branch);
        raises on an unreachable owner."""
        client = self.router.alive_peers().get(owner)
        if client is None:
            raise PeerUnavailable(f"owner {owner} has no alive client")
        rtype, rpayload = client.request(wire.T_EXPLAIN, {"ip": ip})
        if rtype != wire.T_EXPLAIN_R:
            raise OSError(f"unexpected explain reply type {rtype}")
        return rpayload
