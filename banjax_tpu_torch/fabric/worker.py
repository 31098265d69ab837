"""One fabric shard as a real OS process (a port of
`banjax_tpu/fabric/worker.py`).

`python -m banjax_tpu_torch.fabric.worker --node-id w0 ...` builds the full
single-process engine (the same `build_engine` assembly the scenario
harness drives) on `--device` — `cuda:0` unless asked for the CPU; a
worker asked for the card where there is none says so on its READY line
and raises, and each worker process holds its own CUDA context — wraps its banner with the decision replicator, attaches
a REAL KafkaReader to the command topic for peer decisions, and serves
the fabric wire protocol on a socket.  The dryrun harness spawns N of
these, kills one mid-flood, and audits the survivors.

Startup protocol (stdout, one JSON line):  the worker prints
`{"ready": true, "node_id": ..., "port": ...}` only after the engine is
warmed (device compile done) and the kafka reader has proven attached
(its own `fabric_ping` round-tripped), so a SIGKILL any time after
READY lands on a fully live shard.  T_STATS (and the T_LEAVE ack) carry
the process's launch counts of kernels A, B and C.

Two ways into the ring:

  * **HELLO** (harness-pushed topology): the harness sends T_HELLO with
    the full peer map; gossip membership starts from it as a seed when
    the payload carries `gossip_interval_ms > 0`.
  * **--join host:port** (automatic join, no harness involvement): the
    worker announces itself to one live seed with T_JOIN, builds its
    router from the returned membership digest, pulls the seed's
    decision snapshot (T_SNAPSHOT -> local T_SYNC application), starts
    gossiping, and only then prints READY — the surviving fleet learns
    of it purely through gossip, no restarts, no broadcast.

Planned leave (T_LEAVE): stop owning (router.mark_left on self — every
subsequent line forwards to its new owner), flush the pipeline to
quiescence, announce LEFT via a final gossip digest to every alive
member, then depart.  Crash takeover replays the victim's journal;
graceful leave hands ranges back with the journal untouched-by-replay
because nothing was lost.
"""

from __future__ import annotations

import argparse
import json
import socket as _socket
import sys
import threading
import time


def _launches() -> dict:
    """This process's launch counts of the three kernels (their wrappers
    count each launch; the plain versions on the CPU count none)."""
    from banjax_tpu_torch.matcher.kernels import fused_match_window, nfa_match, pow_verify

    return {
        "nfa_match": nfa_match.KERNEL.launches,
        "window_scan": fused_match_window.KERNEL.launches,
        "pow_verify": pow_verify.KERNEL.launches,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="banjax fabric shard worker")
    ap.add_argument("--node-id", required=True)
    ap.add_argument("--device", default="cuda:0",
                    help="where the engine runs: cuda:N (the default, "
                         "raising when there is no card) or cpu (the "
                         "kernels' plain versions)")
    ap.add_argument("--listen-port", type=int, default=0)
    ap.add_argument("--broker-port", type=int, default=0,
                    help="kafka broker port for decision replication "
                         "(0 = replication off)")
    ap.add_argument("--send-timeout-ms", type=float, default=800.0)
    ap.add_argument("--grace-ms", type=float, default=200.0)
    ap.add_argument("--vnodes", type=int, default=64)
    ap.add_argument("--gossip-interval-ms", type=float, default=0.0,
                    help="SWIM probe cadence; 0 = gossip off (HELLO "
                         "payload may still enable it)")
    ap.add_argument("--suspect-timeout-ms", type=float, default=1200.0)
    ap.add_argument("--indirect-probes", type=int, default=2)
    ap.add_argument("--graceful-leave-ms", type=float, default=5000.0)
    ap.add_argument("--inflight-frames", type=int, default=8,
                    help="pipelined data-path window per peer "
                         "(0 = synchronous JSON forwards, the "
                         "differential oracle)")
    ap.add_argument("--frame-max-bytes", type=int, default=1 << 20)
    ap.add_argument("--wire-v2", type=int, default=1)
    ap.add_argument("--shm", type=int, default=0,
                    help="1 = co-located peers exchange frames over "
                         "shm rings instead of loopback TCP")
    ap.add_argument("--shm-ring-bytes", type=int, default=1 << 21)
    ap.add_argument("--trace-propagation", type=int, default=0,
                    help="1 = forwarded chunks carry (origin node, "
                         "origin trace id) and owner-side drains open "
                         "linked fabric.remote-drain spans")
    ap.add_argument("--join", default="",
                    help="host:port of one live member — join its ring "
                         "via gossip announce + snapshot sync instead of "
                         "waiting for a harness HELLO")
    args = ap.parse_args(argv)

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"ready": False,
                          "error": f"--device {args.device}: no CUDA device"}),
              flush=True)
        raise RuntimeError(f"fabric worker asked for {args.device}, and no CUDA "
                           "device is available")

    from banjax_tpu_torch.decisions.model import Decision
    from banjax_tpu_torch.fabric import membership as swim
    from banjax_tpu_torch.fabric import wire
    from banjax_tpu_torch.fabric.node import FabricNode
    from banjax_tpu_torch.fabric.peer import LinePipe, PeerClient
    from banjax_tpu_torch.fabric.replication import (
        DecisionReplicator,
        FabricDeduper,
        ReplicatingBanner,
    )
    from banjax_tpu_torch.fabric.router import FabricRouter
    from banjax_tpu_torch.fabric.hashring import ConsistentHashRing
    from banjax_tpu_torch.fabric.stats import FabricStats
    from banjax_tpu_torch.fabric.router import ip_of_line
    from banjax_tpu_torch.ingest.kafka_io import handle_command
    from banjax_tpu_torch.obs import fleet, provenance, trace
    from banjax_tpu_torch.obs.exposition import render_prometheus
    from banjax_tpu_torch.resilience import failpoints
    from banjax_tpu_torch.resilience.health import HealthRegistry
    from banjax_tpu_torch.scenarios.runtime import (
        RecordingBanner,
        _WARM_IP,
        build_engine,
    )
    from banjax_tpu_torch.scenarios.shapes import RULES_YAML, T0

    node_id = args.node_id
    fstats = FabricStats()
    health = HealthRegistry()
    inner_banner = RecordingBanner()
    replicator = None
    banner = inner_banner
    if args.broker_port:
        from banjax_tpu_torch.ingest.kafka_wire import WireKafkaTransport

        replicator = DecisionReplicator(
            origin=node_id,
            transport=WireKafkaTransport(),
            topic="fabric.commands",
            stats=fstats,
        )
        banner = ReplicatingBanner(inner_banner, replicator)

    parts = build_engine(
        RULES_YAML,
        device=args.device,
        banner=banner,
        kafka_broker_port=args.broker_port or None,
        kafka_command_topic="fabric.commands",
        kafka_report_topic="fabric.reports",
        cfg_overrides={
            "fabric_enabled": True,
            "fabric_node_id": node_id,
            "fabric_listen": "127.0.0.1:0",
            "fabric_vnodes": args.vnodes,
            "fabric_send_timeout_ms": args.send_timeout_ms,
            "fabric_takeover_grace_ms": args.grace_ms,
            "fabric_gossip_interval_ms": args.gossip_interval_ms,
            "fabric_suspect_timeout_ms": max(
                args.suspect_timeout_ms, args.gossip_interval_ms * 2 + 1
            ),
            "fabric_indirect_probes": args.indirect_probes,
            "fabric_graceful_leave_ms": args.graceful_leave_ms,
        },
    )
    cfg, sched, dynamic_lists = parts.cfg, parts.sched, parts.dynamic_lists
    # owner half of the cross-host trace join: forwarded-line bans
    # resolve (origin_node, origin_trace) through the fleet index —
    # inert until a propagating sender actually feeds it
    provenance.set_origin_resolver(fleet.get_origin_index().resolve)
    if args.trace_propagation:
        # origin half: router-allocated trace ids need a live span ring
        trace.configure(enabled=True)
    if replicator is not None:
        replicator.configure(cfg)
        # the origin's own kafka echo is suppressed by the deduper, so
        # its decisions land in its dynamic lists here, at publish time
        replicator.local_apply = lambda cmd: handle_command(
            cfg, cmd, dynamic_lists
        )
    sched.start()

    # ---- kafka replication consumer (real reader, real wire) ----
    reader = None
    kafka_ready = threading.Event()
    if args.broker_port:
        from banjax_tpu_torch.ingest.kafka_io import KafkaReader
        from banjax_tpu_torch.ingest.kafka_wire import WireKafkaTransport
        from banjax_tpu_torch.resilience.backoff import reconnect_backoff

        deduper = FabricDeduper(
            origin=node_id,
            apply_command=lambda cmd: handle_command(
                cfg, cmd, dynamic_lists
            ),
            stats=fstats,
        )

        def _dispatch(raw) -> None:
            data = raw if isinstance(raw, bytes) else raw.encode()
            if b"fabric_ping" in data:
                try:
                    ping = json.loads(data)
                except ValueError:
                    return
                if ping.get("fabric_origin") == node_id:
                    kafka_ready.set()
                return
            deduper.dispatch(raw)

        class _Holder:
            def get(self):
                return cfg

        reader = KafkaReader(
            _Holder(), dynamic_lists, transport=WireKafkaTransport(),
            backoff=reconnect_backoff(cap=0.2, base=0.05),
            pipeline=sched,
        )
        reader.dispatch_raw = _dispatch
        reader.start()

    # ---- warmup (compile outside the measured window) ----
    warm = [
        f"{T0:.6f} {_WARM_IP} GET warm.example GET /about HTTP/1.1 warm -"
        for _ in range(48)
    ]
    for _ in range(2):
        sched.submit(list(warm))
        if not sched.flush(600):
            print(json.dumps({"ready": False, "error": "warmup hang"}),
                  flush=True)
            return 2

    # the reader attaches at the log tail at an unobservable moment:
    # keep producing pings until our own round-trips (same handshake as
    # the scenario harness's kafka mode)
    if reader is not None and replicator is not None:
        ping = json.dumps(
            {"Name": "fabric_ping", "fabric_origin": node_id}
        ).encode()
        deadline = time.monotonic() + 30
        while not kafka_ready.wait(0.05):
            if time.monotonic() > deadline:
                print(json.dumps(
                    {"ready": False, "error": "kafka never attached"}
                ), flush=True)
                return 2
            try:
                replicator.transport.send(cfg, "fabric.commands", ping)
            except OSError:
                pass

    # ---- fabric server ----
    shutdown = threading.Event()
    state = {"router": None, "membership": None}

    def _local_submit(lines, t_read=None, hop="local") -> int:
        sched.submit(list(lines), t_read=t_read, hop=hop)
        return len(lines)

    def _metrics_text() -> str:
        return render_prometheus(
            dynamic_lists, {}, {}, matcher=parts.matcher,
            pipeline=sched, fabric=fstats,
        )

    def _health_bits() -> int:
        return fleet.compute_health_bits(matcher=parts.matcher)

    def _drain_forwarded(lines, origin_node="", origin_runs=(),
                         origin_t_read=None):
        """Owner-side drain of a forwarded chunk (mirrors
        fabric/service.py): feed the OriginIndex, open linked
        fabric.remote-drain spans under the ORIGIN trace ids, stamp the
        submit hop=fabric with the sender's read time."""
        spans = []
        if origin_node:
            runs = [(int(t), int(c)) for t, c in (origin_runs or ())]
            if not runs:
                runs = [(0, len(lines))]
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
            t_read = float(origin_t_read) if origin_t_read else None
            _local_submit(lines, t_read=t_read, hop="fabric")
        finally:
            for sp in spans:
                trace.end(sp)

    def _make_client(pid, host, port, timeout_ms=None):
        return PeerClient(
            pid, host, int(port),
            send_timeout_ms=float(timeout_ms or args.send_timeout_ms),
        )

    def _pipe_factory_from(payload):
        """Build the router's LinePipe factory from transport knobs in
        the HELLO payload (harness-pushed) falling back to the CLI args
        (join path).  inflight 0 disables the pipelined data path —
        forwards stay on the synchronous JSON oracle."""
        inflight = int(payload.get("inflight_frames", args.inflight_frames))
        if inflight <= 0:
            return None
        v2 = bool(payload.get("wire_v2", args.wire_v2))
        frame_max = int(payload.get("frame_max_bytes", args.frame_max_bytes))
        shm = bool(payload.get("shm", args.shm))
        ring_bytes = int(payload.get("shm_ring_bytes", args.shm_ring_bytes))
        timeout_ms = float(
            payload.get("send_timeout_ms", args.send_timeout_ms)
        )
        trace_prop = bool(
            payload.get("trace_propagation", args.trace_propagation)
        )

        def factory(pid, host, port, on_ack):
            return LinePipe(
                pid, host, int(port), node_id=node_id,
                send_timeout_ms=timeout_ms,
                inflight_frames=inflight,
                frame_max_bytes=frame_max,
                wire_v2=v2, shm=shm, shm_ring_bytes=ring_bytes,
                stats=fstats, on_ack=on_ack,
                trace_propagation=trace_prop,
            )
        return factory

    def _start_membership(router, seeds, gossip_ms, suspect_ms,
                          indirect, listen_port):
        ms = swim.SwimMembership(
            node_id, "127.0.0.1", listen_port,
            router=router, stats=fstats,
            gossip_interval_ms=gossip_ms,
            suspect_timeout_ms=suspect_ms,
            indirect_probes=indirect,
            peer_factory=_make_client,
            health_provider=_health_bits,
        )
        if seeds:
            ms.seed(seeds)
        router.gossip_merge = ms.merge
        state["membership"] = ms
        ms.start()
        return ms

    def h_hello(payload):
        peers_map = payload.get("peers", {})
        ring = ConsistentHashRing(
            peers_map.keys(), vnodes=int(payload.get("vnodes", args.vnodes))
        )
        clients = {}
        for pid, addr in peers_map.items():
            if pid == node_id:
                clients[pid] = None
                continue
            clients[pid] = _make_client(
                pid, addr[0], addr[1],
                payload.get("send_timeout_ms", args.send_timeout_ms),
            )
        router = FabricRouter(
            node_id, ring, clients, _local_submit, stats=fstats,
            health=health,
            takeover_grace_ms=float(
                payload.get("grace_ms", args.grace_ms)
            ),
            pipe_factory=_pipe_factory_from(payload),
            trace_propagation=bool(payload.get(
                "trace_propagation", args.trace_propagation
            )),
        )
        state["router"] = router
        gossip_ms = float(
            payload.get("gossip_interval_ms", args.gossip_interval_ms)
        )
        if gossip_ms > 0:
            _start_membership(
                router,
                {pid: (addr[0], int(addr[1]))
                 for pid, addr in peers_map.items()},
                gossip_ms,
                float(payload.get(
                    "suspect_timeout_ms", args.suspect_timeout_ms
                )),
                int(payload.get("indirect_probes", args.indirect_probes)),
                node.port,
            )
        return wire.T_HELLO_R, {"node_id": node_id}

    def h_lines(payload):
        lines = payload.get("lines", [])
        fstats.note_received(len(lines))
        router = state["router"]
        ms = state["membership"]
        piggy = {"gossip": ms.digest()} if ms is not None else {}
        if "seq" in payload:
            # a pipelined JSON-mode sender matches acks FIFO by seq
            piggy["seq"] = payload["seq"]
        if payload.get("route") and router is not None:
            out = router.route(
                lines, replay=bool(payload.get("replay"))
            )
            if out["forwarded"]:
                # our ack upstream must mean LANDED, not in-window: a
                # SIGKILL here would otherwise take acked-but-unflushed
                # survivor-owned lines down with us, and the replay
                # dedupe filter would (rightly) refuse to re-run them
                router.flush(15.0)
            return wire.T_ACK, {"n": len(lines), **out, **piggy}
        origin = payload.get("origin")
        origin = origin if isinstance(origin, dict) else {}
        _drain_forwarded(
            lines,
            str(origin.get("node", "")),
            origin.get("runs") or (),
            origin.get("t_read"),
        )
        fstats.note_local(len(lines))
        return wire.T_ACK, {
            "n": len(lines), "local": len(lines), **piggy
        }

    def h_lines_v2(fr):
        # binary data frame (wire.LinesV2): a peer's pipelined forward —
        # ownership was already computed by the sender, so the lines go
        # straight down the local pipeline
        lines = list(fr.lines)
        fstats.note_received(len(lines))
        _drain_forwarded(
            lines, fr.origin_node, fr.origin_runs, fr.origin_t_read
        )
        fstats.note_local(len(lines))
        ms = state["membership"]
        ack = {"seq": fr.seq, "n": len(lines), "local": len(lines)}
        if ms is not None:
            ack["gossip"] = ms.digest()
        return wire.T_ACK, ack

    def h_peer_down(payload):
        pid = str(payload.get("peer", ""))
        ms = state["membership"]
        router = state["router"]
        if ms is not None:
            ms.note_peer_down(pid)
        elif router is not None:
            router.mark_dead(pid, reason="harness broadcast")
        return wire.T_ACK, {}

    def h_peer_up(payload):
        pid = str(payload.get("peer", ""))
        ms = state["membership"]
        router = state["router"]
        if ms is not None:
            # exactly-once funnel: a duplicate notification (harness
            # handshake racing gossip discovery) is a no-op here
            ms.note_peer_up(
                pid, host=payload.get("host"), port=payload.get("port")
            )
        elif router is not None:
            router.mark_alive(
                pid, host=payload.get("host"), port=payload.get("port")
            )
        return wire.T_ACK, {}

    def h_gossip_ping(payload):
        ms = state["membership"]
        if ms is None:
            return wire.T_ERR, {"error": "gossip disabled"}
        return ms.handle_ping(payload)

    def h_gossip_ping_req(payload):
        ms = state["membership"]
        if ms is None:
            return wire.T_ERR, {"error": "gossip disabled"}
        return ms.handle_ping_req(payload)

    def h_join(payload):
        ms = state["membership"]
        if ms is None:
            return wire.T_ERR, {"error": "gossip disabled"}
        return ms.handle_join(payload)

    def h_leave(payload):
        """Planned leave: drain, hand back, announce, depart."""
        t0 = time.monotonic()
        ms = state["membership"]
        router = state["router"]
        if router is not None:
            # stop owning FIRST: every line arriving after this forwards
            # to its new owner, so nothing new lands in our pipeline
            router.mark_left(node_id)
        budget_s = float(
            payload.get("timeout", args.graceful_leave_ms / 1000.0)
        )
        drained = True
        if router is not None:
            # land every in-flight forward before draining the local
            # pipeline: a departing shard leaves no frame on the wire
            drained = router.flush(max(budget_s, 1.0))
        flushed = sched.flush(max(budget_s, 1.0)) and drained
        announced = 0
        if ms is not None:
            digest = ms.begin_leave()
            for row in digest:
                rid, status, _inc, host, port = row
                if rid == node_id or status != swim.ALIVE:
                    continue
                if ms._send(
                    host, int(port), wire.T_GOSSIP_PING,
                    {"from": node_id, "digest": digest},
                ) is not None:
                    announced += 1
            ms.stop()
        # depart shortly after the ack flushes to the admin socket
        threading.Timer(0.3, shutdown.set).start()
        return wire.T_ACK, {
            "flushed": bool(flushed),
            "announced": announced,
            "drain_ms": (time.monotonic() - t0) * 1000.0,
            # final ledger: the harness audits the leaver's zero-shed /
            # zero-replay claim after the process is gone
            "sched": sched.stats.peek(),
            "fabric": fstats.peek(),
            "bans": list(inner_banner.regex_ban_logs),
            "launches": _launches(),
            "resent": router.resent() if router is not None else {"frames": 0, "lines": 0},
        }

    def h_failpoint(payload):
        """Harness chaos surface: arm/disarm a named failpoint in THIS
        process (the slow-node suspect/refute cycle arms
        fabric.gossip.ack with mode=sleep here)."""
        name = str(payload.get("name", ""))
        if name not in failpoints.KNOWN_SITES:
            return wire.T_ERR, {"error": f"unknown failpoint {name!r}"}
        if payload.get("disarm"):
            failpoints.disarm(name)
            return wire.T_ACK, {"disarmed": name}
        failpoints.arm(
            name,
            mode=str(payload.get("mode", "error")),
            count=payload.get("count"),
            delay_s=float(payload.get("delay_s", 0.0)),
            probability=float(payload.get("probability", 1.0)),
        )
        return wire.T_ACK, {"armed": name}

    def h_stats(payload):
        router = state["router"]
        ms = state["membership"]
        out = {
            "node_id": node_id,
            "sched": sched.stats.peek(),
            "fabric": fstats.peek(),
            "bans": list(inner_banner.regex_ban_logs),
            "decisions": list(inner_banner.decisions),
            "dynamic": list(dynamic_lists.metrics()),
            "router": router.describe() if router is not None else None,
            "membership": ms.describe() if ms is not None else None,
            "detection": fstats.detection_snapshot()[1],
            "launches": _launches(),
            "resent": router.resent() if router is not None else {"frames": 0, "lines": 0},
        }
        if payload.get("metrics"):
            # federated scrape pull (obs/fleet.py FleetScraper)
            try:
                out["metrics_text"] = _metrics_text()
            except Exception as e:  # noqa: BLE001 — a render bug must not kill the link
                out["metrics_error"] = str(e)
        return wire.T_STATS_R, out

    def h_explain(payload):
        # cross-shard /decisions/explain: answer from THIS shard's
        # ledger, tagged with our id so the asker can attribute it
        ip = str(payload.get("ip", ""))
        ed = dynamic_lists.format_ip_entries().get(ip)
        return wire.T_EXPLAIN_R, {
            "node_id": node_id,
            "ip": ip,
            "ledger_enabled": provenance.enabled(),
            "records": provenance.get_ledger().explain(ip),
            "active_decision": ed.decision.name if ed is not None else None,
        }

    def h_flightrec(payload):
        # a peer's incident fan-out: contribute THIS node's snapshot
        # (never re-fan-out — the origin owns the incident)
        router = state["router"]
        return wire.T_FLIGHTREC_R, {
            "node_id": node_id,
            "incident": str(payload.get("incident", "")),
            "files": fleet.local_capture_files(
                metrics_text_fn=_metrics_text,
                fabric_fn=(
                    router.describe if router is not None
                    else lambda: {"enabled": False}
                ),
            ),
        }

    def h_snapshot(payload):
        entries = []
        for ip, ed in dynamic_lists.format_ip_entries().items():
            entries.append([
                ip, ed.decision.name, ed.expires,
                getattr(ed, "domain", "") or "",
            ])
        return wire.T_SNAPSHOT_R, {"decisions": entries}

    def h_sync(payload):
        applied = 0
        for ip, dec_name, expires, domain in payload.get("decisions", []):
            dynamic_lists.update(
                ip, float(expires), Decision[dec_name], True, domain
            )
            applied += 1
        return wire.T_ACK, {"applied": applied}

    def h_flush(payload):
        t = float(payload.get("timeout", 120))
        router = state["router"]
        routed = router.flush(t) if router is not None else True
        ok = sched.flush(t)
        return wire.T_ACK, {"flushed": bool(ok and routed)}

    def h_ping(payload):
        return wire.T_PONG, {"node_id": node_id}

    def h_shutdown(payload):
        shutdown.set()
        return wire.T_ACK, {}

    node = FabricNode(
        "127.0.0.1", args.listen_port,
        handlers={
            wire.T_HELLO: h_hello,
            wire.T_LINES: h_lines,
            wire.T_LINES_V2: h_lines_v2,
            wire.T_PEER_DOWN: h_peer_down,
            wire.T_PEER_UP: h_peer_up,
            wire.T_GOSSIP_PING: h_gossip_ping,
            wire.T_GOSSIP_PING_REQ: h_gossip_ping_req,
            wire.T_JOIN: h_join,
            wire.T_LEAVE: h_leave,
            wire.T_FAILPOINT: h_failpoint,
            wire.T_STATS: h_stats,
            wire.T_EXPLAIN: h_explain,
            wire.T_FLIGHTREC: h_flightrec,
            wire.T_SNAPSHOT: h_snapshot,
            wire.T_SYNC: h_sync,
            wire.T_FLUSH: h_flush,
            wire.T_PING: h_ping,
            wire.T_SHUTDOWN: h_shutdown,
        },
    ).start()

    if args.join:
        # ---- automatic join: announce -> snapshot sync -> gossip ----
        jhost, _, jport = args.join.rpartition(":")
        jhost = jhost or "127.0.0.1"

        def _rpc(ftype, payload, timeout=10.0):
            with _socket.create_connection(
                (jhost, int(jport)), timeout=timeout
            ) as sock:
                sock.settimeout(timeout)
                wire.send_frame(sock, ftype, payload)
                return wire.recv_frame(sock)

        try:
            rtype, joined = _rpc(wire.T_JOIN, {
                "node_id": node_id, "host": "127.0.0.1", "port": node.port,
            })
            if rtype != wire.T_JOIN_R:
                raise OSError(f"join refused: {joined}")
            members = joined.get("members", [])
            ring_ids = sorted(
                str(row[0]) for row in members
                if row[1] in (swim.ALIVE, swim.SUSPECT)
            )
            clients = {
                str(row[0]): (
                    None if str(row[0]) == node_id
                    else _make_client(str(row[0]), row[3], row[4])
                )
                for row in members if str(row[0]) in ring_ids
            }
            router = FabricRouter(
                node_id,
                ConsistentHashRing(ring_ids, vnodes=args.vnodes),
                clients, _local_submit, stats=fstats, health=health,
                takeover_grace_ms=args.grace_ms,
                pipe_factory=_pipe_factory_from({}),
                trace_propagation=bool(args.trace_propagation),
            )
            state["router"] = router
            ms = _start_membership(
                router, None,
                args.gossip_interval_ms or 250.0,
                args.suspect_timeout_ms,
                args.indirect_probes,
                node.port,
            )
            ms.merge(members, via="join")
            # warm start: the fleet's decisions, idempotently applied
            rtype, snap = _rpc(wire.T_SNAPSHOT, {})
            synced = 0
            if rtype == wire.T_SNAPSHOT_R:
                for ip, dec_name, expires, domain in snap.get(
                    "decisions", []
                ):
                    dynamic_lists.update(
                        ip, float(expires), Decision[dec_name], True, domain
                    )
                    synced += 1
        except (OSError, ValueError, KeyError) as exc:
            print(json.dumps(
                {"ready": False, "error": f"join failed: {exc}"}
            ), flush=True)
            return 2
        print(json.dumps({
            "ready": True, "node_id": node_id, "port": node.port,
            "joined": True, "synced": synced,
            "members": len(members),
        }), flush=True)
    else:
        print(json.dumps(
            {"ready": True, "node_id": node_id, "port": node.port}
        ), flush=True)

    try:
        while not shutdown.wait(0.2):
            pass
    finally:
        ms = state["membership"]
        if ms is not None:
            ms.stop()
        router = state["router"]
        if router is not None:
            router.close()
        if reader is not None:
            reader.stop()
        sched.stop()
        parts.matcher.close()
        node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
