"""Client side of a fabric peer link.

(A copy of `banjax_tpu/fabric/peer.py`.)

Two senders share this module:

  * `PeerClient` — the control path: one persistent connection,
    request/response serialized under a lock.  Gossip, membership,
    stats, admin frames.
  * `LinePipe` — the data path (wire v2): a windowed, pipelined frame
    sender.  `submit()` enqueues a routed group and returns
    immediately; a dedicated I/O thread coalesces pending groups into
    binary `T_LINES_V2` frames (up to `fabric_frame_max_bytes`), keeps
    up to `fabric_inflight_frames` frames outstanding, and retires
    them as seq-tagged acks stream back — the router returns to
    matching while forwards are in flight.  The unacked window is the
    retransmit buffer: on reconnect every unacked frame is re-sent in
    seq order (the full journal replay on takeover stays the router's,
    unchanged).  At connect the pipe handshakes the wire version
    (`T_VERSION`) and negotiates down to per-frame JSON `T_LINES`
    against an old peer, losslessly; against a co-located v2 peer with
    `fabric_shm_enabled` it attaches a pair of SPSC shm rings
    (native/shmring.py) and moves frames with zero TCP in the loop.
    Where the JAX pipe stays on TCP when the rings cannot be built or
    the peer declines them, the port's pipe stops with a
    `ShmRingError`, which every later `submit()` and `flush()` raise
    (not a PeerUnavailable: the peer is not dead, the transport is
    misconfigured).

Every send attempt passes the `fabric.send` failpoint (plus
`fabric.frame.corrupt` / `fabric.ring.stall` on the pipe), carries a
per-send socket timeout (`fabric_send_timeout_ms`), and on failure the
connection is torn down and retried on the shared reconnect backoff
(resilience/backoff.py — the same policy as the kafka and tailer
loops).  A per-peer circuit breaker turns repeated failures into a fast
PeerUnavailable so the router can start a takeover instead of timing
out on every chunk for a dead shard.
"""

from __future__ import annotations

import collections
import logging
import os
import select
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from banjax_tpu_torch.fabric import wire
from banjax_tpu_torch.fabric.wire import ShmRingError
from banjax_tpu_torch.resilience import failpoints
from banjax_tpu_torch.resilience.backoff import Backoff, reconnect_backoff
from banjax_tpu_torch.resilience.breaker import CircuitBreaker

log = logging.getLogger(__name__)


class PeerUnavailable(OSError):
    """The peer did not answer within the retry budget (or its breaker
    is open) — the caller should treat the shard as dead."""


class PeerClient:
    def __init__(
        self,
        peer_id: str,
        host: str,
        port: int,
        send_timeout_ms: float = 2000.0,
        max_attempts: int = 3,
        backoff: Optional[Backoff] = None,
        breaker: Optional[CircuitBreaker] = None,
        stop: Optional[threading.Event] = None,
    ):
        self.peer_id = peer_id
        self.host = host
        self.port = int(port)
        self.send_timeout_s = float(send_timeout_ms) / 1000.0
        self.max_attempts = int(max_attempts)
        # short cap: a fabric peer link recovers or fails over in
        # hundreds of ms, not the 30 s a kafka broker is allowed
        self.backoff = backoff or reconnect_backoff(cap=1.0, base=0.05)
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=max(2, max_attempts),
            recovery_seconds=2.0,
            name=f"fabric.peer.{peer_id}",
        )
        self._stop = stop or threading.Event()
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None

    def connect_to(self, host: str, port: int) -> None:
        """Re-point at a rejoined peer's new address."""
        with self._lock:
            self._close_locked()
            self.host = host
            self.port = int(port)

    def request(
        self, ftype: int, payload: Dict[str, Any]
    ) -> Tuple[int, Dict[str, Any]]:
        """Send one frame, wait for its response.  Raises
        PeerUnavailable after `max_attempts` failed tries (reconnecting
        on the shared backoff between tries)."""
        if not self.breaker.allow():
            raise PeerUnavailable(
                f"peer {self.peer_id}: breaker {self.breaker.state}"
            )
        last_err: Optional[BaseException] = None
        with self._lock:
            for attempt in range(self.max_attempts):
                if attempt and self.backoff.wait(self._stop):
                    break
                try:
                    failpoints.check("fabric.send")
                    sock = self._ensure_sock_locked()
                    wire.send_frame(sock, ftype, payload)
                    rtype, rpayload = wire.recv_frame(sock)
                except (OSError, socket.timeout) as exc:
                    last_err = exc
                    self._close_locked()
                    self.breaker.record_failure()
                    continue
                if rtype == wire.T_ERR:
                    # the peer is alive and answering: an application
                    # error is not a connectivity failure
                    self.breaker.record_success()
                    self.backoff.reset()
                    raise OSError(
                        f"peer {self.peer_id} error: "
                        f"{rpayload.get('error', '?')}"
                    )
                self.breaker.record_success()
                self.backoff.reset()
                return rtype, rpayload
        raise PeerUnavailable(
            f"peer {self.peer_id} unavailable after "
            f"{self.max_attempts} attempts: {last_err}"
        )

    def _ensure_sock_locked(self) -> socket.socket:
        if self._sock is None:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.send_timeout_s
            )
            sock.settimeout(self.send_timeout_s)
            self._sock = sock
        return self._sock

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()


def _corrupt_frame(frame: bytes) -> bytes:
    """The `fabric.frame.corrupt` fault: flip one body byte where both
    encodings are guaranteed to fail decode loudly (the v2 count field
    / a JSON structural byte), never to deliver silently garbled
    lines."""
    idx = min(wire._HEADER.size + 9, len(frame) - 1)
    return frame[:idx] + bytes([frame[idx] ^ 0xFF]) + frame[idx + 1:]


class _InflightFrame:
    __slots__ = ("seq", "groups", "replay", "n_lines", "sent_at", "t_read")

    def __init__(self, seq, groups, replay, n_lines, sent_at, t_read=None):
        self.seq = seq
        self.groups = groups   # coalesced (lines, origin trace id) groups
        self.replay = replay
        self.n_lines = n_lines
        self.sent_at = sent_at
        self.t_read = t_read   # oldest tailer-read stamp in the frame


class LinePipe:
    """Windowed pipelined data-path sender to one peer (module
    docstring has the architecture).  Thread-safe producer API:
    `submit()` / `flush()` / `close()`; one internal I/O thread owns
    the connection, the version handshake, coalescing, the sliding
    window and retransmits."""

    def __init__(
        self,
        peer_id: str,
        host: str,
        port: int,
        node_id: str = "",
        send_timeout_ms: float = 2000.0,
        max_attempts: int = 3,
        inflight_frames: int = 8,
        frame_max_bytes: int = 1 << 20,
        wire_v2: bool = True,
        shm: bool = False,
        shm_ring_bytes: int = 1 << 20,
        pending_chunks: int = 256,
        backoff: Optional[Backoff] = None,
        breaker: Optional[CircuitBreaker] = None,
        stop: Optional[threading.Event] = None,
        stats=None,
        on_ack: Optional[Callable[[Dict[str, Any]], None]] = None,
        trace_propagation: bool = False,
    ):
        self.peer_id = peer_id
        self.host = host
        self.port = int(port)
        self.node_id = node_id
        self.send_timeout_s = float(send_timeout_ms) / 1000.0
        self.max_attempts = int(max_attempts)
        self.inflight_frames = max(1, int(inflight_frames))
        self.frame_max_bytes = int(frame_max_bytes)
        self.wire_v2 = bool(wire_v2)
        self.shm = bool(shm)
        self.shm_ring_bytes = int(shm_ring_bytes)
        self.pending_chunks = int(pending_chunks)
        self.backoff = backoff or reconnect_backoff(cap=1.0, base=0.05)
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=max(2, max_attempts),
            recovery_seconds=2.0,
            name=f"fabric.pipe.{peer_id}",
        )
        self._stop = stop or threading.Event()
        self.stats = stats
        self.on_ack = on_ack
        # cross-host trace propagation (obs/fleet.py): forwarded frames
        # carry (origin node, origin trace id, tailer-read stamp) when
        # on AND the peer advertised origin-section support at handshake
        self.trace_propagation = bool(trace_propagation)
        self._peer_trace = False
        # negotiated per connection; read for introspection/metrics
        self.mode = "v2" if self.wire_v2 else "json"
        self.transport = "tcp"

        self._cv = threading.Condition()
        self._pending: collections.deque = collections.deque()
        self._inflight: "collections.OrderedDict[int, _InflightFrame]" = (
            collections.OrderedDict()
        )
        self._next_seq = 1
        self._dead = False
        # frames (and their lines) sent again on a new channel after a
        # failure or a late ack; a live owner may drain them twice
        self.resent_frames = 0
        self.resent_lines = 0
        self._dead_reason = ""
        # a ShmRingError that stopped the pipe, raised to its producers
        self._fatal: Optional[BaseException] = None
        self._sock: Optional[socket.socket] = None
        self._ring_out = None  # ShmRing, us -> peer
        self._ring_in = None   # ShmRing, peer -> us
        self._wake_r, self._wake_w = os.pipe()
        self._thread = threading.Thread(
            target=self._io_loop, name=f"fabric-pipe-{peer_id}", daemon=True
        )
        self._thread.start()

    # ---- producer API ----

    def submit(self, lines, replay: bool = False, trace_id: int = 0,
               t_read: Optional[float] = None) -> None:
        """Enqueue one routed group.  Returns as soon as the group is
        in the outbox (backpressure-bounded); raises PeerUnavailable
        when the link is dead or its breaker is open — the router then
        starts the takeover, exactly like a failed synchronous send.

        `trace_id`/`t_read` ride the frame's origin section when trace
        propagation is negotiated; both are free to ignore otherwise."""
        if not self.breaker.allow():
            raise PeerUnavailable(
                f"peer {self.peer_id}: breaker {self.breaker.state}"
            )
        with self._cv:
            while (
                not self._dead
                and len(self._pending) >= self.pending_chunks
                and not self._stop.is_set()
            ):
                self._cv.wait(0.05)
            if self._fatal is not None:
                raise self._fatal
            if self._dead:
                raise PeerUnavailable(
                    f"peer {self.peer_id} pipe dead: {self._dead_reason}"
                )
            self._pending.append(
                (tuple(lines), bool(replay), int(trace_id), t_read)
            )
            was_empty = len(self._pending) == 1
        # wake the I/O thread only on the empty->nonempty transition:
        # in every other sleeping state it is already ack-driven (a
        # full window drains via the socket/ring becoming readable),
        # and the flush/backpressure waiters poll on short timeouts —
        # per-submit syscalls would cap the line rate
        if was_empty:
            self._wake()

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until every submitted group is sent AND acked (or the
        pipe dies / the timeout passes).  True iff fully drained."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._pending or self._inflight:
                if self._fatal is not None:
                    raise self._fatal
                if self._dead:
                    return False
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.05))
        return True

    def inflight(self) -> int:
        with self._cv:
            return len(self._inflight)

    @property
    def dead(self) -> bool:
        return self._dead

    def connect_to(self, host: str, port: int) -> None:
        """Re-point at a rejoined peer's new address (forces a
        reconnect + retransmit of the unacked window)."""
        with self._cv:
            self.host = host
            self.port = int(port)
        self._teardown_channel()
        self._wake()

    def close(self) -> None:
        with self._cv:
            self._dead = True
            self._dead_reason = self._dead_reason or "closed"
            self._cv.notify_all()
        self._wake()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=2.0)
        self._teardown_channel()
        try:
            os.close(self._wake_r)
            os.close(self._wake_w)
        except OSError:
            pass

    # ---- I/O thread ----

    def _wake(self) -> None:
        try:
            os.write(self._wake_w, b"x")
        except OSError:
            pass

    def _drain_wake(self) -> None:
        try:
            while True:
                r, _, _ = select.select([self._wake_r], [], [], 0)
                if not r:
                    return
                os.read(self._wake_r, 4096)
        except OSError:
            return

    def _io_loop(self) -> None:
        # consecutive channel failures since the last ACK (a connect
        # alone is not liveness: a wedged peer still accepts TCP)
        self._attempts = 0
        try:
            while not self._dead and not self._stop.is_set():
                try:
                    if self._sock is None:
                        if self._attempts and self.backoff.wait(self._stop):
                            break
                        self._attempts += 1
                        self._connect()
                    self._pump()
                except ShmRingError as exc:
                    with self._cv:
                        self._fatal = exc
                    log.error("fabric pipe %s: %s", self.peer_id, exc)
                    self._die(f"shm ring: {exc}")
                    return
                except (OSError, socket.timeout) as exc:
                    self._teardown_channel()
                    self.breaker.record_failure()
                    if self._attempts >= self.max_attempts:
                        self._die(f"{self._attempts} attempts: {exc}")
                        return
        except Exception as exc:  # noqa: BLE001 — a pipe bug must not hang submit()
            log.exception("fabric pipe %s: unexpected error", self.peer_id)
            self._die(f"internal error: {exc!r}")
        finally:
            if self._dead:
                self._teardown_channel()

    def _die(self, reason: str) -> None:
        with self._cv:
            self._dead = True
            self._dead_reason = reason
            self._cv.notify_all()
        if self.stats is not None:
            self.stats.note_inflight(self.peer_id, 0)
        log.warning("fabric pipe %s dead: %s", self.peer_id, reason)

    def _connect(self) -> None:
        """Dial, handshake the wire version, optionally attach shm
        rings, then retransmit the unacked window in seq order."""
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.send_timeout_s
        )
        sock.settimeout(self.send_timeout_s)
        mode, server_ring = "json", False
        self._peer_trace = False
        if self.wire_v2:
            wire.send_frame(sock, wire.T_VERSION, {
                "wire": wire.WIRE_VERSION, "node": self.node_id,
            })
            rtype, rpayload = wire.recv_frame(sock)
            if (
                rtype == wire.T_VERSION_R
                and int(rpayload.get("wire", 1)) >= 2
            ):
                mode = "v2"
                server_ring = bool(rpayload.get("ring"))
                self._peer_trace = bool(rpayload.get("trace"))
            # T_ERR ("unhandled frame type") => a JSON-only peer:
            # negotiate down losslessly
        self._sock = sock
        self.mode = mode
        self.transport = "tcp"
        if self.shm and mode == "v2":
            if not server_ring:
                raise ShmRingError(
                    f"peer {self.peer_id} does not accept shm rings"
                )
            self._attach_rings(sock)
        # the unacked window rides the new channel first — the peer may
        # or may not have seen these frames (the ack is the only truth)
        with self._cv:
            replays = list(self._inflight.values())
        for fr in replays:
            self._transmit(fr, retransmit=True)
            self.resent_frames += 1
            self.resent_lines += fr.n_lines

    def _attach_rings(self, sock: socket.socket) -> None:
        from banjax_tpu_torch.native import shmring

        out = shmring.ShmRing(capacity=self.shm_ring_bytes)
        try:
            rin = shmring.ShmRing(capacity=self.shm_ring_bytes)
        except BaseException:
            out.close()
            raise
        try:
            wire.send_frame(sock, wire.T_RING_ATTACH, {
                "node": self.node_id,
                "c2s": out.name,
                "s2c": rin.name,
                "bytes": self.shm_ring_bytes,
            })
            rtype, _rp = wire.recv_frame(sock)
        except OSError:
            out.close()
            rin.close()
            raise
        if rtype != wire.T_ACK:
            out.close()
            rin.close()
            raise ShmRingError(
                f"peer {self.peer_id} declined the shm rings: "
                f"{_rp.get('error', '?')}"
            )
        self._ring_out = out
        self._ring_in = rin
        self.transport = "shm"

    def _teardown_channel(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        for ring_attr in ("_ring_out", "_ring_in"):
            ring = getattr(self, ring_attr)
            setattr(self, ring_attr, None)
            if ring is not None:
                try:
                    ring.close()
                except OSError:
                    pass

    # ---- the pump: acks first, then sends, then wait for either ----

    def _pump(self) -> None:
        while not self._dead and not self._stop.is_set():
            if self._sock is None:
                return
            progress = self._drain_acks()
            progress |= self._send_ready()
            if not progress:
                self._check_ack_deadline()
                self._wait_io()

    def _check_ack_deadline(self) -> None:
        """A connected-but-wedged peer never errors the socket: bound
        the wait for the window head's ack so the failure path
        (reconnect -> retransmit -> attempts budget -> dead) engages."""
        with self._cv:
            if not self._inflight:
                return
            head = next(iter(self._inflight.values()))
            waited = time.monotonic() - head.sent_at
        if waited > 2.0 * self.send_timeout_s:
            raise OSError(
                f"ack timeout: window head seq {head.seq} unacked "
                f"for {waited:.2f}s"
            )

    def _drain_acks(self) -> bool:
        got = False
        while self._ack_available():
            payload = self._recv_ack()
            self._handle_ack(payload)
            got = True
        return got

    def _ack_available(self) -> bool:
        with self._cv:
            if not self._inflight:
                return False
        if self.transport == "shm":
            return self._ring_in is not None and self._ring_in.readable() > 0
        r, _, _ = select.select([self._sock], [], [], 0)
        return bool(r)

    def _recv_ack(self) -> Dict[str, Any]:
        if self.transport == "shm":
            from banjax_tpu_torch.native import shmring

            fr = shmring.read_frame(self._ring_in, self.send_timeout_s)
            if fr is None:
                raise wire.FrameError("ring ack stalled")
            ftype, body = fr
            payload = wire.decode_body(ftype, body)
        else:
            ftype, payload = wire.recv_frame(self._sock)
        if ftype == wire.T_ERR or not isinstance(payload, dict):
            raise wire.FrameError(
                f"peer {self.peer_id} data-path error: "
                f"{payload.get('error', '?') if isinstance(payload, dict) else payload}"
            )
        return payload

    def _handle_ack(self, payload: Dict[str, Any]) -> None:
        with self._cv:
            if not self._inflight:
                raise wire.FrameError("ack with empty window")
            head_seq, fr = next(iter(self._inflight.items()))
            acked = payload.get("seq", head_seq)
            if acked != head_seq:
                raise wire.FrameError(
                    f"ack seq {acked} != window head {head_seq}"
                )
            self._inflight.popitem(last=False)
            n_inflight = len(self._inflight)
            self._cv.notify_all()
        self._attempts = 0  # an ack is the liveness proof
        if self.stats is not None:
            self.stats.note_ack(max(0.0, time.monotonic() - fr.sent_at))
            self.stats.note_inflight(self.peer_id, n_inflight)
        self.breaker.record_success()
        self.backoff.reset()
        if self.on_ack is not None:
            self.on_ack(payload)

    def _send_ready(self) -> bool:
        fr = self._coalesce()
        if fr is None:
            return False
        self._transmit(fr)
        return True

    def _coalesce(self) -> Optional[_InflightFrame]:
        """Pack pending routed groups (same replay flag) into one frame
        up to frame_max_bytes, claim a seq, and move it into the
        window.  None when the window is full or nothing is pending."""
        with self._cv:
            if self._dead or not self._pending:
                return None
            if len(self._inflight) >= self.inflight_frames:
                return None
            groups: List[tuple] = []
            replay = self._pending[0][1]
            size = 64
            n_lines = 0
            t_read: Optional[float] = None
            while self._pending and self._pending[0][1] == replay:
                lines, _rp, trace_id, grp_t_read = self._pending[0]
                est = sum(len(ln) + 4 for ln in lines)
                if groups and size + est > self.frame_max_bytes:
                    break
                self._pending.popleft()
                groups.append((lines, trace_id))
                size += est
                n_lines += len(lines)
                if grp_t_read is not None and (
                    t_read is None or grp_t_read < t_read
                ):
                    t_read = grp_t_read
            seq = self._next_seq
            self._next_seq += 1
            fr = _InflightFrame(seq, groups, replay, n_lines,
                                time.monotonic(), t_read=t_read)
            self._inflight[seq] = fr
            n_inflight = len(self._inflight)
            self._cv.notify_all()
        if self.stats is not None:
            self.stats.note_inflight(self.peer_id, n_inflight)
        return fr

    def _transmit(self, fr: _InflightFrame, retransmit: bool = False) -> None:
        failpoints.check("fabric.send")
        fr.sent_at = time.monotonic()
        flat: List[str] = []
        runs: List[tuple] = []  # contiguous (origin trace id, count) runs
        for g, trace_id in fr.groups:
            flat.extend(g)
            if runs and runs[-1][0] == trace_id:
                runs[-1] = (trace_id, runs[-1][1] + len(g))
            else:
                runs.append((trace_id, len(g)))
        propagate = self.trace_propagation and self.node_id
        if self.mode == "v2":
            if propagate and self._peer_trace:
                frame = wire.encode_lines_v2(
                    fr.seq, flat, replay=fr.replay,
                    origin_node=self.node_id,
                    origin_t_read=fr.t_read or 0.0,
                    origin_runs=runs,
                )
            else:
                frame = wire.encode_lines_v2(fr.seq, flat, replay=fr.replay)
        else:
            payload = {"lines": flat, "replay": fr.replay, "seq": fr.seq}
            if propagate:
                # the JSON fallback carries the same origin info as a
                # plain key — old receivers ignore unknown keys
                payload["origin"] = {
                    "node": self.node_id,
                    "runs": [[t, c] for t, c in runs],
                    "t_read": fr.t_read,
                }
            frame = wire.encode_frame(wire.T_LINES, payload)
        try:
            failpoints.check("fabric.frame.corrupt")
        except failpoints.FaultInjected:
            frame = _corrupt_frame(frame)
        if self.transport == "shm":
            failpoints.check("fabric.ring.stall")
            from banjax_tpu_torch.native import shmring

            try:
                self._ring_out.write(frame, self.send_timeout_s)
            except shmring.RingTimeout as exc:
                raise OSError(f"shm ring stalled: {exc}") from exc
            if self.stats is not None:
                self.stats.note_ring_occupancy(
                    self.peer_id, self._ring_out.occupancy()
                )
        else:
            self._sock.sendall(frame)
        if self.stats is not None:
            self.stats.note_frame_sent(self.mode, self.transport, len(frame))

    def _wait_io(self) -> None:
        """Idle: wait for an ack byte, a submit() wake, or a timeout
        slice (shm acks can't be select()ed, so ring mode polls)."""
        if self.transport == "shm":
            with self._cv:
                if self._pending and len(self._inflight) < self.inflight_frames:
                    return
            time.sleep(0.0005)
            return
        try:
            select.select([self._sock, self._wake_r], [], [], 0.05)
        except (OSError, ValueError):
            raise OSError("pipe socket vanished mid-select")
        self._drain_wake()
