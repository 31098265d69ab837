"""Server side of a fabric shard: accepts peer and feeder connections and
dispatches frames to registered handlers.

(A copy of `banjax_tpu/fabric/node.py`.)

Thread-per-connection (peer counts are single digits), one synchronous
response per request — which is also what makes the client's pipelined
window work with FIFO ack matching: frames on one channel are answered
in order.  The frame-read path accepts both encodings
(`wire.recv_frame_any`): JSON control frames and the binary
`T_LINES_V2` data frame, whose decoded `wire.LinesV2` is passed to the
handler in place of a payload dict.  Two frame types are answered by
the node itself:

  * `T_VERSION` — the wire handshake: answers the node's wire version
    and whether it accepts shm-ring attaches.
  * `T_RING_ATTACH` — a co-located peer created a pair of SPSC shm
    rings (native/shmring.py); the node attaches and serves frames
    from the ring on a dedicated thread, same dispatch table, no TCP
    in the data path.  An attach that fails is answered T_ERR, and the
    port's sender raises on it (the JAX sender stays on TCP).

The frame-read path passes the `fabric.recv` failpoint; an injected
fault drops the connection exactly like a torn network would, so the
client exercises its reconnect backoff.  A malformed frame
(FrameError: torn, oversized, corrupt offset table) is logged loudly
and drops the connection — the client reconnects and retransmits its
unacked window.  Handler exceptions answer T_ERR and keep the
connection — an application error must not masquerade as a dead shard.
"""

from __future__ import annotations

import logging
import socket
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from banjax_tpu_torch.fabric import wire
from banjax_tpu_torch.resilience import failpoints

log = logging.getLogger(__name__)

Handler = Callable[[Dict[str, Any]], Tuple[int, Dict[str, Any]]]


class FabricNode:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        handlers: Optional[Dict[int, Handler]] = None,
        allow_rings: bool = True,
    ):
        self.handlers: Dict[int, Handler] = dict(handlers or {})
        self.allow_rings = bool(allow_rings)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._conn_threads: list = []
        self._rings: list = []  # (ring_in, ring_out, thread)
        self._rings_lock = threading.Lock()

    def on(self, ftype: int, handler: Handler) -> None:
        self.handlers[ftype] = handler

    def start(self) -> "FabricNode":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fabric-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        try:
            self._sock.settimeout(0.25)
        except OSError:
            return  # stop() closed the socket before the thread ran
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="fabric-conn", daemon=True,
            )
            t.start()
            self._conn_threads.append(t)

    def _dispatch(self, ftype: int, payload) -> Tuple[int, Dict[str, Any]]:
        """Shared by the TCP and ring read loops.  `payload` is a dict
        for JSON frames, a wire.LinesV2 for the binary data frame."""
        if ftype == wire.T_VERSION:
            return wire.T_VERSION_R, {
                "wire": wire.WIRE_VERSION, "ring": self.allow_rings,
                # origin-section support (wire._V2_TRACE): senders only
                # set the trace bit against a peer that advertised it
                "trace": True,
            }
        handler = self.handlers.get(ftype)
        if handler is None:
            return wire.T_ERR, {"error": f"unhandled frame type {ftype}"}
        try:
            return handler(payload)
        except Exception as exc:  # answer, don't die
            return wire.T_ERR, {"error": repr(exc)}

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.settimeout(0.5)
        try:
            while not self._stop.is_set():
                try:
                    ftype, payload = wire.recv_frame_any(conn)
                except socket.timeout:
                    continue
                except wire.ConnectionClosed:
                    return  # the sender's exchange is over (a gossip probe)
                except wire.FrameError as exc:
                    # corrupt/torn frame: loud error, drop the
                    # connection — the sender reconnects on the shared
                    # backoff and retransmits its unacked window
                    log.error("fabric node %s:%s: dropping connection on "
                              "malformed frame: %s", self.host, self.port, exc)
                    return
                except OSError:
                    return
                try:
                    failpoints.check("fabric.recv")
                except failpoints.FaultInjected:
                    return  # injected torn network: drop the connection
                if ftype == wire.T_RING_ATTACH:
                    rtype, rpayload = self._ring_attach(payload)
                else:
                    rtype, rpayload = self._dispatch(ftype, payload)
                try:
                    wire.send_frame(conn, rtype, rpayload)
                except OSError:
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # ---- shm ring serving ----

    def _ring_attach(self, payload: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        if not self.allow_rings:
            return wire.T_ERR, {"error": "shm rings disabled on this node"}
        try:
            from banjax_tpu_torch.native import shmring

            # the client's c2s ring is OUR inbound side
            ring_in = shmring.ShmRing(name=payload["c2s"])
            ring_out = shmring.ShmRing(name=payload["s2c"])
        except Exception as exc:  # noqa: BLE001 — answered; the sender raises on it
            return wire.T_ERR, {"error": f"ring attach failed: {exc!r}"}
        t = threading.Thread(
            target=self._serve_ring, args=(ring_in, ring_out),
            name="fabric-ring", daemon=True,
        )
        with self._rings_lock:
            self._rings.append((ring_in, ring_out, t))
        t.start()
        return wire.T_ACK, {"attached": True}

    def _serve_ring(self, ring_in, ring_out) -> None:
        from banjax_tpu_torch.native import shmring

        try:
            while not self._stop.is_set():
                try:
                    fr = shmring.read_frame(ring_in, idle_timeout_s=0.25)
                except wire.FrameError as exc:
                    log.error("fabric node %s:%s: shm ring torn: %s",
                              self.host, self.port, exc)
                    return
                if fr is None:
                    continue
                ftype, body = fr
                try:
                    payload = wire.decode_body(ftype, body)
                except wire.FrameError as exc:
                    log.error("fabric node %s:%s: malformed ring frame: %s",
                              self.host, self.port, exc)
                    return
                rtype, rpayload = self._dispatch(ftype, payload)
                try:
                    ring_out.write(
                        wire.encode_frame(rtype, rpayload), 2.0
                    )
                except OSError as exc:
                    log.error("fabric node %s:%s: ring ack write failed: %s",
                              self.host, self.port, exc)
                    return
        finally:
            try:
                ring_in.close()
                ring_out.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        with self._rings_lock:
            rings = list(self._rings)
            self._rings.clear()
        for ring_in, ring_out, t in rings:
            t.join(timeout=2.0)
