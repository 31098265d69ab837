"""Length-prefixed fabric socket frames.

(A copy of `banjax_tpu/fabric/wire.py`.)

One frame = 4-byte big-endian length, 1-byte type, then the body.  The
length covers the type byte + body, so a reader can pre-allocate and a
torn stream fails loudly (oversized or truncated frames raise instead
of desynchronizing).

Two body encodings share that header:

  * **JSON** (wire v1) — every control/gossip/membership frame, the
    T_ACK response, and the negotiated fallback for peers that predate
    the binary data path.  A synchronous request -> response exchange
    per frame; the ack accounting is exact because the server answers
    frames in order on one connection.
  * **binary v2** (`T_LINES_V2`) — the data-path hot frame.  Zero JSON
    on the hot path: a `u64` journal sequence, a `u8` flags byte
    (bit 0 = replay, bit 1 = origin section present), a `u32` line
    count, a `(count+1)`-entry `u32` offset table and the raw UTF-8
    line blob.  `decode_lines_v2` validates the offset table strictly
    (monotone, zero-based, last entry == blob length) so a corrupt
    frame raises `FrameError` instead of delivering garbled lines.

    With bit 1 set an **origin section** follows the blob: the sender's
    node id, the tailer-read monotonic timestamp of the oldest line in
    the frame, and a run table of `(trace_id u64, count u32)` pairs
    mapping contiguous line runs back to the admission trace that
    routed them on the origin shard (obs/fleet.py joins a ban on the
    owner back to that trace).  The run counts must sum exactly to the
    line count — a frame that lies about its runs fails decode loudly,
    like every other v2 invariant.

`T_VERSION` is the connect-time handshake: a v2 sender probes with
`{"wire": 2}`; a v2 node answers `T_VERSION_R` with its wire version,
whether it accepts shm-ring attaches, and whether it understands the
origin section (`"trace": true` — senders only set bit 1 against a
peer that advertised it), while an old node answers T_ERR ("unhandled
frame type") — the sender then negotiates down to per-frame JSON
losslessly.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

MAX_FRAME_BYTES = 32 << 20  # one scenario chunk is ~32 KiB; 32 MiB is sabotage
MAX_V2_LINES = 1 << 22      # offset-table sanity bound, far above any frame

WIRE_VERSION = 2

_HEADER = struct.Struct("!IB")
_V2_FIXED = struct.Struct("!QBI")  # seq u64, flags u8, count u32
_V2_REPLAY = 0x01
_V2_TRACE = 0x02   # origin section follows the line blob
# origin section: node_len u16, t_read f64 (monotonic s), run_count u32
_V2_ORIGIN_FIXED = struct.Struct("!HdI")
_V2_RUN = struct.Struct("!QI")     # origin trace_id u64, line count u32
MAX_V2_NODE_LEN = 256

# frame types — request/response pairs share a row
T_HELLO = 1        # -> T_HELLO_R     feeder/peer handshake, topology push
T_HELLO_R = 2
T_LINES = 3        # -> T_ACK         log lines to route/process
T_ACK = 4
T_STATS = 5        # -> T_STATS_R     scheduler + fabric counters + ban log
T_STATS_R = 6
T_PING = 7         # -> T_PONG        liveness probe
T_PONG = 8
T_SNAPSHOT = 9     # -> T_SNAPSHOT_R  dump expiring decisions (rejoin source)
T_SNAPSHOT_R = 10
T_SYNC = 11        # -> T_ACK         apply a decision snapshot idempotently
T_PEER_DOWN = 12   # -> T_ACK         membership change: mark peer dead
T_PEER_UP = 13     # -> T_ACK         membership change: peer rejoined
T_FLUSH = 14       # -> T_ACK         drain the pipeline to quiescence
T_SHUTDOWN = 15    # -> T_ACK         clean exit
T_ERR = 16         # any request may answer this; payload has "error"
T_GOSSIP_PING = 17     # -> T_GOSSIP_ACK   SWIM direct probe, digest rides
T_GOSSIP_ACK = 18
T_GOSSIP_PING_REQ = 19  # -> T_GOSSIP_ACK  SWIM indirect probe via a relay
T_JOIN = 20        # -> T_JOIN_R      announce + membership/snapshot pull
T_JOIN_R = 21
T_LEAVE = 22       # -> T_ACK         admin: graceful drain, then depart
T_FAILPOINT = 23   # -> T_ACK         admin: arm/disarm a failpoint
T_LINES_V2 = 24    # -> T_ACK         binary batched line frame (wire v2)
T_VERSION = 26     # -> T_VERSION_R   wire-version handshake at connect
T_VERSION_R = 27
T_RING_ATTACH = 28  # -> T_ACK        co-located peer: switch to shm rings
T_FLIGHTREC = 29   # -> T_FLIGHTREC_R fleet incident capture: obs snapshot
T_FLIGHTREC_R = 30
T_EXPLAIN = 31     # -> T_EXPLAIN_R   cross-shard /decisions/explain proxy
T_EXPLAIN_R = 32


class FrameError(OSError):
    """Malformed or oversized frame — the connection is unusable."""


class ShmRingError(RuntimeError):
    """A shm ring (native/shmring.py) whose library could not be built or
    loaded, or whose segment could not be created or mapped, or that the
    peer declined. Not an OSError: a peer link's retry path must not
    mistake it for a dead peer."""


class ConnectionClosed(FrameError):
    """The peer closed the connection between two frames: the end of an
    exchange, not a malformed frame (the JAX reader reports it as one)."""


@dataclasses.dataclass(frozen=True)
class LinesV2:
    """A decoded T_LINES_V2 frame: the journal seq the ack must echo,
    the replay flag, the batched lines, and — when the sender set the
    trace bit — the origin section (which shard tailed these lines,
    when its tailer read them, and which admission trace routed each
    contiguous run)."""

    seq: int
    replay: bool
    lines: Tuple[str, ...]
    origin_node: str = ""
    origin_t_read: float = 0.0
    origin_runs: Tuple[Tuple[int, int], ...] = ()


def encode_lines_v2(
    seq: int,
    lines: Sequence[str],
    replay: bool = False,
    origin_node: str = "",
    origin_t_read: float = 0.0,
    origin_runs: Optional[Sequence[Tuple[int, int]]] = None,
) -> bytes:
    """One complete T_LINES_V2 frame (header included), ready for
    sendall/ring-write.  Many routed groups coalesce into one call —
    the encoder only sees the flattened line list (plus, with
    `origin_node`, the per-run trace table covering it)."""
    blobs = [ln.encode("utf-8") for ln in lines]
    offsets: List[int] = [0]
    for b in blobs:
        offsets.append(offsets[-1] + len(b))
    flags = _V2_REPLAY if replay else 0
    parts = [
        _V2_FIXED.pack(seq, flags, len(blobs)),
        struct.pack(f"!{len(offsets)}I", *offsets),
        b"".join(blobs),
    ]
    if origin_node:
        node_b = origin_node.encode("utf-8")
        if len(node_b) > MAX_V2_NODE_LEN:
            raise FrameError(f"origin node id too long: {len(node_b)} bytes")
        runs = list(origin_runs) if origin_runs else [(0, len(blobs))]
        if sum(c for _t, c in runs) != len(blobs):
            raise FrameError(
                "origin run counts do not cover the line count"
            )
        parts[0] = _V2_FIXED.pack(seq, flags | _V2_TRACE, len(blobs))
        parts.append(_V2_ORIGIN_FIXED.pack(
            len(node_b), float(origin_t_read), len(runs)
        ))
        parts.append(node_b)
        parts.extend(_V2_RUN.pack(int(t), int(c)) for t, c in runs)
    body = b"".join(parts)
    if 1 + len(body) > MAX_FRAME_BYTES:
        raise FrameError(f"frame too large: {len(body)} bytes")
    return _HEADER.pack(1 + len(body), T_LINES_V2) + body


def _decode_origin(
    body: bytes, start: int, count: int
) -> Tuple[str, float, Tuple[Tuple[int, int], ...]]:
    """Strict origin-section decode (trace bit set): exact length, node
    UTF-8, run counts summing to the frame's line count."""
    if len(body) < start + _V2_ORIGIN_FIXED.size:
        raise FrameError("v2 origin section truncated")
    node_len, t_read, run_count = _V2_ORIGIN_FIXED.unpack_from(body, start)
    if node_len > MAX_V2_NODE_LEN:
        raise FrameError(f"v2 origin node length {node_len} oversized")
    if run_count > max(1, count):
        raise FrameError(
            f"v2 origin run count {run_count} exceeds line count {count}"
        )
    pos = start + _V2_ORIGIN_FIXED.size
    end = pos + node_len + run_count * _V2_RUN.size
    if len(body) != end:
        raise FrameError(
            f"v2 origin section length mismatch: need {end - start}, "
            f"have {len(body) - start}"
        )
    try:
        node = body[pos:pos + node_len].decode("utf-8")
    except UnicodeDecodeError as exc:
        raise FrameError(f"v2 origin node not UTF-8: {exc}") from exc
    pos += node_len
    runs = tuple(
        _V2_RUN.unpack_from(body, pos + i * _V2_RUN.size)
        for i in range(run_count)
    )
    if sum(c for _t, c in runs) != count:
        raise FrameError(
            "v2 origin run counts do not cover the line count"
        )
    return node, t_read, runs


def decode_lines_v2(body: bytes) -> LinesV2:
    """Strict decode — any torn/truncated/inconsistent frame raises
    FrameError (the fuzz suite in tests/unit/test_fabric_wire_v2.py
    drives every branch here)."""
    if len(body) < _V2_FIXED.size:
        raise FrameError(f"v2 frame truncated: {len(body)} byte body")
    seq, flags, count = _V2_FIXED.unpack_from(body, 0)
    if count > MAX_V2_LINES:
        raise FrameError(f"v2 frame count {count} exceeds {MAX_V2_LINES}")
    table_end = _V2_FIXED.size + 4 * (count + 1)
    if len(body) < table_end:
        raise FrameError(
            f"v2 offset table truncated: need {table_end}, have {len(body)}"
        )
    offsets = struct.unpack_from(f"!{count + 1}I", body, _V2_FIXED.size)
    if offsets[0] != 0:
        raise FrameError(f"v2 offset table must start at 0, got {offsets[0]}")
    origin_node, origin_t_read = "", 0.0
    origin_runs: Tuple[Tuple[int, int], ...] = ()
    if flags & _V2_TRACE:
        blob = body[table_end:table_end + offsets[-1]]
        if len(blob) != offsets[-1]:
            raise FrameError(
                f"v2 blob truncated: table says {offsets[-1]}, "
                f"have {len(blob)} bytes"
            )
        origin_node, origin_t_read, origin_runs = _decode_origin(
            body, table_end + offsets[-1], count
        )
    else:
        blob = body[table_end:]
        if offsets[-1] != len(blob):
            raise FrameError(
                f"v2 blob length mismatch: table says {offsets[-1]}, "
                f"blob is {len(blob)} bytes"
            )
    prev = 0
    for off in offsets:
        if off < prev:
            raise FrameError("v2 offset table not monotone")
        prev = off
    try:
        lines = tuple(
            blob[offsets[i]:offsets[i + 1]].decode("utf-8")
            for i in range(count)
        )
    except UnicodeDecodeError as exc:
        raise FrameError(f"v2 line blob not UTF-8: {exc}") from exc
    return LinesV2(
        seq=seq, replay=bool(flags & _V2_REPLAY), lines=lines,
        origin_node=origin_node, origin_t_read=origin_t_read,
        origin_runs=origin_runs,
    )


def encode_frame(ftype: int, payload: Dict[str, Any]) -> bytes:
    """One complete JSON frame (header included) — the send_frame body
    without the socket, for transports that write bytes (shm rings)."""
    body = json.dumps(payload, separators=(",", ":")).encode("utf-8")
    if 1 + len(body) > MAX_FRAME_BYTES:
        raise FrameError(f"frame too large: {len(body)} bytes")
    return _HEADER.pack(1 + len(body), ftype) + body


def decode_body(ftype: int, body: bytes) -> Union[Dict[str, Any], LinesV2]:
    """Decode a frame body by type: LinesV2 for the binary data frame,
    a JSON object for everything else."""
    if ftype == T_LINES_V2:
        return decode_lines_v2(body)
    try:
        payload = json.loads(body.decode("utf-8")) if body else {}
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise FrameError(f"undecodable frame payload: {exc}") from exc
    if not isinstance(payload, dict):
        raise FrameError("frame payload must be a JSON object")
    return payload


def send_frame(sock: socket.socket, ftype: int, payload: Dict[str, Any]) -> None:
    sock.sendall(encode_frame(ftype, payload))


def recv_frame(sock: socket.socket) -> Tuple[int, Dict[str, Any]]:
    """Receive one JSON frame.  A binary T_LINES_V2 arriving here is a
    protocol violation (the caller negotiated v1) — FrameError."""
    ftype, payload = recv_frame_any(sock)
    if not isinstance(payload, dict):
        raise FrameError(f"unexpected binary frame type {ftype}")
    return ftype, payload


def recv_frame_any(
    sock: socket.socket,
) -> Tuple[int, Union[Dict[str, Any], LinesV2]]:
    """Receive one frame of either encoding (a v2-aware server's read
    loop)."""
    header = _recv_exact(sock, _HEADER.size)
    length, ftype = _HEADER.unpack(header)
    if length < 1 or length > MAX_FRAME_BYTES:
        raise FrameError(f"bad frame length {length}")
    body = _recv_exact(sock, length - 1, committed=True)
    return ftype, decode_body(ftype, body)


def _recv_exact(
    sock: socket.socket, n: int, committed: bool = False
) -> bytes:
    chunks = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(n - got)
        except socket.timeout:
            if got or committed:
                # a stall mid-frame would desynchronize the stream if
                # surfaced as an idle timeout — fail the connection
                raise FrameError(
                    f"timeout mid-frame ({got}/{n} bytes)"
                ) from None
            raise
        if not chunk:
            if not got and not committed:
                raise ConnectionClosed("connection closed between frames")
            raise FrameError(f"connection closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)
