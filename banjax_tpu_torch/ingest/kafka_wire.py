"""Minimal Kafka wire-protocol client (pure stdlib): the port's copy of
`banjax_tpu/ingest/kafka_wire.py`, with the same names and the same bytes
on the wire.

It speaks the Kafka binary protocol directly over sockets (TLS/mTLS per
config) as the real-broker transport behind `ingest/kafka_io.py`, and
covers the surface the reference uses kafka-go for (Go banjax:
internal/kafka.go:57-91 dialer and mTLS, :93-174 partition-pinned reader
at LastOffset, :353-406 report writer):

  * ApiVersions v0 to negotiate, then per API the newest version this
    module implements that the broker supports: the "legacy" ladder
    (Metadata v1 / ListOffsets v1 / Fetch v2 / Produce v2, message set v1)
    for old brokers, and the "modern" ladder (Metadata v7 / ListOffsets v4 /
    Fetch v10 / Produce v7, record batch v2 with crc32c and varints), which
    Kafka 4.x brokers require.
  * Metadata for leader discovery over the bootstrap broker list.
  * ListOffsets(latest) for the reference's LastOffset start position: a
    command appended before the reader connects is never read.
  * Fetch long-polling with min_bytes/max_wait from config; gzip, snappy
    (raw blocks and the xerial framing) and lz4 (frame format) batches are
    decompressed in pure stdlib; zstd batches are logged once per codec,
    counted (`skipped_batch_count`, this module's own state) and skipped.
  * Produce acks=1, round-robin over the report topic's partitions.

TLS mirrors the reference's getDialer: client cert and key (with its
password) and the CA root when configured, with hostname and chain
verification off like the reference's InsecureSkipVerify (kafka.go:80).
"""

from __future__ import annotations

import gzip
import logging
import socket
import ssl
import struct
import threading
import time
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from banjax_tpu_torch.config import Config

log = logging.getLogger(__name__)

_CLIENT_ID = "banjax-tpu"

# api keys
_PRODUCE, _FETCH, _LIST_OFFSETS, _METADATA = 0, 1, 2, 3
_API_VERSIONS = 18

# error codes we act on
_ERR_NONE = 0
_ERR_OFFSET_OUT_OF_RANGE = 1
_ERR_UNKNOWN_TOPIC = 3
_ERR_LEADER_NOT_AVAILABLE = 5
_ERR_NOT_LEADER = 6


class KafkaWireError(ConnectionError):
    """Any protocol/transport failure; callers reconnect with backoff."""


# ------------------------------------------------------------ codec skip counter

_skip_lock = threading.Lock()
_skipped_batches = 0
_skip_logged_codecs: set = set()
_CODEC_NAMES = {0: "none", 1: "gzip", 2: "snappy", 3: "lz4", 4: "zstd"}


def _skip_batch(codec: int, why: str = "unsupported compression codec") -> None:
    """Count a batch dropped for an undecodable codec; log once per codec
    (not once per batch — a misconfigured producer would flood the log)."""
    global _skipped_batches
    with _skip_lock:
        _skipped_batches += 1
        first = codec not in _skip_logged_codecs
        _skip_logged_codecs.add(codec)
    if first:
        log.warning(
            "KAFKA: %s %s; batches with this codec are skipped "
            "(KafkaSkippedBatches on the metrics line counts them)",
            why, _CODEC_NAMES.get(codec, f"#{codec}"),
        )


def skipped_batch_count() -> int:
    with _skip_lock:
        return _skipped_batches


def reset_skipped_batches() -> None:
    """Test hook: zero the counter and the per-codec log-once set."""
    global _skipped_batches
    with _skip_lock:
        _skipped_batches = 0
        _skip_logged_codecs.clear()


# ------------------------------------------------------------ snappy (codec 2)

_XERIAL_MAGIC = b"\x82SNAPPY\x00"


def snappy_decompress(data: bytes) -> bytes:
    """Pure-stdlib snappy decode: a raw block (what record-batch v2
    carries) or the xerial stream framing (magic + version/compat header
    and length-prefixed raw blocks) the old Java producers wrap
    message-set payloads in."""
    if data[: len(_XERIAL_MAGIC)] == _XERIAL_MAGIC:
        out = bytearray()
        pos = 16  # 8-byte magic + i32 version + i32 compat
        while pos + 4 <= len(data):
            (block_len,) = struct.unpack(">i", data[pos : pos + 4])
            pos += 4
            if block_len < 0 or pos + block_len > len(data):
                raise KafkaWireError("snappy: truncated xerial block")
            out += _snappy_decode_block(data[pos : pos + block_len])
            pos += block_len
        return bytes(out)
    return _snappy_decode_block(data)


def _snappy_decode_block(data: bytes) -> bytes:
    """One raw snappy block: unsigned-LEB128 uncompressed length, then a
    tag stream of literals and back-copies (possibly overlapping — the
    RLE idiom)."""
    pos = 0
    ulen = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise KafkaWireError("snappy: truncated length preamble")
        b = data[pos]
        pos += 1
        ulen |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = (tag >> 2) + 1
            if ln > 60:  # 61..64 encode a 1..4-byte little-endian length
                nbytes = ln - 60
                if pos + nbytes > len(data):
                    raise KafkaWireError("snappy: truncated literal length")
                ln = int.from_bytes(data[pos : pos + nbytes], "little") + 1
                pos += nbytes
            if pos + ln > len(data):
                raise KafkaWireError("snappy: truncated literal")
            out += data[pos : pos + ln]
            pos += ln
            continue
        if kind == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 0x7) + 4
            if pos >= len(data):
                raise KafkaWireError("snappy: truncated copy")
            off = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise KafkaWireError("snappy: copy offset out of range")
        while ln > 0:  # overlapping copies replicate the trailing bytes
            take = min(ln, off)
            start = len(out) - off
            out += out[start : start + take]
            ln -= take
    if len(out) != ulen:
        raise KafkaWireError(
            f"snappy: decoded {len(out)} bytes, preamble said {ulen}"
        )
    return bytes(out)


def snappy_compress(data: bytes) -> bytes:
    """Literal-only raw-block encoder (valid snappy, no back-references) —
    enough for the report producer path and the test fixtures."""
    ulen = len(data)
    out = bytearray()
    v = ulen
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | 0x80 if v else b)
        if not v:
            break
    pos = 0
    while pos < len(data):
        chunk = data[pos : pos + 65536]
        ln = len(chunk) - 1
        if ln < 60:
            out.append(ln << 2)
        else:
            out.append(61 << 2)  # upper-6-bits 61: 2-byte length follows
            out += ln.to_bytes(2, "little")
        out += chunk
        pos += len(chunk)
    return bytes(out)


# ------------------------------------------------------------ lz4 (codec 3)

_LZ4_MAGIC = 0x184D2204


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 (the lz4 frame checksum function) — needed only to WRITE
    valid frame headers (lz4_compress); reads skip checksum verification."""
    P1, P2, P3, P4, P5 = (
        2654435761, 2246822519, 3266489917, 668265263, 374761393,
    )
    M = 0xFFFFFFFF

    def rotl(x: int, r: int) -> int:
        return ((x << r) | (x >> (32 - r))) & M

    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + P1 + P2) & M
        v2 = (seed + P2) & M
        v3 = seed & M
        v4 = (seed - P1) & M
        while i + 16 <= n:
            for k, v in enumerate((v1, v2, v3, v4)):
                lane = int.from_bytes(data[i + 4 * k : i + 4 * k + 4], "little")
                v = (v + lane * P2) & M
                v = (rotl(v, 13) * P1) & M
                if k == 0:
                    v1 = v
                elif k == 1:
                    v2 = v
                elif k == 2:
                    v3 = v
                else:
                    v4 = v
            i += 16
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while i + 4 <= n:
        h = (h + int.from_bytes(data[i : i + 4], "little") * P3) & M
        h = (rotl(h, 17) * P4) & M
        i += 4
    while i < n:
        h = (h + data[i] * P5) & M
        h = (rotl(h, 11) * P1) & M
        i += 1
    h ^= h >> 15
    h = (h * P2) & M
    h ^= h >> 13
    h = (h * P3) & M
    h ^= h >> 16
    return h


def lz4_decompress(data: bytes) -> bytes:
    """Pure-stdlib lz4 FRAME decode (what Kafka codec 3 carries in both
    the record-batch v2 payload and the legacy message-set wrapper).
    Checksums (header/block/content) are parsed past but not verified —
    deliberately: the pre-KIP-57 Java clients computed the header checksum
    over the wrong span, and verifying would reject their batches."""
    if len(data) < 7 or int.from_bytes(data[:4], "little") != _LZ4_MAGIC:
        raise KafkaWireError("lz4: bad frame magic")
    flg = data[4]
    if flg >> 6 != 1:
        raise KafkaWireError(f"lz4: unsupported frame version {flg >> 6}")
    block_checksum = (flg >> 4) & 1
    content_size = (flg >> 3) & 1
    dict_id = flg & 1
    pos = 6  # magic + FLG + BD
    if content_size:
        pos += 8
    if dict_id:
        pos += 4
    pos += 1  # HC byte (not verified, see docstring)
    out = bytearray()
    while True:
        if pos + 4 > len(data):
            raise KafkaWireError("lz4: truncated block header")
        word = int.from_bytes(data[pos : pos + 4], "little")
        pos += 4
        if word == 0:  # EndMark
            break
        size = word & 0x7FFFFFFF
        if pos + size > len(data):
            raise KafkaWireError("lz4: truncated block")
        blk = data[pos : pos + size]
        pos += size
        if block_checksum:
            pos += 4
        if word & 0x80000000:  # stored uncompressed
            out += blk
        else:
            out += _lz4_decode_block(blk)
    return bytes(out)


def _lz4_decode_block(data: bytes) -> bytes:
    """One lz4 compressed block: a sequence stream of (token, literals,
    offset, match) with possibly-overlapping back-copies; the last
    sequence is literals-only."""
    out = bytearray()
    pos = 0
    n = len(data)
    while pos < n:
        token = data[pos]
        pos += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if pos >= n:
                    raise KafkaWireError("lz4: truncated literal length")
                b = data[pos]
                pos += 1
                lit += b
                if b != 255:
                    break
        if pos + lit > n:
            raise KafkaWireError("lz4: truncated literals")
        out += data[pos : pos + lit]
        pos += lit
        if pos == n:
            break  # last sequence carries no match
        if pos + 2 > n:
            raise KafkaWireError("lz4: truncated match offset")
        off = int.from_bytes(data[pos : pos + 2], "little")
        pos += 2
        if off == 0 or off > len(out):
            raise KafkaWireError("lz4: match offset out of range")
        mlen = token & 0xF
        if mlen == 15:
            while True:
                if pos >= n:
                    raise KafkaWireError("lz4: truncated match length")
                b = data[pos]
                pos += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        while mlen > 0:  # overlapping copies replicate the trailing bytes
            take = min(mlen, off)
            start = len(out) - off
            out += out[start : start + take]
            mlen -= take
    return bytes(out)


def lz4_compress(data: bytes) -> bytes:
    """Literal-only lz4 frame encoder (valid lz4, no back-references) —
    the fixture/producer counterpart of lz4_decompress, mirroring
    snappy_compress. Header checksum is the real xxh32 so strict decoders
    accept the frames too."""
    flg = 0x60  # version 01, block-independent, no checksums/size/dict
    bd = 0x70   # 4 MB max block size
    hc = (xxh32(bytes([flg, bd])) >> 8) & 0xFF
    out = bytearray(struct.pack("<I", _LZ4_MAGIC)) + bytes([flg, bd, hc])
    for pos in range(0, max(1, len(data)), 65536):
        chunk = data[pos : pos + 65536]
        lit = len(chunk)
        blk = bytearray()
        if lit < 15:
            blk.append(lit << 4)
        else:
            blk.append(0xF0)
            rem = lit - 15
            while rem >= 255:
                blk.append(255)
                rem -= 255
            blk.append(rem)
        blk += chunk
        out += struct.pack("<I", len(blk)) + blk
    out += struct.pack("<I", 0)  # EndMark
    return bytes(out)


# ------------------------------------------------------------ crc32c (Castagnoli)

_CRC32C_TABLE = []


def _crc32c_init() -> None:
    poly = 0x82F63B78
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC32C_TABLE.append(c)


_crc32c_init()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    tab = _CRC32C_TABLE
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ------------------------------------------------------------ wire primitives


def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _varint(n: int) -> bytes:
    v = _zigzag_encode(n) & 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise KafkaWireError("short response")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def i8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        if n < 0:
            return None
        return self._take(n).decode("utf-8", "replace")

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        if n < 0:
            return None
        return self._take(n)

    def varint(self) -> int:
        shift = 0
        v = 0
        while True:
            b = self._take(1)[0]
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (v >> 1) ^ -(v & 1)  # zigzag decode

    def remaining(self) -> int:
        return len(self.data) - self.pos


def _string(s: Optional[str]) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    raw = s.encode()
    return struct.pack(">h", len(raw)) + raw


def _bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


# ------------------------------------------------------------ broker connection


def _ssl_context(config: Config) -> Optional[ssl.SSLContext]:
    """getDialer's TLS setup (kafka.go:57-91): client keypair + CA when
    kafka_ssl_cert is set, else plain TLS when the protocol asks for it;
    verification disabled to match InsecureSkipVerify."""
    want_tls = bool(config.kafka_ssl_cert) or (
        config.kafka_security_protocol or ""
    ).lower() in ("ssl", "tls")
    if not want_tls:
        return None
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if config.kafka_ssl_ca:
        # an explicitly configured trust root is honored: verify the broker
        # chain and hostname against it (the reference's InsecureSkipVerify
        # would silently ignore it — surprising enough to diverge from)
        ctx.check_hostname = True
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.load_verify_locations(config.kafka_ssl_ca)
    else:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE  # reference: InsecureSkipVerify (XXX)
        log.warning(
            "KAFKA: no kafka_ssl_ca configured; broker certificate "
            "verification is DISABLED"
        )
    if config.kafka_ssl_cert:
        ctx.load_cert_chain(
            config.kafka_ssl_cert,
            keyfile=config.kafka_ssl_key or None,
            password=config.kafka_ssl_key_password or None,
        )
    return ctx


class BrokerConn:
    """One TCP(/TLS) connection to a broker, with api-version negotiation."""

    def __init__(self, host: str, port: int, config: Config):
        self.host, self.port = host, port
        timeout = config.kafka_dialer_timeout_seconds or 10
        sock = socket.create_connection((host, port), timeout=timeout)
        keepalive = config.kafka_dialer_keep_alive_seconds or 0
        if keepalive:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        ctx = _ssl_context(config)
        if ctx is not None:
            sock = ctx.wrap_socket(sock, server_hostname=host)
        self.sock = sock
        self._corr = 0
        self._lock = threading.Lock()
        self.api_versions: Dict[int, Tuple[int, int]] = {}
        self._negotiate()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def _negotiate(self) -> None:
        resp = self.request(_API_VERSIONS, 0, b"")
        r = _Reader(resp)
        err = r.i16()
        if err:
            raise KafkaWireError(f"ApiVersions error {err}")
        for _ in range(r.i32()):
            key, vmin, vmax = r.i16(), r.i16(), r.i16()
            self.api_versions[key] = (vmin, vmax)

    def pick_version(self, api_key: int, ours: List[int]) -> int:
        """Newest version in `ours` inside the broker's supported range."""
        if not self.api_versions:
            return ours[0]
        vmin, vmax = self.api_versions.get(api_key, (ours[0], ours[0]))
        for v in sorted(ours, reverse=True):
            if vmin <= v <= vmax:
                return v
        raise KafkaWireError(
            f"no common version for api {api_key}: broker [{vmin},{vmax}], "
            f"client {ours}"
        )

    def request(self, api_key: int, version: int, body: bytes,
                timeout: Optional[float] = None) -> bytes:
        with self._lock:
            self._corr += 1
            corr = self._corr
            header = struct.pack(">hhi", api_key, version, corr) + _string(_CLIENT_ID)
            msg = header + body
            old_timeout = self.sock.gettimeout()
            try:
                if timeout is not None:
                    self.sock.settimeout(timeout)
                self.sock.sendall(struct.pack(">i", len(msg)) + msg)
                raw = self._read_exact(4)
                (size,) = struct.unpack(">i", raw)
                resp = self._read_exact(size)
            except (OSError, ssl.SSLError) as e:
                raise KafkaWireError(f"broker io error: {e}") from None
            finally:
                try:
                    self.sock.settimeout(old_timeout)
                except OSError:
                    pass
        (got_corr,) = struct.unpack(">i", resp[:4])
        if got_corr != corr:
            raise KafkaWireError(f"correlation mismatch {got_corr} != {corr}")
        return resp[4:]

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise KafkaWireError("broker closed connection")
            buf.extend(chunk)
        return bytes(buf)


# ------------------------------------------------------------ metadata


def _parse_broker_list(config: Config) -> List[Tuple[str, int]]:
    out = []
    for b in config.kafka_brokers:
        host, _, port = b.rpartition(":")
        if not host:
            host, port = b, "9092"
        out.append((host, int(port)))
    if not out:
        raise KafkaWireError("no kafka_brokers configured")
    return out


def get_metadata(conn: BrokerConn, topic: str):
    """→ (brokers {node_id: (host, port)}, partitions {id: leader_node})."""
    v = conn.pick_version(_METADATA, [1, 7])
    body = struct.pack(">i", 1) + _string(topic)
    if v >= 4:
        body += struct.pack(">?", False)  # allow_auto_topic_creation
    r = _Reader(conn.request(_METADATA, v, body))
    if v >= 3:
        r.i32()  # throttle
    brokers: Dict[int, Tuple[str, int]] = {}
    for _ in range(r.i32()):
        node, host, port = r.i32(), r.string(), r.i32()
        r.string()  # rack (nullable, v1+)
        brokers[node] = (host or "", port)
    if v >= 2:
        r.string()  # cluster_id
    r.i32()  # controller_id
    partitions: Dict[int, int] = {}
    for _ in range(r.i32()):
        err, name = r.i16(), r.string()
        r.i8()  # is_internal (v1+)
        n_parts = r.i32()
        for _ in range(n_parts):
            p_err, pid, leader = r.i16(), r.i32(), r.i32()
            if v >= 7:
                r.i32()  # leader_epoch
            for _ in range(r.i32()):
                r.i32()  # replicas
            for _ in range(r.i32()):
                r.i32()  # isr
            if v >= 5:
                for _ in range(r.i32()):
                    r.i32()  # offline_replicas
            if p_err in (_ERR_NONE, _ERR_LEADER_NOT_AVAILABLE):
                partitions[pid] = leader
        if err not in (_ERR_NONE, _ERR_LEADER_NOT_AVAILABLE):
            raise KafkaWireError(f"metadata error {err} for topic {name!r}")
    return brokers, partitions


def list_latest_offset(conn: BrokerConn, topic: str, partition: int) -> int:
    """LastOffset positioning (kafka.go:127 kafka.LastOffset)."""
    v = conn.pick_version(_LIST_OFFSETS, [1, 4])
    body = struct.pack(">i", -1)  # replica_id
    if v >= 2:
        body += struct.pack(">b", 0)  # isolation_level read_uncommitted
    body += struct.pack(">i", 1) + _string(topic) + struct.pack(">i", 1)
    body += struct.pack(">i", partition)
    if v >= 4:
        body += struct.pack(">i", -1)  # current_leader_epoch
    body += struct.pack(">q", -1)  # timestamp: latest
    if v == 0:
        body += struct.pack(">i", 1)  # max_num_offsets
    r = _Reader(conn.request(_LIST_OFFSETS, v, body))
    if v >= 2:
        r.i32()  # throttle
    for _ in range(r.i32()):
        r.string()  # topic
        for _ in range(r.i32()):
            pid, err = r.i32(), r.i16()
            if err:
                raise KafkaWireError(f"ListOffsets error {err}")
            if v == 0:
                n = r.i32()
                return r.i64() if n else 0
            r.i64()  # timestamp
            off = r.i64()
            if v >= 4:
                r.i32()  # leader_epoch
            return off
    raise KafkaWireError("ListOffsets: empty response")


# ------------------------------------------------------------ record (de)coding


def _decode_message_set(data: bytes) -> List[Tuple[int, bytes]]:
    """Message-set v0/v1 → [(offset, value)]; recurses into gzip wrappers."""
    out: List[Tuple[int, bytes]] = []
    r = _Reader(data)
    while r.remaining() >= 12:
        offset = r.i64()
        size = r.i32()
        if r.remaining() < size:
            break  # partial trailing message (normal for fetch)
        msg = _Reader(r._take(size))
        msg.u32()  # crc (not verified on read)
        magic = msg.i8()
        attrs = msg.i8()
        if magic >= 1:
            msg.i64()  # timestamp
        msg.bytes_()  # key
        value = msg.bytes_()
        codec = attrs & 0x07
        if codec == 0:
            if value is not None:
                out.append((offset, value))
        elif codec == 1 and value is not None:
            inner = _decode_message_set(gzip.decompress(value))
            out.extend(inner)
        elif codec == 2 and value is not None:
            try:
                inner = _decode_message_set(snappy_decompress(value))
            except KafkaWireError as e:
                # a corrupt wrapper must not poison the fetch loop: the
                # same offset would refetch the same bytes forever
                _skip_batch(codec, f"undecodable snappy message set ({e});")
                continue
            out.extend(inner)
        elif codec == 3 and value is not None:
            try:
                inner = _decode_message_set(lz4_decompress(value))
            except KafkaWireError as e:
                _skip_batch(codec, f"undecodable lz4 message set ({e});")
                continue
            out.extend(inner)
        elif value is not None:
            _skip_batch(codec)
    return out


def _decode_record_batches(data: bytes) -> List[Tuple[int, bytes]]:
    """Record-batch v2 → [(offset, value)]; gzip handled, others skipped.
    Falls back to message-set decoding when the magic byte is < 2 (brokers
    may return old-format segments on any fetch version)."""
    out: List[Tuple[int, bytes]] = []
    r = _Reader(data)
    while r.remaining() >= 17:
        if r.data[r.pos + 16] < 2:  # magic byte: old message set
            out.extend(_decode_message_set(data[r.pos :]))
            return out
        base_offset = r.i64()
        batch_len = r.i32()
        if r.remaining() < batch_len:
            break  # partial batch
        batch = _Reader(r._take(batch_len))
        batch.i32()  # partition_leader_epoch
        batch.i8()   # magic (2)
        batch.u32()  # crc (not verified on read)
        attrs = batch.i16()
        batch.i32()  # last_offset_delta
        batch.i64()  # base_timestamp
        batch.i64()  # max_timestamp
        batch.i64()  # producer_id
        batch.i16()  # producer_epoch
        batch.i32()  # base_sequence
        n_records = batch.i32()
        if attrs & 0x20:
            # control batch (transaction commit/abort markers): not data —
            # yielding them would hand marker bytes to the command parser
            # (kafka-go filters these out client-side too)
            continue
        payload = batch._take(batch.remaining())
        codec = attrs & 0x07
        if codec == 1:
            payload = gzip.decompress(payload)
        elif codec == 2:
            try:
                payload = snappy_decompress(payload)
            except KafkaWireError as e:
                # corrupt payload: count + skip rather than poisoning the
                # fetch loop (the same offset would refetch it forever)
                _skip_batch(codec, f"undecodable snappy record batch ({e});")
                continue
        elif codec == 3:
            try:
                payload = lz4_decompress(payload)
            except KafkaWireError as e:
                _skip_batch(codec, f"undecodable lz4 record batch ({e});")
                continue
        elif codec:  # zstd (4) stays skip-counted
            _skip_batch(codec)
            continue
        pr = _Reader(payload)
        for _ in range(n_records):
            if pr.remaining() == 0:
                break
            length = pr.varint()
            rec = _Reader(pr._take(length))
            rec.i8()  # attributes
            rec.varint()  # timestamp_delta
            off_delta = rec.varint()
            klen = rec.varint()
            if klen >= 0:
                rec._take(klen)
            vlen = rec.varint()
            value = rec._take(vlen) if vlen >= 0 else None
            n_headers = rec.varint()
            for _ in range(n_headers):
                hk = rec.varint()
                rec._take(max(hk, 0))
                hv = rec.varint()
                if hv > 0:
                    rec._take(hv)
            if value is not None:
                out.append((base_offset + off_delta, value))
    return out


def _encode_message_set_v1(value: bytes, timestamp_ms: int, offset: int = 0) -> bytes:
    body = struct.pack(">bbq", 1, 0, timestamp_ms) + _bytes(None) + _bytes(value)
    crc = zlib.crc32(body) & 0xFFFFFFFF
    msg = struct.pack(">I", crc) + body
    return struct.pack(">qi", offset, len(msg)) + msg


def _encode_record_batch_v2(value: bytes, timestamp_ms: int, offset: int = 0) -> bytes:
    record_body = (
        struct.pack(">b", 0)        # attributes
        + _varint(0)                # timestamp delta
        + _varint(0)                # offset delta
        + _varint(-1)               # key: null
        + _varint(len(value)) + value
        + _varint(0)                # headers
    )
    record = _varint(len(record_body)) + record_body
    after_crc = (
        struct.pack(">hiqqqhii", 0, 0, timestamp_ms, timestamp_ms,
                    -1, -1, -1, 1)  # attrs, lastOffsetDelta, ts, ts, pid, epoch, seq, n
        + record
    )
    crc = crc32c(after_crc)
    batch = struct.pack(">ibI", -1, 2, crc) + after_crc  # leader_epoch, magic, crc
    return struct.pack(">qi", offset, len(batch)) + batch


# ------------------------------------------------------------ fetch / produce


def fetch(conn: BrokerConn, topic: str, partition: int, offset: int,
          max_wait_ms: int, min_bytes: int, max_bytes: int):
    """→ (records [(offset, value)], error_code)."""
    v = conn.pick_version(_FETCH, [2, 10])
    body = struct.pack(">iii", -1, max_wait_ms, min_bytes)
    if v >= 3:
        body += struct.pack(">i", max_bytes)
    if v >= 4:
        body += struct.pack(">b", 0)  # isolation_level
    if v >= 7:
        body += struct.pack(">ii", 0, -1)  # session_id, session_epoch
    body += struct.pack(">i", 1) + _string(topic) + struct.pack(">i", 1)
    body += struct.pack(">i", partition)
    if v >= 9:
        body += struct.pack(">i", -1)  # current_leader_epoch
    body += struct.pack(">q", offset)
    if v >= 5:
        body += struct.pack(">q", -1)  # log_start_offset
    body += struct.pack(">i", max_bytes)  # partition max bytes
    if v >= 7:
        body += struct.pack(">i", 0)  # forgotten_topics_data
    r = _Reader(conn.request(
        _FETCH, v, body, timeout=max(10.0, max_wait_ms / 1000 + 10)
    ))
    r.i32()  # throttle (v1+)
    if v >= 7:
        top_err = r.i16()
        r.i32()  # session_id
        if top_err:
            raise KafkaWireError(f"fetch error {top_err}")
    records: List[Tuple[int, bytes]] = []
    err = _ERR_NONE
    for _ in range(r.i32()):
        r.string()  # topic
        for _ in range(r.i32()):
            r.i32()  # partition
            err = r.i16()
            r.i64()  # high_watermark
            if v >= 4:
                r.i64()  # last_stable_offset
                if v >= 5:
                    r.i64()  # log_start_offset
                for _ in range(r.i32()):  # aborted transactions
                    r.i64()
                    r.i64()
            record_data = r.bytes_() or b""
            if err == _ERR_NONE and record_data:
                records.extend(_decode_record_batches(record_data))
    return records, err


def produce(conn: BrokerConn, topic: str, partition: int, value: bytes) -> None:
    v = conn.pick_version(_PRODUCE, [2, 7])
    ts = int(time.time() * 1000)
    if v >= 3:
        record_set = _encode_record_batch_v2(value, ts)
        body = _string(None)  # transactional_id
    else:
        record_set = _encode_message_set_v1(value, ts)
        body = b""
    body += struct.pack(">hi", 1, 30_000)  # acks=1, timeout
    body += struct.pack(">i", 1) + _string(topic) + struct.pack(">i", 1)
    body += struct.pack(">i", partition) + _bytes(record_set)
    r = _Reader(conn.request(_PRODUCE, v, body))
    for _ in range(r.i32()):
        r.string()
        for _ in range(r.i32()):
            r.i32()  # partition
            err = r.i16()
            if err:
                raise KafkaWireError(f"produce error {err}")
    # (throttle and later fields ignored)


# ------------------------------------------------------------ the transport


class WireKafkaTransport:
    """KafkaTransport implementation over the wire client.

    read_messages is a generator that yields message values from the pinned
    partition starting at the LATEST offset; any failure raises
    KafkaWireError so KafkaReader's reconnect loop (the shared capped
    jittered backoff, resilience/backoff.reconnect_backoff) takes
    over. send round-robins the report topic's
    partitions with acks=1; failures raise and the message is dropped —
    the reference's drop-don't-block producer semantics."""

    def __init__(self) -> None:
        self._consumer: Optional[BrokerConn] = None
        # one pooled connection per leader broker (multi-broker clusters
        # spread partition leaders; reconnecting per send would mean a full
        # TCP+TLS+ApiVersions handshake per report)
        self._producer_conns: Dict[Tuple[str, int], BrokerConn] = {}
        self._producer_parts: List[int] = []
        self._producer_leaders: Dict[int, Tuple[str, int]] = {}
        self._rr = 0
        self._closed = threading.Event()
        self._lock = threading.Lock()

    # -- connection helpers

    def _connect_any(self, config: Config) -> BrokerConn:
        last: Optional[Exception] = None
        for host, port in _parse_broker_list(config):
            try:
                return BrokerConn(host, port, config)
            except (OSError, KafkaWireError, ssl.SSLError) as e:
                last = e
        raise KafkaWireError(f"no reachable kafka broker: {last}")

    def _leader_conn(self, config: Config, topic: str, partition: int) -> BrokerConn:
        boot = self._connect_any(config)
        try:
            brokers, partitions = get_metadata(boot, topic)
            leader = partitions.get(partition)
            if leader is None or leader < 0:
                raise KafkaWireError(
                    f"no leader for {topic!r}[{partition}] "
                    f"(known partitions: {sorted(partitions)})"
                )
            host, port = brokers[leader]
            if (host, port) == (boot.host, boot.port):
                return boot
            conn = BrokerConn(host, port, config)
            boot.close()
            return conn
        except Exception:
            boot.close()
            raise

    # -- KafkaTransport API

    def read_messages(self, config: Config, topic: str, partition: int) -> Iterator[bytes]:
        # connect + position EAGERLY (not at first next()): LastOffset is
        # "latest as of subscribe time", matching kafka-go's reader
        conn = self._leader_conn(config, topic, partition)
        self._consumer = conn
        max_wait = config.kafka_max_wait_ms or 500
        min_bytes = config.kafka_min_bytes or 1
        max_bytes = config.kafka_max_bytes or (10 << 20)
        try:
            offset = list_latest_offset(conn, topic, partition)
        except Exception:
            conn.close()
            self._consumer = None
            raise
        log.info("KAFKA: consuming %s[%d] from offset %d (%s:%d)",
                 topic, partition, offset, conn.host, conn.port)

        def _iterate() -> Iterator[bytes]:
            nonlocal offset
            try:
                while not self._closed.is_set():
                    records, err = fetch(
                        conn, topic, partition, offset, max_wait, min_bytes,
                        max_bytes,
                    )
                    if err == _ERR_OFFSET_OUT_OF_RANGE:
                        offset = list_latest_offset(conn, topic, partition)
                        continue
                    if err != _ERR_NONE:
                        raise KafkaWireError(f"fetch error {err}")
                    for rec_offset, value in records:
                        if rec_offset < offset:
                            continue  # batches include earlier compacted records
                        offset = rec_offset + 1
                        yield value
            finally:
                conn.close()
                self._consumer = None

        return _iterate()

    def send(self, config: Config, topic: str, value: bytes) -> None:
        with self._lock:
            try:
                self._send_locked(config, topic, value)
            except (KafkaWireError, OSError, ssl.SSLError, KeyError):
                self._teardown_producer()
                raise

    def _send_locked(self, config: Config, topic: str, value: bytes) -> None:
        if not self._producer_parts:
            boot = self._connect_any(config)
            try:
                brokers, partitions = get_metadata(boot, topic)
            except Exception:
                boot.close()
                raise
            # only partitions with a live, known leader are sendable; a
            # partition mid-leader-election must not eat reports
            self._producer_leaders = {
                pid: brokers[node] for pid, node in partitions.items()
                if node >= 0 and node in brokers
            }
            self._producer_parts = sorted(self._producer_leaders)
            if not self._producer_parts:
                boot.close()
                raise KafkaWireError(
                    f"topic {topic!r} has no partition with a live leader"
                )
            self._producer_conns[(boot.host, boot.port)] = boot
        pid = self._producer_parts[self._rr % len(self._producer_parts)]
        self._rr += 1
        addr = self._producer_leaders[pid]
        conn = self._producer_conns.get(addr)
        if conn is None:
            conn = BrokerConn(addr[0], addr[1], config)
            self._producer_conns[addr] = conn
        produce(conn, topic, pid, value)

    def _teardown_producer(self) -> None:
        for conn in self._producer_conns.values():
            conn.close()
        self._producer_conns = {}
        self._producer_parts = []
        self._producer_leaders = {}

    def close(self) -> None:
        self._closed.set()
        if self._consumer is not None:
            self._consumer.close()
        for conn in self._producer_conns.values():
            conn.close()
