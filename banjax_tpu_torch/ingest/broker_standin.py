"""A one-node Kafka broker in this process, for the port's own drives.

The scenario runner's Kafka mode, the fabric dry run's decision
replication and `chip_smoke.py`'s `kafka` and `fabric` phases need a broker
the port's client (`ingest/kafka_wire.py`) can speak to, with no broker
installed and nothing of the JAX package (whose test broker imports it).
This one is built on the port's own wire codecs.
"""

from __future__ import annotations

import socket
import struct
import threading
import time

from banjax_tpu_torch.ingest import kafka_wire as kw


class KafkaBrokerStandIn:
    """A one-node Kafka broker in this process, built on the port's wire
    codecs (`banjax_tpu_torch/ingest/kafka_wire.py`): the API subset the
    port's client speaks on the "modern" ladder (ApiVersions v0, Metadata
    v4-7, ListOffsets v2-4, Fetch v4-10 with long polls, Produce v3-7,
    record batch v2), in-memory logs, one thread per connection, on a
    loopback port. `append` is another producer writing to a topic;
    `fetches` counts fetch requests by topic."""

    VERSIONS = {0: (3, 7), 1: (4, 10), 2: (2, 4), 3: (4, 7), 18: (0, 0)}

    def __init__(self):
        self.logs = {}
        self.fetches = {}
        self._cv = threading.Condition()
        self._server = socket.create_server(("127.0.0.1", 0))
        self.port = self._server.getsockname()[1]
        self._stop = threading.Event()
        self._conns = []

    def start(self) -> "KafkaBrokerStandIn":
        threading.Thread(target=self._accept, name="broker-accept", daemon=True).start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._server.close()
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass

    def append(self, topic: str, values) -> float:
        """Append messages to partition 0 of `topic`; returns the time."""
        with self._cv:
            self.logs.setdefault(topic, []).extend(values)
            self._cv.notify_all()
            return time.time()

    def messages(self, topic: str) -> list:
        with self._cv:
            return list(self.logs.get(topic, []))

    def log_end_offset(self, topic: str) -> int:
        """The next offset of partition 0 of `topic` (its message count)."""
        with self._cv:
            return len(self.logs.get(topic, []))

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,), name="broker-conn",
                             daemon=True).start()

    def _serve(self, conn) -> None:
        def read(n):
            buf = b""
            while len(buf) < n:
                chunk = conn.recv(n - len(buf))
                if not chunk:
                    return None
                buf += chunk
            return buf

        try:
            while not self._stop.is_set():
                head = read(4)
                payload = head and read(struct.unpack(">i", head)[0])
                if not payload:
                    return
                r = kw._Reader(payload)
                api, version, corr = r.i16(), r.i16(), r.i32()
                r.string()
                body = self._dispatch(api, version, r)
                conn.sendall(struct.pack(">ii", len(body) + 4, corr) + body)
        except OSError:
            pass
        finally:
            conn.close()

    def _dispatch(self, api, v, r) -> bytes:
        if api == 18:
            return struct.pack(">hi", 0, len(self.VERSIONS)) + b"".join(
                struct.pack(">hhh", k, lo, hi) for k, (lo, hi) in sorted(self.VERSIONS.items()))
        lo, hi = self.VERSIONS.get(api, (-1, -1))
        if not lo <= v <= hi:
            raise OSError(f"api {api} v{v} outside [{lo}, {hi}]")
        if api == 3:  # Metadata: one broker (this one), one partition a topic
            topics = [r.string() for _ in range(r.i32())]
            out = struct.pack(">ii", 0, 1) + struct.pack(">i", 0) + kw._string("127.0.0.1")
            out += struct.pack(">i", self.port) + kw._string(None) + kw._string("stand-in")
            out += struct.pack(">ii", 0, len(topics))
            for t in topics:
                out += struct.pack(">h", 0) + kw._string(t) + struct.pack(">bi", 0, 1)
                out += struct.pack(">hii", 0, 0, 0)
                if v >= 7:
                    out += struct.pack(">i", 0)
                out += struct.pack(">iiii", 1, 0, 1, 0) + struct.pack(">i", 0)
            return out
        if api == 2:  # ListOffsets (latest)
            r.i32()
            r.i8()
            r.i32()
            topic = r.string()
            r.i32()
            part = r.i32()
            if v >= 4:
                r.i32()
            r.i64()
            with self._cv:
                end = len(self.logs.get(topic, []))
            out = struct.pack(">ii", 0, 1) + kw._string(topic) + struct.pack(">iih", 1, part, 0)
            out += struct.pack(">qq", -1, end)
            return out + (struct.pack(">i", 0) if v >= 4 else b"")
        if api == 1:  # Fetch: long poll until the offset has data
            r.i32()
            max_wait = r.i32()
            r.i32()
            r.i32()
            r.i8()
            if v >= 7:
                r.i32()
                r.i32()
            r.i32()
            topic = r.string()
            r.i32()
            part = r.i32()
            if v >= 9:
                r.i32()
            offset = r.i64()
            r.i64()
            r.i32()
            deadline = time.time() + max_wait / 1000.0
            with self._cv:
                self.fetches[topic] = self.fetches.get(topic, 0) + 1
                while (len(self.logs.get(topic, [])) <= offset and time.time() < deadline
                       and not self._stop.is_set()):
                    self._cv.wait(max(0.001, deadline - time.time()))
                msgs = self.logs.get(topic, [])[offset:]
                end = len(self.logs.get(topic, []))
            data = b"".join(kw._encode_record_batch_v2(m, 0, offset + i) for i, m in enumerate(msgs))
            out = struct.pack(">i", 0) + (struct.pack(">hi", 0, 0) if v >= 7 else b"")
            out += struct.pack(">i", 1) + kw._string(topic) + struct.pack(">i", 1)
            out += struct.pack(">ihqqqi", part, 0, end, end, 0, 0)
            return out + struct.pack(">i", len(data)) + data
        if api == 0:  # Produce (acks=1)
            r.string()
            r.i16()
            r.i32()
            r.i32()
            topic = r.string()
            r.i32()
            part = r.i32()
            values = [val for _, val in kw._decode_record_batches(r.bytes_() or b"")]
            with self._cv:
                log = self.logs.setdefault(topic, [])
                base = len(log)
                log.extend(values)
                self._cv.notify_all()
            out = struct.pack(">i", 1) + kw._string(topic) + struct.pack(">iihq", 1, part, 0, base)
            return out + struct.pack(">qqi", -1, 0, 0)
        raise OSError(f"api {api} is not served")
