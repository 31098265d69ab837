"""Netlink-batched ipset writer: coalesced kernel-edge ban inserts (a
copy of `banjax_tpu/effectors/ipset_netlink.py`).

The subprocess shim in `effectors/ipset.py` forks `ipset add` once a
ban; this module talks AF_NETLINK / NFNL_SUBSYS_IPSET directly: many
`IPSET_CMD_ADD` messages packed into one sendmsg, their acks read back,
no fork on the path.

Two layers:

* pure encoders (`encode_ipset_add`, `encode_batch`, `parse_acks`):
  bytes in, bytes out, the JAX module's bytes;
* `IpsetBatchWriter`: a bounded background queue draining into netlink
  sends. `enqueue` never blocks and never raises (overflow sheds the
  OLDEST entries, counted); any netlink failure or per-entry NACK falls
  back to the per-entry subprocess shim (idempotent `-exist` adds); and
  a circuit breaker (`resilience/breaker.py`) routes straight to the
  subprocess while netlink is broken. The `ipset.netlink.send` failpoint
  sits before each send. This fallback is the kernel edge's own
  semantics; no card is involved.

The counters go to the `IpsetStats` the writer is given (the app's own;
a fresh one by default), not to a process-wide singleton.

IPv6: the banjax set is `hash:ip` (family inet), so only IPv4 entries
are encoded; anything else rides the subprocess fallback, counted.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from collections import deque
from typing import List, Optional, Tuple

from banjax_tpu_torch.effectors.ipset_stats import IpsetStats
from banjax_tpu_torch.resilience import failpoints
from banjax_tpu_torch.resilience.breaker import CircuitBreaker

log = logging.getLogger(__name__)

# ---- netlink / nfnetlink / ipset wire constants (linux uapi) ----
NETLINK_NETFILTER = 12
NLM_F_REQUEST = 0x1
NLM_F_ACK = 0x4
NLMSG_ERROR = 0x2
NLMSG_HDRLEN = 16

NFNL_SUBSYS_IPSET = 6
IPSET_CMD_ADD = 9
IPSET_PROTOCOL = 6

AF_INET = 2
NFNETLINK_V0 = 0

IPSET_ATTR_PROTOCOL = 1
IPSET_ATTR_SETNAME = 2
IPSET_ATTR_DATA = 7
IPSET_ATTR_IP = 1          # inside IPSET_ATTR_DATA
IPSET_ATTR_TIMEOUT = 6     # inside IPSET_ATTR_DATA
IPSET_ATTR_IPADDR_IPV4 = 1  # inside IPSET_ATTR_IP

NLA_F_NESTED = 0x8000
NLA_F_NET_BYTEORDER = 0x4000
NLA_HDRLEN = 4


def _align4(n: int) -> int:
    return (n + 3) & ~3


def _nla(attr_type: int, payload: bytes) -> bytes:
    """One netlink attribute: 4-byte header, payload, pad to 4."""
    length = NLA_HDRLEN + len(payload)
    return struct.pack("=HH", length, attr_type) + payload + b"\x00" * (
        _align4(length) - length
    )


def encode_ipset_add(set_name: str, ip: str, timeout_seconds: int,
                     seq: int) -> bytes:
    """One complete `IPSET_CMD_ADD` netlink message for an IPv4 entry —
    nlmsghdr + nfgenmsg + (PROTOCOL, SETNAME, nested DATA{nested IP
    {IPADDR_IPV4}, TIMEOUT}).  Raises OSError for a non-IPv4 `ip`
    (callers route those to the subprocess shim)."""
    addr = socket.inet_pton(socket.AF_INET, ip)  # OSError on non-IPv4
    payload = _nla(IPSET_ATTR_PROTOCOL, struct.pack("=B", IPSET_PROTOCOL))
    payload += _nla(IPSET_ATTR_SETNAME, set_name.encode() + b"\x00")
    ip_nested = _nla(IPSET_ATTR_IPADDR_IPV4 | NLA_F_NET_BYTEORDER, addr)
    data = _nla(IPSET_ATTR_IP | NLA_F_NESTED, ip_nested)
    data += _nla(IPSET_ATTR_TIMEOUT | NLA_F_NET_BYTEORDER,
                 struct.pack(">I", timeout_seconds))
    payload += _nla(IPSET_ATTR_DATA | NLA_F_NESTED, data)

    nfgen = struct.pack("=BBH", AF_INET, NFNETLINK_V0, 0)
    msg_type = (NFNL_SUBSYS_IPSET << 8) | IPSET_CMD_ADD
    length = NLMSG_HDRLEN + len(nfgen) + len(payload)
    header = struct.pack("=IHHII", length, msg_type,
                         NLM_F_REQUEST | NLM_F_ACK, seq, 0)
    return header + nfgen + payload


def encode_batch(set_name: str, entries: List[Tuple[str, int]],
                 seq_start: int = 1) -> Tuple[bytes, List[str]]:
    """Pack many adds into one sendmsg buffer.  Returns (buffer,
    skipped_ips) — entries netlink cannot carry (non-IPv4) are returned
    for the caller to route through the subprocess shim."""
    out = []
    skipped = []
    seq = seq_start
    for ip, timeout in entries:
        try:
            out.append(encode_ipset_add(set_name, ip, timeout, seq))
        except OSError:
            skipped.append(ip)
            continue
        seq += 1
    return b"".join(out), skipped


def parse_acks(buf: bytes) -> List[int]:
    """Error codes from a kernel ack buffer, one per NLMSG_ERROR message
    (0 = success, negative errno otherwise)."""
    codes = []
    off = 0
    while off + NLMSG_HDRLEN <= len(buf):
        length, msg_type, _flags, _seq, _pid = struct.unpack_from(
            "=IHHII", buf, off
        )
        if length < NLMSG_HDRLEN:
            break
        if msg_type == NLMSG_ERROR and off + NLMSG_HDRLEN + 4 <= len(buf):
            (err,) = struct.unpack_from("=i", buf, off + NLMSG_HDRLEN)
            codes.append(err)
        off += _align4(length)
    return codes


class IpsetBatchWriter:
    """Bounded background queue → coalesced netlink sends, subprocess
    fallback.  `enqueue` is the only producer API and it never blocks
    and never raises — the ban path must not stall on the kernel edge."""

    def __init__(self, ipset, max_queue: int = 1024,
                 flush_interval: float = 0.05,
                 breaker: Optional[CircuitBreaker] = None,
                 stats: Optional[IpsetStats] = None):
        self._ipset = ipset  # effectors/ipset.py IpsetInstance (fallback + name)
        self._max_queue = max_queue
        self._flush_interval = flush_interval
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._seq = 1
        self._sock: Optional[socket.socket] = None
        self.stats = stats if stats is not None else IpsetStats()
        self.stats.set_depth_fn(self.queue_depth)
        # consecutive netlink failures open the breaker: batches route
        # straight to subprocess (still lossless) until the recovery
        # window elapses and a half-open probe re-tries netlink
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=3, recovery_seconds=30.0, name="ipset-netlink"
        )
        self._thread = threading.Thread(
            target=self._drain_loop, name="ipset-netlink", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------ producer

    def enqueue(self, ip: str, timeout_seconds: int) -> None:
        """Queue one ban for the kernel set.  Overflow sheds the OLDEST
        queued entry (counted) — the newest ban is the one the attack is
        riding on right now."""
        with self._lock:
            while len(self._queue) >= self._max_queue:
                self._queue.popleft()
                self.stats.note_shed()
            self._queue.append((ip, timeout_seconds))
        self._kick.set()

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # ------------------------------------------------------------ consumer

    def _take_batch(self) -> List[Tuple[str, int]]:
        with self._lock:
            batch = list(self._queue)
            self._queue.clear()
        return batch

    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            self._kick.wait()
            if self._stop.is_set():
                break
            self._kick.clear()
            # small coalescing window: bursts arriving while we sleep
            # ride the same sendmsg
            self._stop.wait(self._flush_interval)
            batch = self._take_batch()
            if batch:
                self._flush(batch)
        # final drain so close() loses nothing
        batch = self._take_batch()
        if batch:
            self._flush(batch)

    def _flush(self, batch: List[Tuple[str, int]]) -> None:
        if self.breaker.allow():
            try:
                skipped = self._send_netlink(batch)
                self.breaker.record_success()
            except Exception as e:  # noqa: BLE001 — route, never raise
                self.breaker.record_failure()
                self.stats.note_error("netlink")
                log.warning("ipset netlink send failed (%s); "
                            "falling back to subprocess for %d entries",
                            e, len(batch))
                skipped = [ip for ip, _ in batch]
        else:
            skipped = [ip for ip, _ in batch]
        if skipped:
            timeouts = dict(batch)
            self._fallback(
                [(ip, timeouts[ip]) for ip in skipped if ip in timeouts]
            )

    def _send_netlink(self, batch: List[Tuple[str, int]]) -> List[str]:
        """Returns IPs the netlink path did not cover (non-IPv4, or
        per-entry kernel NACKs); raises on transport-level failure."""
        failpoints.check("ipset.netlink.send")
        buf, skipped = encode_batch(self._ipset.name, batch, self._seq)
        if not buf:
            return skipped
        n_msgs = len(batch) - len(skipped)
        self._seq += n_msgs
        sock = self._socket()
        try:
            sock.send(buf)
            acks = self._read_acks(sock, n_msgs)
        except OSError:
            self._close_socket()
            raise
        bad = sum(1 for code in acks if code != 0)
        if bad:
            # per-entry NACKs (e.g. set missing an entry slot): re-route
            # the whole batch — subprocess adds are `-exist`-idempotent,
            # so double-applying the acked ones is harmless
            self.stats.note_error("netlink", bad)
            return skipped + [ip for ip, _ in batch]
        self.stats.note_batch(n_msgs)
        return skipped

    def _read_acks(self, sock: socket.socket, expected: int) -> List[int]:
        acks: List[int] = []
        while len(acks) < expected:
            chunk = sock.recv(65536)
            if not chunk:
                break
            acks.extend(parse_acks(chunk))
        return acks

    def _socket(self) -> socket.socket:
        if self._sock is None:
            sock = socket.socket(socket.AF_NETLINK, socket.SOCK_RAW,
                                 NETLINK_NETFILTER)
            sock.settimeout(2.0)
            sock.bind((0, 0))
            self._sock = sock
        return self._sock

    def _close_socket(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _fallback(self, entries: List[Tuple[str, int]]) -> None:
        self.stats.note_fallback(len(entries))
        for ip, timeout in entries:
            try:
                self._ipset.add(ip, timeout)
            except Exception as e:  # noqa: BLE001 — counted, never raised
                self.stats.note_error("subprocess")
                log.error("ipset fallback add failed for %s: %s", ip, e)

    def close(self) -> None:
        """Stop the drain thread; whatever is still queued is flushed on
        the way out (the loop's final drain)."""
        self._stop.set()
        self._kick.set()
        self._thread.join(timeout=5)
        self._close_socket()
