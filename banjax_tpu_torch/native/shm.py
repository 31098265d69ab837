"""The warm tier of the device-windows state (port of `ShmWarmTier` and
`create_warm_tier` from `banjax_tpu/native/shm.py`, over the port's copy
of the wt_* table in `shmstate.c`).

Evicted hot-tier (device slot) state spills here as one record per IP —
its per-rule (hits, interval start) vector in insertion order — and a
returning IP refills it byte for byte. The record layout is the JAX
package's: a 128-byte table header, then `capacity` (a power of two)
records of a 128-byte record header and `max_rules` entries of 24 bytes.

The table lives in one shared anonymous mapping of the process (the
memory a `fork`ed worker would share); it is never a file, so it needs
no `/dev/shm` room and leaves nothing behind. Pages are committed as
records are first written. If the library cannot be built or the table
cannot be mapped, creation raises: there is no Python fallback table.

All calls must be externally locked: DeviceWindows holds its own lock
around every use.
"""

from __future__ import annotations

import ctypes
import mmap
from typing import List, Optional, Tuple

import numpy as np

from banjax_tpu_torch.matcher.kernels._build import HostLibrary
from banjax_tpu_torch.native.slotmgr import encode_ips

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)

SHMSTATE = HostLibrary("shmstate", "shmstate.c", {
    "wt_init": (_I64, (_VP, _I64, _I64)),
    "wt_check": (_I64, (_VP,)),
    "wt_len": (_I64, (_VP,)),
    "wt_dropped": (_I64, (_VP,)),
    "wt_put": (_I64, (_VP, ctypes.c_char_p, _I32, _I64, _I64, _i32p, _i32p, _i64p, _i64p, _I64)),
    "wt_take": (_I64, (_VP, ctypes.c_char_p, _I32, _i32p, _i32p, _i64p, _i64p)),
    "wt_get": (_I64, (_VP, ctypes.c_char_p, _I32, _i32p, _i32p, _i64p, _i64p)),
    "wt_snapshot_keys": (_I64, (_VP, ctypes.c_char_p, _i32p, _I64)),
    "wt_contains_batch": (_I64, (_VP, _u8p, _i64p, _i64p, _I64, _u8p)),
})

# (rule_id, num_hits, interval_start_s, interval_start_ns): the shadow
# map's value tuple with the rule id made explicit
WarmEntries = List[Tuple[int, int, int, int]]

WT_KEY_MAX = 104
WT_HEADER_BYTES = 128
WT_REC_HEADER_BYTES = 128
WT_ENTRY_BYTES = 24


def _wt_key(ip: str) -> bytes:
    # key_len 0 means "empty record" in C, so the empty ip is one NUL byte
    return ip.encode("utf-8", "surrogatepass")[:WT_KEY_MAX] or b"\x00"


def table_bytes(capacity: int, max_rules: int) -> int:
    """Bytes of a table of `capacity` records (rounded up to a power of
    two) of `max_rules` entries each."""
    cap = 1
    while cap < max(2, capacity):
        cap *= 2
    return WT_HEADER_BYTES + cap * (WT_REC_HEADER_BYTES + max(1, max_rules) * WT_ENTRY_BYTES)


class ShmWarmTier:
    """The wt_* table over one shared anonymous mapping."""

    def __init__(self, capacity: int = 1 << 20, max_rules: int = 16,
                 expiry_ns: int = 300 * 1_000_000_000):
        self._lib = SHMSTATE.lib()
        cap = 1
        while cap < max(2, capacity):
            cap *= 2
        self.capacity = cap
        self.max_rules = max(1, int(max_rules))
        self.expiry_ns = int(expiry_ns)
        self.nbytes = table_bytes(cap, self.max_rules)
        self._mm = mmap.mmap(-1, self.nbytes, flags=mmap.MAP_SHARED | mmap.MAP_ANONYMOUS)
        self._view = np.frombuffer(self._mm, dtype=np.uint8)
        self._base = ctypes.c_void_p(self._view.ctypes.data)
        if self._lib.wt_init(self._base, cap, self.max_rules) != 0:
            raise ValueError(f"bad warm-tier geometry {cap}x{self.max_rules}")
        # output scratch reused by take/get (max_rules entries)
        self._rid = np.zeros(self.max_rules, dtype=np.int32)
        self._hits = np.zeros(self.max_rules, dtype=np.int32)
        self._ss = np.zeros(self.max_rules, dtype=np.int64)
        self._sns = np.zeros(self.max_rules, dtype=np.int64)

    def put(self, ip: str, entries: WarmEntries, now_ns: int) -> bool:
        """Spill one IP's window vector; False when the put was dropped
        (probe window full of live, unexpired records)."""
        if not entries:
            return False
        key = _wt_key(ip)
        n = len(entries)
        rid = np.fromiter((e[0] for e in entries), np.int32, count=n)
        hits = np.fromiter((e[1] for e in entries), np.int32, count=n)
        ss = np.fromiter((e[2] for e in entries), np.int64, count=n)
        sns = np.fromiter((e[3] for e in entries), np.int64, count=n)
        rc = self._lib.wt_put(
            self._base, key, len(key), now_ns, self.expiry_ns,
            rid.ctypes.data_as(_i32p), hits.ctypes.data_as(_i32p),
            ss.ctypes.data_as(_i64p), sns.ctypes.data_as(_i64p), min(n, self.max_rules),
        )
        return rc == 0

    def _read(self, ip: str, fn) -> Optional[WarmEntries]:
        key = _wt_key(ip)
        n = int(fn(
            self._base, key, len(key),
            self._rid.ctypes.data_as(_i32p), self._hits.ctypes.data_as(_i32p),
            self._ss.ctypes.data_as(_i64p), self._sns.ctypes.data_as(_i64p),
        ))
        if n < 0:
            return None
        return [
            (int(self._rid[k]), int(self._hits[k]), int(self._ss[k]), int(self._sns[k]))
            for k in range(n)
        ]

    def take(self, ip: str) -> Optional[WarmEntries]:
        """Refill read: the record is deleted (the state moves back to the
        hot tier's shadow)."""
        return self._read(ip, self._lib.wt_take)

    def peek(self, ip: str) -> Optional[WarmEntries]:
        """Non-deleting read for introspection (get / format_states)."""
        return self._read(ip, self._lib.wt_get)

    def contains_batch(self, ips) -> np.ndarray:
        """bool [n] membership over a distinct ip list: one C call."""
        n = len(ips)
        out = np.zeros(n, dtype=np.uint8)
        if n == 0:
            return out.astype(bool)
        blob, offs, lens = encode_ips([ip if ip else "\x00" for ip in ips])
        buf = np.frombuffer(blob, dtype=np.uint8)
        self._lib.wt_contains_batch(
            self._base, buf.ctypes.data_as(_u8p), offs.ctypes.data_as(_i64p),
            lens.ctypes.data_as(_i64p), n, out.ctypes.data_as(_u8p),
        )
        return out.astype(bool)

    def keys(self) -> List[str]:
        """Live keys in table order."""
        cap = self.capacity
        blob = ctypes.create_string_buffer(cap * WT_KEY_MAX)
        key_lens = np.zeros(cap, dtype=np.int32)
        n = int(self._lib.wt_snapshot_keys(self._base, blob, key_lens.ctypes.data_as(_i32p), cap))
        raw_all = blob.raw
        out = []
        for i in range(n):
            raw = raw_all[i * WT_KEY_MAX : i * WT_KEY_MAX + int(key_lens[i])]
            out.append("" if raw == b"\x00" else raw.decode("utf-8", "surrogatepass"))
        return out

    def __len__(self) -> int:
        return int(self._lib.wt_len(self._base))

    @property
    def dropped(self) -> int:
        return int(self._lib.wt_dropped(self._base))

    def close(self) -> None:
        """Unmap the table; the object is unusable afterwards."""
        self._view = None
        self._base = None
        self._mm.close()


def create_warm_tier(capacity: int = 1 << 20, max_rules: int = 16,
                     expiry_ns: int = 300 * 1_000_000_000) -> ShmWarmTier:
    """The warm tier; raises when the library cannot be built or the table
    cannot be mapped."""
    return ShmWarmTier(capacity=capacity, max_rules=max_rules, expiry_ns=expiry_ns)
