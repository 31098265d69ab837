"""The shared-memory failed-challenge table and the warm tier of the
device-windows state (port of `ShmFailedChallengeStates`, `ShmWarmTier`
and `create_warm_tier` from `banjax_tpu/native/shm.py`, over the port's
copy of `shmstate.c`).

`ShmFailedChallengeStates` is the failed-challenge rate limiter of
multi-process serving (`httpapi/workers.py`): the fc_* table in a named
POSIX shared-memory segment that the primary creates and every worker
attaches by name, with the `apply` / `__len__` / `format_states`
interface of `decisions/rate_limit.py`'s class. Only the creator unlinks
the segment; an attaching process unregisters it from its
`resource_tracker`, which would otherwise unlink it when that process
exits.

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
import time
from multiprocessing import shared_memory
from typing import List, Optional, Tuple

import numpy as np

from banjax_tpu_torch.decisions.rate_limit import RateLimitMatchType, RateLimitResult
from banjax_tpu_torch.matcher.kernels._build import HostLibrary
from banjax_tpu_torch.native.slotmgr import encode_ips

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)

SHMSTATE = HostLibrary("shmstate", "shmstate.c", {
    "fc_init": (_I64, (_VP, _I64)),
    "fc_check": (_I64, (_VP,)),
    "fc_apply": (_I32, (_VP, ctypes.c_char_p, _I32, _I64, _I64, _I32, _i32p)),
    "fc_count": (_I64, (_VP,)),
    "fc_dropped": (_I64, (_VP,)),
    "fc_snapshot": (_I64, (_VP, ctypes.c_char_p, _i32p, _i32p, _i64p, _I64)),
    "fc_set_steal_ns": (None, (_I64,)),
    "fc_test_lock_slot": (None, (_VP, _I64, _I32)),
    "fc_test_slot_owner": (_I32, (_VP, _I64)),
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

FC_KEY_MAX = 104
FC_SLOT_BYTES = 128
FC_HEADER_BYTES = 128
MATCH_MASK = 0x0F
EXCEEDED_BIT = 0x10
DROPPED_BIT = 0x100


def unregister_from_tracker(shm: shared_memory.SharedMemory) -> None:
    """An attaching process must not unlink the segment at its exit:
    Python <= 3.12 registers every attach with the process's resource
    tracker, which unlinks at exit, pulling the table out from under the
    primary and the other workers. Only the creator unlinks."""
    from multiprocessing import resource_tracker

    resource_tracker.unregister(shm._name, "shared_memory")


class ShmFailedChallengeStates:
    """The failed-challenge rate limiter over a named shared-memory fc_*
    table: `name=None` creates the segment (the primary), a name attaches
    it (a worker). `format_states` lists entries in table (hash) order."""

    def __init__(self, name: Optional[str] = None, capacity: int = 65536):
        self._lib = SHMSTATE.lib()
        self.capacity = capacity
        if name is None:
            self._shm = shared_memory.SharedMemory(
                create=True, size=FC_HEADER_BYTES + capacity * FC_SLOT_BYTES)
            self.owner = True
            self._map_base()
            if self._lib.fc_init(self._base, capacity) != 0:
                self.close()
                self.unlink()
                raise ValueError(f"capacity {capacity} not a power of two")
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            self.owner = False
            unregister_from_tracker(self._shm)
            self._map_base()
            cap = self._lib.fc_check(self._base)
            if cap < 0:
                self.close()
                raise RuntimeError(f"shm segment {name} is not an fc table")
            self.capacity = int(cap)

    @property
    def name(self) -> str:
        return self._shm.name

    def _map_base(self) -> None:
        # the raw address of the mapping; the transient export is dropped
        # at once so that close() can release the mapping
        tmp = (ctypes.c_char * 1).from_buffer(self._shm.buf)
        self._base: Optional[ctypes.c_void_p] = ctypes.c_void_p(ctypes.addressof(tmp))
        del tmp

    def apply(self, ip: str, config) -> RateLimitResult:
        # key_len 0 marks an empty slot in C: the empty IP is one NUL byte
        key = ip.encode("utf-8", "surrogatepass")[:FC_KEY_MAX] or b"\x00"
        base = self._base
        if base is None:  # closed at shutdown; NULL would fault in C
            return RateLimitResult()
        hits = ctypes.c_int32(0)
        rc = self._lib.fc_apply(
            base, key, len(key), time.time_ns(),
            config.too_many_failed_challenges_interval_seconds * 1_000_000_000,
            config.too_many_failed_challenges_threshold, ctypes.byref(hits),
        )
        return RateLimitResult(match_type=RateLimitMatchType(rc & MATCH_MASK),
                               exceeded=bool(rc & EXCEEDED_BIT))

    def __len__(self) -> int:
        return int(self._lib.fc_count(self._base)) if self._base is not None else 0

    @property
    def dropped(self) -> int:
        return int(self._lib.fc_dropped(self._base)) if self._base is not None else 0

    def _entries(self) -> List[Tuple[str, int, int]]:
        if self._base is None:
            return []
        cap = self.capacity
        blob = ctypes.create_string_buffer(cap * FC_KEY_MAX)
        key_lens = np.zeros(cap, dtype=np.int32)
        hits = np.zeros(cap, dtype=np.int32)
        starts = np.zeros(cap, dtype=np.int64)
        n = int(self._lib.fc_snapshot(
            self._base, blob, key_lens.ctypes.data_as(_i32p), hits.ctypes.data_as(_i32p),
            starts.ctypes.data_as(_i64p), cap,
        ))
        raw_all = blob.raw
        out = []
        for i in range(n):
            raw = raw_all[i * FC_KEY_MAX : i * FC_KEY_MAX + int(key_lens[i])]
            ip = "" if raw == b"\x00" else raw.decode("utf-8", "surrogatepass")
            out.append((ip, int(hits[i]), int(starts[i])))
        return out

    def format_states(self) -> str:
        # the line format of FailedChallengeRateLimitStates.format_states
        return "".join(
            f"{ip},: interval_start: {start}, num hits: {hits}\n"
            for ip, hits, start in self._entries()
        )

    # --- fault-test hooks ---

    def set_steal_ns(self, ns: int) -> None:
        """Lower the lock-steal bound (process-wide; tests)."""
        self._lib.fc_set_steal_ns(ns)

    def _test_lock_slot(self, idx: int, tag: int) -> None:
        """Plant a raw owner tag on slot `idx`: a holder that died (a dead
        pid) or wedged (a live pid) inside its critical section."""
        self._lib.fc_test_lock_slot(self._base, idx, tag)

    def _test_slot_owner(self, idx: int) -> int:
        return int(self._lib.fc_test_slot_owner(self._base, idx))

    def close(self) -> None:
        self._base = None
        self._shm.close()

    def unlink(self) -> None:
        if self.owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


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
