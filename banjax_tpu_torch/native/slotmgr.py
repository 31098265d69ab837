"""ctypes shim for the native slot manager (port of `banjax_tpu/native/
slotmgr.py`, over the port's copy `slotmgr.c`).

`create(capacity)` returns a SlotManager; it raises when the library
cannot be built or loaded (no dict-path fallback). The port's dict slot
path in `matcher/windows.py` stays as the differential oracle and as the
route `slotmgr_native: false` selects.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from banjax_tpu_torch.matcher.kernels._build import HostLibrary

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)

SLOTMGR = HostLibrary("slotmgr", "slotmgr.c", {
    "sm_create": (_VP, (_I64,)),
    "sm_destroy": (None, (_VP,)),
    "sm_assigned": (_I64, (_VP,)),
    "sm_free_count": (_I64, (_VP,)),
    "sm_grow": (_I64, (_VP, _I64)),
    "sm_lookup_batch": (_I64, (_VP, _u8p, _i64p, _i64p, _I64, _I64, _i64p, _i32p, _i64p)),
    "sm_place_misses": (_I64, (
        _VP, _u8p, _i64p, _i64p, _I64, _i32p, _i64p, _i32p, _i64p, _I64, _i64p, _i64p,
    )),
    "sm_contains_batch": (_I64, (_VP, _u8p, _i64p, _i64p, _I64, _u8p)),
})


def _P(a: np.ndarray, t):
    return a.ctypes.data_as(t)


def encode_ips(ips: Sequence[str]) -> Tuple[bytes, np.ndarray, np.ndarray]:
    """One blob + (offset, length) spans for a distinct-ip list. The
    all-ASCII case is one join + one encode (byte lengths = char lengths)."""
    n = len(ips)
    joined = "".join(ips)
    blob = joined.encode("utf-8", "surrogatepass")
    if len(blob) == len(joined):
        lens = np.fromiter(map(len, ips), dtype=np.int64, count=n)
    else:
        lens = np.fromiter(
            (len(ip.encode("utf-8", "surrogatepass")) for ip in ips),
            dtype=np.int64, count=n,
        )
    offs = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.cumsum(lens[:-1], out=offs[1:])
    return blob, offs, lens


def _blob_array(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob, dtype=np.uint8) if blob else np.zeros(1, dtype=np.uint8)


class SlotManager:
    """One native ip -> slot table. All calls must be externally locked:
    DeviceWindows holds its own lock around every use, as it does for the
    dict path."""

    def __init__(self, capacity: int):
        self._lib = SLOTMGR.lib()
        self._h = self._lib.sm_create(capacity)
        if not self._h:
            raise MemoryError(f"sm_create({capacity}) failed")
        self.capacity = capacity

    def close(self) -> None:
        if self._h:
            self._lib.sm_destroy(self._h)
            self._h = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def assigned(self) -> int:
        return int(self._lib.sm_assigned(self._h))

    def free_count(self) -> int:
        return int(self._lib.sm_free_count(self._h))

    def grow(self, new_capacity: int) -> None:
        if self._lib.sm_grow(self._h, new_capacity) != 0:
            raise MemoryError("slotmgr grow failed")
        self.capacity = new_capacity

    def lookup_batch(self, ips: Sequence[str], batch_seq: int, last_used: np.ndarray):
        """Pass 1 over a distinct ip list: resolve hits (stamping their
        recency with batch_seq) and collect misses. Returns (slots int32
        [n], -1 per miss; miss_idx int64 [m]; ctx for place_misses). The
        caller may grow the manager between the passes."""
        n = len(ips)
        slots = np.empty(n, dtype=np.int32)
        if n == 0:
            return slots, np.empty(0, np.int64), None
        blob, offs, lens = encode_ips(ips)
        buf = _blob_array(blob)
        miss_idx = np.empty(n, dtype=np.int64)
        n_miss = int(self._lib.sm_lookup_batch(
            self._h, _P(buf, _u8p), _P(offs, _i64p), _P(lens, _i64p), n,
            batch_seq, _P(last_used, _i64p), _P(slots, _i32p), _P(miss_idx, _i64p),
        ))
        return slots, miss_idx[:n_miss], (buf, offs, lens)

    def place_misses(self, ctx, slots: np.ndarray, miss_idx: np.ndarray,
                     batch_seq: int, pin_counts: np.ndarray, last_used: np.ndarray):
        """Pass 2: place every miss in ip order (free stack first, then the
        minimum-(last_used, slot) eviction). Returns (placed_miss_idx,
        evict_slots, ok); ok=False is the refusal (every candidate pinned),
        with the placements made before it kept and reported."""
        n_miss = len(miss_idx)
        if n_miss == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64), True
        buf, offs, lens = ctx
        evict = np.empty(n_miss, dtype=np.int64)
        counts = np.zeros(2, dtype=np.int64)
        rc = int(self._lib.sm_place_misses(
            self._h, _P(buf, _u8p), _P(offs, _i64p), _P(lens, _i64p),
            batch_seq, _P(pin_counts, _i32p), _P(last_used, _i64p),
            _P(slots, _i32p), _P(miss_idx, _i64p), n_miss,
            _P(evict, _i64p), _P(counts, _i64p),
        ))
        return miss_idx[: int(counts[1])], evict[: int(counts[0])], rc == 0

    def contains_batch(self, ips: Sequence[str]) -> np.ndarray:
        """bool [n] membership over a distinct ip list, with no recency
        stamp (the admission gate's hot-tier check)."""
        n = len(ips)
        out = np.zeros(n, dtype=np.uint8)
        if n == 0:
            return out.astype(bool)
        blob, offs, lens = encode_ips(ips)
        buf = _blob_array(blob)
        self._lib.sm_contains_batch(
            self._h, _P(buf, _u8p), _P(offs, _i64p), _P(lens, _i64p), n, _P(out, _u8p),
        )
        return out.astype(bool)


def create(capacity: int) -> SlotManager:
    """A SlotManager for `capacity` slots; raises when the library cannot
    be built or loaded."""
    return SlotManager(capacity)
