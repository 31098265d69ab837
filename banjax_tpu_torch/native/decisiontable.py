"""The serving fast path's decision table (port of `ShmDecisionTable` and
`create_decision_table` from `banjax_tpu/native/decisiontable.py`, over
the port's copy of `decisiontable.c`).

An open-addressed table of already-decided IPs, read without a lock
(seqlock per slot), written under the table's writer lock. The dynamic
lists mirror every insert, expiry and removal into it
(`decisions/dynamic_lists.py` `set_mirror`), and `/auth_request` answers
a hit from it without the decision chain (`httpapi/fastpath.py`).

A single serving process keeps the table in one shared anonymous mapping
(`DecisionTable`, `create_decision_table`), as the warm tier does
(`native/shm.py`). Multi-process serving (`httpapi/workers.py`) puts it
in a named POSIX shared-memory segment (`ShmDecisionTable`): the primary
creates it and mirrors the dynamic lists into it, each worker attaches
it by name and only reads it. Only the creator unlinks the segment; an
attaching process unregisters it from its `resource_tracker`. The C
library is built with `cc` at first use into `build/native/`. If it
cannot be built or the table cannot be created or attached, creation
raises: the port has no Python table to fall back on.
"""

from __future__ import annotations

import ctypes
import mmap
import threading
import time
from multiprocessing import shared_memory
from typing import Optional, Tuple

import numpy as np

from banjax_tpu_torch.matcher.kernels._build import HostLibrary

_VP = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_dp = ctypes.POINTER(ctypes.c_double)

DECISIONTABLE = HostLibrary("decisiontable", "decisiontable.c", {
    "dt_init": (_I64, (_VP, _I64)),
    "dt_check": (_I64, (_VP,)),
    "dt_put": (_I32, (_VP, ctypes.c_char_p, _I32, _I32, _I32, ctypes.c_uint32,
                      ctypes.c_double, ctypes.c_double)),
    "dt_get": (_I32, (_VP, ctypes.c_char_p, _I32, _u8p, _u8p, _u32p, _dp)),
    "dt_del": (_I32, (_VP, ctypes.c_char_p, _I32)),
    "dt_clear": (None, (_VP,)),
    "dt_len": (_I64, (_VP,)),
    "dt_dropped": (_I64, (_VP,)),
    "dt_session_add": (_I64, (_VP, _I64)),
    "dt_session_count": (_I64, (_VP,)),
    "dt_site_hash": (ctypes.c_uint32, (ctypes.c_char_p, _I32)),
    "dt_set_steal_ns": (None, (_I64,)),
    "dt_test_wedge_slot": (None, (_VP, ctypes.c_char_p, _I32)),
    "dt_test_unwedge_slot": (None, (_VP, ctypes.c_char_p, _I32)),
})

KEY_MAX = 64
SLOT_BYTES = 96
HEADER_BYTES = 128

FLAG_FROM_BASKERVILLE = 0x01


def _round_pow2(capacity: int) -> int:
    cap = 2
    while cap < max(2, capacity):
        cap *= 2
    return cap


def _key(ip: str) -> bytes:
    # key_len 0 marks a free slot in C: the empty IP is one NUL byte
    return ip.encode("utf-8", "surrogatepass")[:KEY_MAX] or b"\x00"


class DecisionTable:
    """The native table over one shared anonymous mapping.

    `get(ip)` is the serving hot path: no lock, one bounded probe; a torn
    read or a closed table reads as a miss and the chain serves the
    request. Mutations take the in-table writer lock.
    """

    def __init__(self, capacity: int = 65536):
        self._lib = DECISIONTABLE.lib()
        self.capacity = _round_pow2(capacity)
        self.nbytes = HEADER_BYTES + self.capacity * SLOT_BYTES
        self._mm = mmap.mmap(-1, self.nbytes, flags=mmap.MAP_SHARED | mmap.MAP_ANONYMOUS)
        self._view = np.frombuffer(self._mm, dtype=np.uint8)
        self._base: Optional[ctypes.c_void_p] = ctypes.c_void_p(self._view.ctypes.data)
        if self._lib.dt_init(self._base, self.capacity) < 0:
            raise ValueError(f"capacity {self.capacity} is not a power of two")
        self._out = threading.local()

    def put(self, ip: str, decision: int, expires: float,
            from_baskerville: bool = False, domain: str = "",
            now: Optional[float] = None) -> bool:
        """Insert or replace; False when the probe window is full of live
        entries (refused and counted in `dropped`)."""
        base = self._base
        if base is None:
            return False
        key = _key(ip)
        flags = FLAG_FROM_BASKERVILLE if from_baskerville else 0
        dk = domain.encode("utf-8", "surrogatepass")
        site_hash = self._lib.dt_site_hash(dk, len(dk)) if dk else 0
        return self._lib.dt_put(
            base, key, len(key), int(decision), flags, site_hash, float(expires),
            float(time.time() if now is None else now),
        ) == 0

    def get(self, ip: str) -> Optional[Tuple[int, float, bool]]:
        """(decision, expires, from_baskerville), or None. The out cells
        are made once per thread: ctypes allocations cost more than the
        probe."""
        base = self._base
        if base is None:
            return None
        key = _key(ip)
        out = self._out
        try:
            refs = out.refs
        except AttributeError:
            out.cells = (ctypes.c_uint8(0), ctypes.c_uint8(0), ctypes.c_uint32(0),
                         ctypes.c_double(0.0))
            refs = out.refs = tuple(ctypes.byref(c) for c in out.cells)
        if self._lib.dt_get(base, key, len(key), *refs) != 0:
            return None
        decision, flags, _site_hash, expires = out.cells
        return int(decision.value), float(expires.value), bool(flags.value & FLAG_FROM_BASKERVILLE)

    def delete(self, ip: str) -> bool:
        base = self._base
        if base is None:
            return False
        key = _key(ip)
        return self._lib.dt_del(base, key, len(key)) == 0

    def clear(self) -> None:
        if self._base is not None:
            self._lib.dt_clear(self._base)

    def __len__(self) -> int:
        return int(self._lib.dt_len(self._base)) if self._base is not None else 0

    @property
    def dropped(self) -> int:
        return int(self._lib.dt_dropped(self._base)) if self._base is not None else 0

    def session_add(self, delta: int) -> int:
        if self._base is None:
            return 0
        return int(self._lib.dt_session_add(self._base, delta))

    def session_count(self) -> int:
        return int(self._lib.dt_session_count(self._base)) if self._base is not None else 0

    def close(self) -> None:
        """Unmap the table; later calls read as an empty, closed table."""
        if self._base is None:
            return
        self._base = None
        self._view = None
        self._mm.close()


class ShmDecisionTable(DecisionTable):
    """The native table over a named POSIX shared-memory segment:
    `name=None` creates it (the primary), a name attaches it (a worker)."""

    def __init__(self, name: Optional[str] = None, capacity: int = 65536):
        from banjax_tpu_torch.native.shm import unregister_from_tracker

        self._lib = DECISIONTABLE.lib()
        self._out = threading.local()
        self.capacity = _round_pow2(capacity)
        self._view = None
        if name is None:
            self.nbytes = HEADER_BYTES + self.capacity * SLOT_BYTES
            self._shm = shared_memory.SharedMemory(create=True, size=self.nbytes)
            self.owner = True
            self._map_base()
            if self._lib.dt_init(self._base, self.capacity) < 0:
                self.close()
                self.unlink()
                raise ValueError(f"capacity {self.capacity} is not a power of two")
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            self.owner = False
            unregister_from_tracker(self._shm)
            self._map_base()
            cap = self._lib.dt_check(self._base)
            if cap < 0:
                self.close()
                raise RuntimeError(f"shm segment {name} is not a decision table")
            self.capacity = int(cap)
            self.nbytes = HEADER_BYTES + self.capacity * SLOT_BYTES

    @property
    def name(self) -> str:
        return self._shm.name

    def _map_base(self) -> None:
        # the raw address of the mapping; the transient export is dropped
        # at once so that close() can release the mapping
        tmp = (ctypes.c_char * 1).from_buffer(self._shm.buf)
        self._base = ctypes.c_void_p(ctypes.addressof(tmp))
        del tmp

    # --- fault-test hooks ---

    def set_steal_ns(self, ns: int) -> None:
        """Lower the writer-lock steal bound (process-wide; tests)."""
        self._lib.dt_set_steal_ns(ns)

    def _test_wedge(self, ip: str) -> None:
        key = _key(ip)
        self._lib.dt_test_wedge_slot(self._base, key, len(key))

    def _test_unwedge(self, ip: str) -> None:
        key = _key(ip)
        self._lib.dt_test_unwedge_slot(self._base, key, len(key))

    def close(self) -> None:
        """Unmap this process's view; later calls read as a closed table."""
        if self._base is None:
            return
        self._base = None
        self._shm.close()

    def unlink(self) -> None:
        if self.owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass


def create_decision_table(capacity: int = 65536) -> DecisionTable:
    """The table; raises when the library cannot be built or the table
    cannot be mapped."""
    return DecisionTable(capacity=capacity)
