"""The SPSC shared-memory frame ring of the fabric's co-located shards
(port of `banjax_tpu/native/shmring.py`, over the port's copy of
`shmring.c`).

Co-located fabric shards exchange wire frames through a pair of these
rings (one a direction) instead of loopback TCP, when
`fabric_shm_enabled` is set (`fabric/peer.py` LinePipe). The segment
layout is the JAX package's (a 64-byte header: magic, size, head, tail,
the two futex words), so either package can attach the other's ring.

The C source is compiled with `cc` at first use into `build/native/`
(`matcher/kernels/_build.HostLibrary`, keyed by the source's content).
Where the JAX package falls back to a pure-Python polling ring, or
declines an attach and stays on TCP, the port raises `ShmRingError`: a
shard configured for the shm transport gets it or fails loudly.

A ring moves bytes; framing stays `fabric/wire.py`'s (4-byte length,
1-byte type). Writes are all-or-nothing per frame, so a reader that sees
a header is guaranteed the body is already in the ring: a mid-frame
stall can only come from a wedged or dead peer, and surfaces as
FrameError exactly like the TCP path.
"""

from __future__ import annotations

import ctypes
import struct
from multiprocessing import shared_memory
from typing import Optional, Tuple

from banjax_tpu_torch.fabric import wire
from banjax_tpu_torch.matcher.kernels._build import HostLibrary

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_u8p = ctypes.POINTER(ctypes.c_uint8)

SHMRING = HostLibrary("shmring", "shmring.c", {
    "ring_init": (_I64, (_VP, _I64)),
    "ring_check": (_I64, (_VP,)),
    "ring_readable": (_I64, (_VP,)),
    "ring_write": (_I64, (_VP, _u8p, _I64, _I64)),
    "ring_read": (_I64, (_VP, _u8p, _I64, _I64)),
})

RING_HEADER = 64


ShmRingError = wire.ShmRingError


class RingTimeout(OSError):
    """The ring did not make progress within the timeout: a wedged or
    dead peer (the writer side's fast-fail signal)."""


def ensure_built() -> ctypes.CDLL:
    """The ring's library, built at first use; ShmRingError when it
    cannot be built or loaded."""
    try:
        return SHMRING.lib()
    except Exception as e:  # noqa: BLE001 — re-raised as the ring's own error
        raise ShmRingError(f"the shm ring library cannot be built or loaded: {e}") from e


class ShmRing:
    """One direction of a co-located peer link: a single producer and a
    single consumer over one shared-memory segment. `name=None` creates
    (and later unlinks) the segment; passing a name attaches."""

    def __init__(self, name: Optional[str] = None, capacity: int = 1 << 20):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError(f"ring capacity must be a power of two: {capacity}")
        self._lib = ensure_built()
        try:
            if name is None:
                self._shm = shared_memory.SharedMemory(create=True, size=RING_HEADER + capacity)
                self.owner = True
            else:
                self._shm = shared_memory.SharedMemory(name=name)
                self.owner = False
                # an attaching process must not register the segment with
                # its resource tracker, which would unlink it at exit
                from multiprocessing import resource_tracker

                resource_tracker.unregister(self._shm._name, "shared_memory")
        except OSError as e:
            raise ShmRingError(f"shm ring segment {name or '(new)'} cannot be mapped: {e}") from e
        tmp = (ctypes.c_char * 1).from_buffer(self._shm.buf)
        self._base_ptr = ctypes.c_void_p(ctypes.addressof(tmp))
        del tmp
        if self.owner:
            if self._lib.ring_init(self._base_ptr, capacity) != 0:
                self.close()
                raise ValueError(f"bad ring capacity {capacity}")
            self.capacity = capacity
        else:
            cap = self._lib.ring_check(self._base_ptr)
            if cap < 0:
                self.close()
                raise ShmRingError(f"shm segment {name} is not a fabric ring")
            self.capacity = int(cap)

    @property
    def name(self) -> str:
        return self._shm.name

    def write(self, data: bytes, timeout_s: float) -> None:
        """All-or-nothing write; RingTimeout if the frame never fits (a
        stalled consumer), FrameError if it can never fit."""
        if len(data) > self.capacity:
            raise wire.FrameError(
                f"frame of {len(data)} bytes exceeds ring capacity {self.capacity}")
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        rc = self._lib.ring_write(self._base_ptr, buf, len(data), int(timeout_s * 1000))
        if rc == -1:
            raise RingTimeout(f"ring write stalled for {timeout_s:.3f}s "
                              f"({self.readable()}/{self.capacity} bytes unread)")
        if rc != 0:
            raise wire.FrameError(f"ring write failed (rc={rc})")

    def read(self, n: int, timeout_s: float) -> Optional[bytes]:
        """Exactly n bytes, or None on timeout (nothing consumed)."""
        buf = (ctypes.c_uint8 * n)()
        rc = self._lib.ring_read(self._base_ptr, buf, n, int(timeout_s * 1000))
        if rc == -1:
            return None
        if rc != 0:
            raise wire.FrameError(f"ring read failed (rc={rc})")
        return bytes(buf)

    def readable(self) -> int:
        return int(self._lib.ring_readable(self._base_ptr))

    def occupancy(self) -> float:
        """Fraction of the ring holding unread bytes (the shm-ring
        occupancy gauge)."""
        return min(1.0, self.readable() / float(self.capacity))

    def close(self) -> None:
        try:
            self._base_ptr = None
            self._shm.close()
        except (OSError, BufferError):
            pass
        if self.owner:
            try:
                self._shm.unlink()
            except OSError:
                pass


_FRAME_HEADER = struct.Struct("!IB")


def write_frame(ring: ShmRing, frame: bytes, timeout_s: float) -> None:
    """One whole wire frame, atomically (all-or-nothing)."""
    ring.write(frame, timeout_s)


def read_frame(ring: ShmRing, idle_timeout_s: float) -> Optional[Tuple[int, bytes]]:
    """(ftype, body), or None if no frame started within the idle
    timeout. Writes are whole-frame atomic, so a visible header
    guarantees the body; a missing body is a corrupt ring."""
    header = ring.read(_FRAME_HEADER.size, idle_timeout_s)
    if header is None:
        return None
    length, ftype = _FRAME_HEADER.unpack(header)
    if length < 1 or length > wire.MAX_FRAME_BYTES:
        raise wire.FrameError(f"bad ring frame length {length}")
    body = ring.read(length - 1, 2.0) if length > 1 else b""
    if body is None:
        raise wire.FrameError(f"ring frame torn: header promised {length - 1} body bytes")
    return ftype, body
