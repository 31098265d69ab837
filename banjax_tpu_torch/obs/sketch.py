"""The host-side IP hashes of the traffic sketch.

Copies of `hash_ip`, `_fmix32_np` and `_CM_SEEDS` from
`banjax_tpu/obs/sketch.py`: the bounded failed-challenge state
(`challenge/failures.py`) keys its count-min gate and its spill
fingerprints on them. The device sketch itself is not ported yet.
"""

from __future__ import annotations

import zlib

import numpy as np

# xor seeds decorrelating the count-min rows (any fixed distinct values
# work: the row hash is fmix32(ip_hash ^ seed_j))
_CM_SEEDS = (0x0000_0000, 0x7F4A_7C15, 0x94D0_49BB, 0xDE82_4AD5,
             0x1B87_3593, 0xC2B2_AE35, 0x27D4_EB2F, 0x1656_67B1)


def _fmix32_np(h: np.ndarray) -> np.ndarray:
    """murmur3 finalizer, numpy uint32."""
    h = h.astype(np.uint32, copy=True)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EB_CA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2_AE35)
    h ^= h >> np.uint32(16)
    return h


def hash_ip(ip: str) -> int:
    """The 32-bit base hash of one client-IP string (crc32 of the utf-8
    bytes); every derived hash mixes from this value."""
    return zlib.crc32(ip.encode("utf-8", "surrogatepass")) & 0xFFFF_FFFF
