"""Consistent-hash ring over the IP keyspace.

(A copy of `banjax_tpu/fabric/hashring.py`.)

Each node contributes `vnodes` points on a 64-bit ring; an IP is owned
by the first ALIVE point clockwise from its hash.  Excluding a dead
node from the alive set makes its ranges fall to the next alive points
automatically — takeover needs no explicit reassignment table, and a
rejoined node reclaims exactly its old ranges (the ring is a pure
function of the node-id set).

blake2b keeps placement identical across processes and Python runs
(`hash()` is salted per-process and useless here).
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple


def _h64(key: str) -> int:
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


class ConsistentHashRing:
    """Deterministic vnode ring.  Immutable after construction; alive
    sets are passed per-lookup so every caller (a feeder, each shard)
    converges on the same ownership from the same membership view."""

    def __init__(self, node_ids: Iterable[str], vnodes: int = 64):
        self.node_ids: Tuple[str, ...] = tuple(sorted(set(node_ids)))
        if not self.node_ids:
            raise ValueError("ring needs at least one node")
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = int(vnodes)
        points: List[Tuple[int, str]] = []
        for nid in self.node_ids:
            for v in range(self.vnodes):
                points.append((_h64(f"{nid}#{v}"), nid))
        points.sort()
        self._points = points
        self._hashes = [p[0] for p in points]

    def owner(self, key: str, alive: Optional[Set[str]] = None) -> str:
        """First alive node clockwise from hash(key)."""
        if alive is None:
            live = self.node_ids
        else:
            live = tuple(n for n in self.node_ids if n in alive)
            if not live:
                raise ValueError("no alive nodes in ring")
        h = _h64(key)
        start = bisect.bisect_right(self._hashes, h)
        n = len(self._points)
        for off in range(n):
            nid = self._points[(start + off) % n][1]
            if alive is None or nid in alive:
                return nid
        return live[0]  # unreachable: live is non-empty

    def partition(
        self, keys: Sequence[str], alive: Optional[Set[str]] = None
    ) -> Dict[str, List[int]]:
        """Indices of `keys` grouped by owning node."""
        out: Dict[str, List[int]] = {}
        for i, k in enumerate(keys):
            out.setdefault(self.owner(k, alive), []).append(i)
        return out

    def ownership_fractions(
        self, alive: Optional[Set[str]] = None, samples: int = 4096
    ) -> Dict[str, float]:
        """Sampled keyspace share per node — introspection only
        (fabric.json, /metrics), never used for routing."""
        counts: Dict[str, int] = {}
        for i in range(samples):
            nid = self.owner(f"sample-{i}", alive)
            counts[nid] = counts.get(nid, 0) + 1
        return {n: c / samples for n, c in sorted(counts.items())}
