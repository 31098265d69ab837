"""Challenge-plane run counters.

The counters of `banjax_tpu/challenge/stats.py`, process-wide: the
issuer, the verifier and the bounded failure state publish here. The
verification-batch-size histogram is a plain count per bucket; the
Prometheus exposition around these counters is not ported yet.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Tuple

# device dispatch sizes are small powers of two up to the queue bound
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


class ChallengeStats:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def note_issued(self, n: int = 1) -> None:
        with self._lock:
            self.issued_total += n

    def note_verification(self, result: str, path: str, n: int = 1) -> None:
        """result in {"accept", "reject"}; path in {"cpu", "device"}:
        where the zero-bit count ran (wire-check rejects are "cpu")."""
        key = (result, path)
        with self._lock:
            self.verifications[key] = self.verifications.get(key, 0) + n

    def note_device_batch(self, size: int) -> None:
        """One verifier dispatch of `size` lanes, counted in the first
        bucket >= size (the last bucket also takes anything larger)."""
        k = min(bisect.bisect_left(BATCH_SIZE_BUCKETS, size), len(BATCH_SIZE_BUCKETS) - 1)
        with self._lock:
            self.batch_size_counts[k] += 1

    def note_failure_state(self, entries: int, evictions_total: int) -> None:
        with self._lock:
            self.failure_state_entries = int(entries)
            self.failure_evictions_total = int(evictions_total)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "issued_total": self.issued_total,
                "verifications": {f"{r}/{p}": n for (r, p), n in sorted(self.verifications.items())},
                "batch_size_counts": dict(zip(BATCH_SIZE_BUCKETS, self.batch_size_counts)),
                "failure_state_entries": self.failure_state_entries,
                "failure_evictions_total": self.failure_evictions_total,
            }

    def reset(self) -> None:
        with self._lock:
            self.issued_total = 0
            self.verifications: Dict[Tuple[str, str], int] = {}
            self.batch_size_counts = [0] * len(BATCH_SIZE_BUCKETS)
            self.failure_state_entries = 0
            self.failure_evictions_total = 0


_stats = ChallengeStats()


def get_stats() -> ChallengeStats:
    return _stats
