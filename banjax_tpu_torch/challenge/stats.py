"""Challenge-plane run counters.

The counters of `banjax_tpu/challenge/stats.py`, process-wide: the
issuer, the verifier and the bounded failure state publish here. The
verification batch sizes go into the registry histogram that
`banjax_challenge_verify_batch_size` renders; `prom_snapshot` and
`active` are the JAX exposition's views.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from banjax_tpu_torch.obs.registry import Histogram

# device dispatch sizes are small powers of two up to the queue bound
BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0, 1024.0)


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
        """One verifier dispatch of `size` lanes."""
        self.verify_batch_size.observe(float(size))

    def note_failure_state(self, entries: int, evictions_total: int) -> None:
        with self._lock:
            self.failure_state_entries = int(entries)
            self.failure_evictions_total = int(evictions_total)

    def snapshot(self) -> dict:
        """The counters, with the dispatches per batch-size bucket (the
        first bucket >= the size; the last also takes anything larger)."""
        _, cum, _, _ = self.verify_batch_size.snapshot()
        per = [c - p for c, p in zip(cum, [0] + cum[:-1])]
        above = per.pop()  # the +Inf bucket
        per[-1] += above
        with self._lock:
            return {
                "issued_total": self.issued_total,
                "verifications": {f"{r}/{p}": n for (r, p), n in sorted(self.verifications.items())},
                "batch_size_counts": dict(zip((int(b) for b in BATCH_SIZE_BUCKETS), per)),
                "failure_state_entries": self.failure_state_entries,
                "failure_evictions_total": self.failure_evictions_total,
            }

    def prom_snapshot(self) -> dict:
        with self._lock:
            verifications = dict(self.verifications)
            return {
                "issued_total": self.issued_total,
                "verifications": verifications,
                "verifications_total": sum(verifications.values()),
                "failure_state_entries": self.failure_state_entries,
                "failure_evictions_total": self.failure_evictions_total,
            }

    def active(self) -> bool:
        """True once anything challenge-shaped happened in this process
        (the render gate: idle scrapes stay challenge-free)."""
        with self._lock:
            return bool(
                self.issued_total or self.verifications
                or self.failure_state_entries or self.failure_evictions_total
            )

    def reset(self) -> None:
        with self._lock:
            self.issued_total = 0
            self.verifications: Dict[Tuple[str, str], int] = {}
            self.verify_batch_size = Histogram(BATCH_SIZE_BUCKETS)
            self.failure_state_entries = 0
            self.failure_evictions_total = 0


_stats = ChallengeStats()


def get_stats() -> ChallengeStats:
    return _stats
