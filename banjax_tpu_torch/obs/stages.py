"""Host seconds by stage of the matcher's batch path.

`StageClock` is called as a context manager around a stage; time spent
in a stage nested inside another counts to the inner one only, so the
stages partition the host time they cover. Two `perf_counter` reads a
stage: it stays on, at a cost of a few microseconds a chunk. One clock
belongs to one matcher, whose batches run one at a time.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List


class StageClock:
    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self._stack: List[str] = []
        self._t = 0.0

    @contextlib.contextmanager
    def __call__(self, name: str):
        now = time.perf_counter()
        if self._stack:
            self.seconds[self._stack[-1]] += now - self._t
        self._stack.append(name)
        self._t = now
        try:
            yield
        finally:
            now = time.perf_counter()
            self.seconds[self._stack.pop()] += now - self._t
            self._t = now

    def reset(self) -> None:
        self.seconds.clear()
