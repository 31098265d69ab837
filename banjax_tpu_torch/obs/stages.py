"""Host seconds by stage of the matcher's batch path.

`StageClock` is called as a context manager around a stage; time spent
in a stage nested inside another counts to the inner one only, so the
stages partition the host time they cover. Two `perf_counter` reads a
stage: it stays on, at a cost of a few microseconds a chunk. Each thread
keeps its own stage stack, so the pipeline's stage threads can share one
matcher's clock: `seconds` sums a stage over every thread, `by_thread`
keeps it per thread name.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict


class StageClock:
    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.by_thread: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
        self._lock = threading.Lock()
        self._local = threading.local()

    def _add(self, stage: str, dt: float) -> None:
        with self._lock:
            self.seconds[stage] += dt
            self.by_thread[threading.current_thread().name][stage] += dt

    @contextlib.contextmanager
    def __call__(self, name: str):
        loc = self._local
        stack = getattr(loc, "stack", None)
        if stack is None:
            stack = loc.stack = []
        now = time.perf_counter()
        if stack:
            self._add(stack[-1], now - loc.t)
        stack.append(name)
        loc.t = now
        try:
            yield
        finally:
            now = time.perf_counter()
            self._add(stack.pop(), now - loc.t)
            loc.t = now

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
            self.by_thread.clear()
