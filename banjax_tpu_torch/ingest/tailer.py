"""Log tailer: follow the nginx access log from its end and feed the
matcher (a copy of `banjax_tpu/ingest/tailer.py`).

Reference behavior (Go banjax): internal/regex_rate_limiter.go:21-78 —
tail `server_log_file` from the end (retrying until the file exists) and
hand each line to the matcher with the latest config snapshot.

A poll follower (50 ms idle sleep): on an inode change it drains the old
file to its end (bytes appended between the last read and the rotation
live only there), delivers the old file's unterminated last line, and
reopens the new file from its start; on truncation it reopens from the
start. Opening retries with the shared capped, jittered backoff; the
health component beats every poll. Reads are bounded
(`READ_CHUNK_BYTES`), and `on_lines` may block: unread bytes wait in the
file.

One deliberate difference from the JAX tailer, which logs and swallows
any error of `on_lines`: the port's tailer stays alive too, but counts
each failed batch in `errors`, keeps the last exception in `last_error`
and sets its health to failed, so a matcher or kernel fault on the card
is never silent. The `tailer.open` failpoint fires at every open (the
first and each reopen); its `FaultInjected` is an OSError, so it takes
the same retry path as a missing file, and `open_faults` counts it.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Callable, List, Optional

from banjax_tpu_torch.resilience import failpoints
from banjax_tpu_torch.resilience.backoff import Backoff, reconnect_backoff
from banjax_tpu_torch.resilience.health import ComponentHealth

log = logging.getLogger(__name__)

RETRY_SECONDS = 5  # regex_rate_limiter.go:47 — the backoff's cap
POLL_SECONDS = 0.05
# one read's upper bound, so a backlog after a stall arrives as bounded batches
READ_CHUNK_BYTES = 4 << 20


class LogTailer:
    """Calls `on_lines(batch)` with the complete lines of every read."""

    def __init__(self, path: str, on_lines: Callable[[List[str]], None],
                 backoff: Optional[Backoff] = None,
                 health: Optional[ComponentHealth] = None):
        self.path = path
        self.on_lines = on_lines
        self.backoff = backoff or reconnect_backoff(cap=RETRY_SECONDS, base=0.25)
        self.health = health
        # set once the file is open and followed (set again after each reopen)
        self.opened = threading.Event()
        # batches whose on_lines raised, and the last exception
        self.errors = 0
        self.last_error: Optional[BaseException] = None
        # lines handed to on_lines without an error (tests wait on it)
        self.lines_delivered = 0
        # opens the tailer.open failpoint failed
        self.open_faults = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="log-tailer", daemon=True)
        self._thread.start()

    def stop(self) -> bool:
        """Stop following; False when the thread is still inside on_lines
        after the join's timeout."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            return not self._thread.is_alive()
        return True

    def _open(self, at_end: bool):
        try:
            failpoints.check("tailer.open")
        except failpoints.FaultInjected:
            self.open_faults += 1
            raise
        f = open(self.path, "r", encoding="utf-8", errors="replace")
        if at_end:
            f.seek(0, os.SEEK_END)
        return f

    def _deliver(self, buffer: str) -> str:
        """Hand every complete line of `buffer` to on_lines (one split, not a
        split per line); returns the trailing partial line."""
        parts = buffer.split("\n")
        rest = parts.pop()
        batch: List[str] = [line for line in parts if line]
        if batch:
            try:
                self.on_lines(batch)
                self.lines_delivered += len(batch)
            except Exception as e:  # noqa: BLE001 — counted and reported; the tailer lives on
                log.exception("error consuming a batch of %d log lines", len(batch))
                if self.health is not None:
                    self.health.failed(f"on_lines raised {type(e).__name__}: {e}")
                self.last_error = e
                self.errors += 1
        return rest

    def _run(self) -> None:
        f = None
        at_end = True  # the first open seeks to the end; a reopen starts at 0
        inode = 0
        buffer = ""
        try:
            while not self._stop.is_set():
                if f is None:
                    # retry until open (regex_rate_limiter.go:30-51), for the
                    # first start and for a reopen after rotation alike
                    try:
                        f = self._open(at_end=at_end)
                        inode = os.fstat(f.fileno()).st_ino
                        buffer = ""
                        self.backoff.reset()
                        self.opened.set()
                        log.info("log tailer started on %s", self.path)
                        if self.health is not None and not self.errors:
                            self.health.ok()
                    except OSError as e:
                        log.info("log tailer failed to start. waiting a bit and trying again.")
                        if self.health is not None:
                            self.health.degraded(f"waiting for {self.path}: {e}")
                        if self.backoff.wait(self._stop):
                            return
                        continue

                if self.health is not None:
                    self.health.beat()
                chunk = f.read(READ_CHUNK_BYTES)
                if chunk:
                    buffer = self._deliver(buffer + chunk)
                    continue

                # idle: look for a rotation or a truncation
                try:
                    st = os.stat(self.path)
                    pos = f.tell()
                    if st.st_ino != inode or st.st_size < pos:
                        rotated = st.st_ino != inode
                        # drain the old file before closing it
                        while True:
                            tail = f.read(READ_CHUNK_BYTES)
                            if not tail:
                                break
                            buffer = self._deliver(buffer + tail)
                        if rotated and buffer:
                            # the old file is final: its unterminated last
                            # line is still a line
                            self._deliver(buffer + "\n")
                        log.info("log file rotated/truncated; reopening")
                        buffer = ""
                        f.close()
                        f = None
                        at_end = False
                        continue
                except OSError:
                    pass
                self._stop.wait(POLL_SECONDS)
        finally:
            if f is not None:
                f.close()
