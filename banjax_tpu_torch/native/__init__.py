"""The native host tier: batch parse + byte-class encode (port of
`banjax_tpu/native/__init__.py`, over the port's copy `fastparse.c`).

The C source is compiled with `cc -O3 -shared -fPIC` at first use into
`build/native/` (`matcher/kernels/_build.HostLibrary`, keyed by the
source's content) and loaded with ctypes. Where the JAX package degrades
to the Python parse when the library is missing, the port raises: a
matcher configured for the native parse gets it or fails to start.

Semantics are those of `matcher/encode.parse_line` line for line: the C
side sets FLAG_DEFER on any line it cannot prove it parses identically
(unusual timestamp spellings), and the caller re-parses exactly those
lines in Python. A batch whose lines hold an embedded newline cannot be
split into spans at all; `parse_encode_batch` returns None for it and the
caller parses that batch in Python — input semantics, like FLAG_DEFER.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional

import numpy as np

from banjax_tpu_torch.matcher.kernels._build import HostLibrary

FLAG_ERROR = 1
FLAG_OLD = 2
FLAG_DEFER = 4
FLAG_HOST_EVAL = 8

_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)

FASTPARSE = HostLibrary("fastparse", "fastparse.c", {
    "fp_split_lines": (_I64, (_u8p, _I64, _i64p, _i64p, _I64)),
    "fp_parse_encode": (_I64, (
        _u8p, _I64, _i64p, _i64p, _I64, _i32p, _I32, ctypes.c_double,
        ctypes.c_double, _i64p, _u8p, _i64p, _i32p, _i64p, _i32p, _i64p,
        _i32p, _i32p, _i32p,
    )),
    "fp_dedup_spans": (_I64, (
        _u8p, _I64, _i64p, _i32p, _I64, _i64p, _I64, _i64p, _i64p,
    )),
})


def libraries() -> List[HostLibrary]:
    """The host libraries: the matcher's host tier (parse, slot manager,
    warm tier), the serving fast path's decision table and the fabric's
    shm ring."""
    from banjax_tpu_torch.native import decisiontable, shm, shmring, slotmgr

    return [FASTPARSE, slotmgr.SLOTMGR, shm.SHMSTATE, decisiontable.DECISIONTABLE,
            shmring.SHMRING]


def _P(a: np.ndarray, t):
    return a.ctypes.data_as(t)


class ParsedBatch:
    """Column-oriented result of one native parse+encode pass.

    String fields stay as (offset, length) spans into the blob; `.ip(i)`,
    `.host(i)`, `.rest(i)` materialize Python strings lazily."""

    __slots__ = (
        "blob", "n", "ts_ns", "flags", "ip_off", "ip_len",
        "host_off", "host_len", "rest_off", "rest_len", "cls_ids", "lens",
        "_text",
    )

    def __init__(self, blob, n, ts_ns, flags, ip_off, ip_len, host_off,
                 host_len, rest_off, rest_len, cls_ids, lens):
        self.blob = blob
        self.n = n
        self.ts_ns = ts_ns
        self.flags = flags
        self.ip_off, self.ip_len = ip_off, ip_len
        self.host_off, self.host_len = host_off, host_len
        self.rest_off, self.rest_len = rest_off, rest_len
        self.cls_ids = cls_ids  # int32 [n, max_len], zero past each length
        self.lens = lens
        self._text = False  # False = not computed; None = non-ASCII blob

    def text(self):
        """The whole blob as one str when it is pure ASCII (byte offsets
        are then str offsets), else None. Decoded once, cached."""
        if self._text is False:
            self._text = self.blob.decode("ascii") if self.blob.isascii() else None
        return self._text

    def _span(self, off, ln, i) -> str:
        o = int(off[i])
        return self.blob[o : o + int(ln[i])].decode("utf-8", "surrogatepass")

    def ip(self, i: int) -> str:
        return self._span(self.ip_off, self.ip_len, i)

    def host(self, i: int) -> str:
        return self._span(self.host_off, self.host_len, i)

    def rest(self, i: int) -> str:
        return self._span(self.rest_off, self.rest_len, i)


class ParseScratch:
    """Reusable output buffers for parse_encode_batch (plain host memory).

    The returned ParsedBatch views alias the scratch: they are valid until
    the next parse with the same scratch. TorchMatcher's synchronous path
    consumes each batch before it parses the next, and every transfer to
    the card starts from a copy (`prefilter._assemble`), so no copy in
    flight reads a buffer the next parse overwrites. The pipeline's split
    path, which has batches in flight, parses without a scratch (fresh
    buffers a batch)."""

    def __init__(self):
        self.cap = 0
        self.max_len = 0

    def ensure(self, n: int, max_len: int) -> None:
        if n <= self.cap and max_len == self.max_len:
            return
        cap = max(n, self.cap, 1024)
        self.cap, self.max_len = cap, max_len
        self.starts = np.empty(cap, dtype=np.int64)
        self.ends = np.empty(cap, dtype=np.int64)
        self.ts_ns = np.empty(cap, dtype=np.int64)
        self.flags = np.empty(cap, dtype=np.uint8)
        self.ip_off = np.empty(cap, dtype=np.int64)
        self.ip_len = np.empty(cap, dtype=np.int32)
        self.host_off = np.empty(cap, dtype=np.int64)
        self.host_len = np.empty(cap, dtype=np.int32)
        self.rest_off = np.empty(cap, dtype=np.int64)
        self.rest_len = np.empty(cap, dtype=np.int32)
        self.cls_ids = np.empty((cap, max_len), dtype=np.int32)
        self.lens = np.empty(cap, dtype=np.int32)


# fp_parse_encode is row-parallel and ctypes releases the GIL, so a large
# batch splits its row range across a few threads
_PARSE_THREADS = min(4, os.cpu_count() or 1)
_MIN_ROWS_PER_THREAD = 4096


def parse_encode_batch(
    lines, byte_to_class: np.ndarray, max_len: int,
    now_unix: float, old_cutoff: float,
    scratch: Optional[ParseScratch] = None,
    max_threads: Optional[int] = None,
) -> Optional[ParsedBatch]:
    """One native pass over a batch of log lines: the splits, timestamp,
    staleness and host-eval routing of parse_line, plus the byte-class
    encode of each `rest`. None when a line holds an embedded newline
    (the caller parses that batch in Python). Raises when the library
    cannot be built or loaded. With `scratch`, outputs alias it.
    `max_threads` caps the row-parallel fan-out (the sharded encode's
    shards pass 1: they are already one thread each)."""
    lib = FASTPARSE.lib()
    blob = "\n".join(lines).encode("utf-8", "surrogatepass")
    n = len(lines)
    buf = np.frombuffer(blob, dtype=np.uint8)
    if n == 0:
        e64 = np.zeros(0, dtype=np.int64)
        e32 = np.zeros(0, dtype=np.int32)
        return ParsedBatch(blob, 0, e64, np.zeros(0, np.uint8), e64, e32, e64,
                           e32, e64, e32, np.zeros((0, max_len), np.int32), e32)

    s = scratch if scratch is not None else ParseScratch()
    s.ensure(n, max_len)
    starts, ends = s.starts[:n], s.ends[:n]
    blob_ptr = buf.ctypes.data_as(_u8p) if buf.size else ctypes.cast(
        ctypes.c_char_p(b""), _u8p
    )
    got = lib.fp_split_lines(blob_ptr, len(blob), _P(starts, _i64p), _P(ends, _i64p), n)
    # an embedded newline makes the capped split stop short of the blob's
    # end (or, trailing, return n-1 lines): every later span would shift
    if got != n or int(ends[n - 1]) != len(blob):
        return None

    table = np.ascontiguousarray(byte_to_class[:256], dtype=np.int32)

    def run_range(i0: int, cnt: int) -> None:
        lib.fp_parse_encode(
            blob_ptr, len(blob),
            _P(s.starts[i0:], _i64p), _P(s.ends[i0:], _i64p), cnt,
            _P(table, _i32p), max_len, now_unix, old_cutoff,
            _P(s.ts_ns[i0:], _i64p), _P(s.flags[i0:], _u8p),
            _P(s.ip_off[i0:], _i64p), _P(s.ip_len[i0:], _i32p),
            _P(s.host_off[i0:], _i64p), _P(s.host_len[i0:], _i32p),
            _P(s.rest_off[i0:], _i64p), _P(s.rest_len[i0:], _i32p),
            _P(s.cls_ids[i0:], _i32p), _P(s.lens[i0:], _i32p),
        )

    limit = _PARSE_THREADS if max_threads is None else max(1, max_threads)
    nt = min(limit, max(1, n // _MIN_ROWS_PER_THREAD))
    if nt <= 1:
        run_range(0, n)
    else:
        bounds = [n * t // nt for t in range(nt + 1)]
        threads = [
            threading.Thread(target=run_range, args=(bounds[t], bounds[t + 1] - bounds[t]))
            for t in range(1, nt)
        ]
        for t in threads:
            t.start()
        run_range(bounds[0], bounds[1] - bounds[0])
        for t in threads:
            t.join()

    return ParsedBatch(blob, n, s.ts_ns[:n], s.flags[:n], s.ip_off[:n],
                       s.ip_len[:n], s.host_off[:n], s.host_len[:n],
                       s.rest_off[:n], s.rest_len[:n], s.cls_ids[:n], s.lens[:n])


class DedupScratch:
    """Reusable hash-table + output buffers for dedup_spans."""

    def __init__(self):
        self.cap = 0

    def ensure(self, n: int) -> None:
        if n <= self.cap:
            return
        cap = max(n, 1024)
        self.cap = cap
        tcap = 1
        while tcap < 2 * cap:
            tcap <<= 1
        self.table = np.empty(tcap, dtype=np.int64)
        self.ids = np.empty(cap, dtype=np.int64)
        self.first = np.empty(cap, dtype=np.int64)


def dedup_spans(blob, offs, lens, scratch: Optional[DedupScratch] = None):
    """(ids [n] in first-appearance order, first_rows [n_uniq]) for byte
    spans of `blob`: the C open-addressing dedup."""
    lib = FASTPARSE.lib()
    n = len(offs)
    s = scratch if scratch is not None else DedupScratch()
    s.ensure(n)
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    buf = np.frombuffer(blob, dtype=np.uint8)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    n_uniq = lib.fp_dedup_spans(
        _P(buf, _u8p), len(blob), _P(offs, _i64p), _P(lens, _i32p), n,
        _P(s.table, _i64p), len(s.table), _P(s.ids, _i64p), _P(s.first, _i64p),
    )
    # copies, not views: the gate dedups ip then host spans with one
    # scratch, and the second call must not clobber the first's result
    return s.ids[:n].copy(), s.first[:n_uniq].copy()
