/* fastparse.c — native batch parse + byte-class encode for the log tailer
 * hot path (the port's copy of banjax_tpu/native/fastparse.c).
 *
 * One call scans a newline-joined blob of access-log lines and, per line,
 * performs exactly the splits of banjax_tpu_torch/matcher/encode.py:parse_line
 * (itself the port of the reference's consumeLine splits,
 * internal/regex_rate_limiter.go:126-157):
 *
 *   "<epoch.frac> <ip> <rest>"  with  rest = "<method> <host> <rest2>"
 *
 * plus the staleness check, the ASCII/length host_eval routing, and the
 * byte->class encoding of `rest` for the device NFA — everything between
 * "line arrives" and "device batch" that Python does per line, at memory
 * speed instead of interpreter speed.
 *
 * Exactness contract: timestamps whose text a C strtod round-trip cannot
 * be proven to parse identically to Python float() (underscores, inf/nan
 * spellings, hex floats, out-of-int64 magnitudes) set FLAG_DEFER and the
 * caller re-parses that line with the Python reference path, so observable
 * semantics are bit-identical for every input.
 *
 * Pure C ABI (no Python.h): loaded with ctypes, outputs written into
 * caller-allocated numpy buffers.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define FLAG_ERROR 1u     /* parse error (reference: error=true) */
#define FLAG_OLD 2u       /* stale line (> cutoff seconds old)   */
#define FLAG_DEFER 4u     /* caller must re-parse with Python    */
#define FLAG_HOST_EVAL 8u /* rest too long / non-ASCII: host re  */

/* Python float() accepts ASCII digits, one '.', exponent, sign; it also
 * accepts "_" digit separators and inf/nan words — those (and anything
 * else unusual) defer to the Python parser. Returns 1 if the span is a
 * plain decimal/exponent float strtod parses identically. */
static int plain_float_span(const uint8_t *s, int64_t n) {
    if (n <= 0 || n > 64)
        return 0;
    int64_t i = 0;
    if (s[i] == '+' || s[i] == '-')
        i++;
    int digits = 0, dot = 0, exp = 0;
    for (; i < n; i++) {
        uint8_t c = s[i];
        if (c >= '0' && c <= '9') {
            digits++;
        } else if (c == '.') {
            if (dot || exp)
                return 0;
            dot = 1;
        } else if (c == 'e' || c == 'E') {
            if (exp || !digits)
                return 0;
            exp = 1;
            if (i + 1 < n && (s[i + 1] == '+' || s[i + 1] == '-'))
                i++;
            if (i + 1 >= n)
                return 0;
        } else {
            return 0;
        }
    }
    return digits > 0;
}

/* Fast path for the overwhelmingly common timestamp shape
 * "digits[.digits]": exact int64 mantissa m and exact power of ten give a
 * single correctly-rounded division, which equals glibc's correctly-
 * rounded strtod — so the result is bit-identical to the slow path (and
 * therefore to Python float()) whenever this returns 1. Anything else
 * (sign, exponent, > 2^53 mantissa, > 18 fraction digits) falls back. */
static int fast_ts(const uint8_t *s, int64_t n, double *out) {
    static const double p10[] = {1,    1e1,  1e2,  1e3,  1e4,  1e5,  1e6,
                                 1e7,  1e8,  1e9,  1e10, 1e11, 1e12, 1e13,
                                 1e14, 1e15, 1e16, 1e17, 1e18};
    int64_t m = 0;
    int fd = 0, seen_dot = 0, digits = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t c = s[i];
        if (c >= '0' && c <= '9') {
            if (m >= (int64_t)922337203685477580LL) /* next *10 overflows */
                return 0;
            m = m * 10 + (c - '0');
            digits++;
            if (seen_dot)
                fd++;
        } else if (c == '.' && !seen_dot) {
            seen_dot = 1;
        } else {
            return 0;
        }
    }
    if (!digits || fd > 18)
        return 0;
    if (m > ((int64_t)1 << 53)) /* (double)m no longer exact */
        return 0;
    *out = (double)m / p10[fd];
    return 1;
}

/* One parsed line record; offsets index into the blob. */
typedef struct {
    int64_t ts_ns;
    int64_t ip_off, host_off, rest_off;
    int32_t ip_len, host_len, rest_len;
    uint8_t flags;
} line_rec;

/* Scan blob for newline-separated lines (no trailing newline required).
 * Returns the number of lines found (<= max_lines). */
int64_t fp_split_lines(const uint8_t *blob, int64_t blob_len,
                       int64_t *starts, int64_t *ends, int64_t max_lines) {
    int64_t n = 0, pos = 0;
    while (pos <= blob_len && n < max_lines) {
        const uint8_t *nl = memchr(blob + pos, '\n', (size_t)(blob_len - pos));
        int64_t end = nl ? (int64_t)(nl - blob) : blob_len;
        starts[n] = pos;
        ends[n] = end;
        n++;
        if (!nl)
            break;
        pos = end + 1;
        if (pos == blob_len) /* trailing newline: no empty final line */
            break;
    }
    return n;
}

/* FNV-1a over one span. */
static uint64_t span_hash(const uint8_t *p, int64_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (int64_t i = 0; i < n; i++) {
        h ^= p[i];
        h *= 1099511628211ULL;
    }
    return h;
}

/* Deduplicate (offset, length) spans into first-appearance-ordered ids.
 *
 * Replaces the hot path's numpy window-gather + sort-based unique: at 65k
 * spans the open-addressing probe runs in ~3 ms where the vectorized sort
 * took ~60 ms, and the output ids are already in first-appearance order
 * (the order the per-line reference loop assigns window slots in — a
 * parity surface, see matcher/workset.py).
 *
 * ids_out[n]: 0-based unique id per span. first_out[<=n]: the first span
 * index carrying each id, in id order. table/table_cap: caller-allocated
 * scratch of int64, table_cap a power of two >= 2n, primed to -1 by this
 * function. Returns the unique count. */
int64_t fp_dedup_spans(
    const uint8_t *blob, int64_t blob_len,
    const int64_t *offs, const int32_t *lens, int64_t n,
    int64_t *table, int64_t table_cap,
    int64_t *ids_out, int64_t *first_out) {
    (void)blob_len;
    for (int64_t i = 0; i < table_cap; i++)
        table[i] = -1;
    uint64_t mask = (uint64_t)table_cap - 1;
    int64_t n_uniq = 0;
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *p = blob + offs[i];
        int64_t len = lens[i];
        uint64_t slot = span_hash(p, len) & mask;
        for (;;) {
            int64_t j = table[slot];
            if (j < 0) {
                table[slot] = i;
                ids_out[i] = n_uniq;
                first_out[n_uniq] = i;
                n_uniq++;
                break;
            }
            if (lens[j] == len && memcmp(blob + offs[j], p, (size_t)len) == 0) {
                ids_out[i] = ids_out[j];
                break;
            }
            slot = (slot + 1) & mask;
        }
    }
    return n_uniq;
}

/* Parse + encode every line. Outputs are caller-allocated arrays sized
 * [n_lines] (and cls_out sized [n_lines * max_len], zero-filled by the
 * caller or here). Returns 0. */
int64_t fp_parse_encode(
    const uint8_t *blob, int64_t blob_len,
    const int64_t *starts, const int64_t *ends, int64_t n_lines,
    const int32_t *byte_to_class, /* [256] */
    int32_t max_len,
    double now_unix, double old_cutoff,
    /* outputs */
    int64_t *ts_ns_out, uint8_t *flags_out,
    int64_t *ip_off, int32_t *ip_len,
    int64_t *host_off, int32_t *host_len,
    int64_t *rest_off, int32_t *rest_len,
    int32_t *cls_out, int32_t *lens_out) {
    (void)blob_len;
    for (int64_t li = 0; li < n_lines; li++) {
        line_rec r;
        memset(&r, 0, sizeof(r));
        const uint8_t *line = blob + starts[li];
        int64_t len = ends[li] - starts[li];

        int32_t *cls_row = cls_out + li * (int64_t)max_len;
        memset(cls_row, 0, sizeof(int32_t) * (size_t)max_len);
        lens_out[li] = 0;

        /* split " ", 2 — both splits must yield 3 parts */
        const uint8_t *sp1 = memchr(line, ' ', (size_t)len);
        if (!sp1) {
            r.flags = FLAG_ERROR;
            goto store;
        }
        const uint8_t *p2 = sp1 + 1;
        const uint8_t *sp2 =
            memchr(p2, ' ', (size_t)(len - (p2 - line)));
        if (!sp2) {
            r.flags = FLAG_ERROR;
            goto store;
        }
        /* Python SplitN(" ",3) semantics: "a b " -> ["a","b",""] is 3 parts
         * (empty rest is fine and will fail the inner split) */
        {
            int64_t ts_len = sp1 - line;
            const uint8_t *ip = sp1 + 1;
            int64_t iplen = sp2 - ip;
            const uint8_t *rest = sp2 + 1;
            int64_t restlen = len - (rest - line);

            double ts;
            if (!fast_ts(line, ts_len, &ts)) {
                if (!plain_float_span(line, ts_len)) {
                    r.flags = FLAG_DEFER; /* Python float() may disagree */
                    goto store;
                }
                char tsbuf[80];
                memcpy(tsbuf, line, (size_t)ts_len);
                tsbuf[ts_len] = 0;
                ts = strtod(tsbuf, NULL);
            }
            double scaled = ts * 1e9;
            if (!(scaled > -9.2e18 && scaled < 9.2e18)) {
                r.flags = FLAG_DEFER; /* int64 overflow: Python raises */
                goto store;
            }
            r.ts_ns = (int64_t)scaled; /* C truncation == Python int() */

            r.ip_off = ip - blob;
            r.ip_len = (int32_t)iplen;
            r.rest_off = rest - blob;
            r.rest_len = (int32_t)restlen;

            /* rest split " ", 2 -> method, host, rest2 */
            const uint8_t *rsp1 = memchr(rest, ' ', (size_t)restlen);
            if (!rsp1) {
                r.flags = FLAG_ERROR;
                goto store;
            }
            const uint8_t *hostp = rsp1 + 1;
            const uint8_t *rsp2 =
                memchr(hostp, ' ', (size_t)(restlen - (hostp - rest)));
            if (!rsp2) {
                r.flags = FLAG_ERROR;
                goto store;
            }
            r.host_off = hostp - blob;
            r.host_len = (int32_t)(rsp2 - hostp);

            /* staleness: now - ts_ns/1e9 > cutoff (double math, as Python) */
            if (now_unix - (double)r.ts_ns / 1e9 > old_cutoff) {
                r.flags |= FLAG_OLD;
                goto store;
            }

            /* encode rest: class 0 pad; non-ASCII or over-length -> host */
            if (restlen > (int64_t)max_len) {
                r.flags |= FLAG_HOST_EVAL;
            } else {
                int64_t k;
                for (k = 0; k < restlen; k++) {
                    uint8_t b = rest[k];
                    if (b > 0x7F) {
                        r.flags |= FLAG_HOST_EVAL;
                        memset(cls_row, 0, sizeof(int32_t) * (size_t)k);
                        break;
                    }
                    cls_row[k] = byte_to_class[b];
                }
                if (!(r.flags & FLAG_HOST_EVAL))
                    lens_out[li] = (int32_t)restlen;
            }
        }
    store:
        ts_ns_out[li] = r.ts_ns;
        flags_out[li] = r.flags;
        ip_off[li] = r.ip_off;
        ip_len[li] = r.ip_len;
        host_off[li] = r.host_off;
        host_len[li] = r.host_len;
        rest_off[li] = r.rest_off;
        rest_len[li] = r.rest_len;
    }
    return 0;
}
