/* shmstate.c — the warm tier of the device-windows state (the port's copy
 * of the wt_* table of banjax_tpu/native/shmstate.c, with the key hash it
 * uses; the failed-challenge fc_* table is not part of the port, whose
 * challenge/failures.py keeps that state).
 *
 * The table lives in memory the caller maps (banjax_tpu_torch/native/
 * shm.py); the C side only reads and writes records in it.  Pure C ABI
 * (no Python.h), loaded with ctypes.
 */

#include <stdint.h>
#include <string.h>

/* FNV-1a 64, the table's probe hash */
static inline uint64_t fc_hash(const char *key, int32_t len) {
    uint64_t h = 0xcbf29ce484222325ULL;
    for (int32_t i = 0; i < len; i++) {
        h ^= (uint8_t)key[i];
        h *= 0x100000001b3ULL;
    }
    return h;
}

/* ------------------------------------------------------------------ *
 * Warm-tier IP window store (mega-state tiering).
 *
 * Holds the full per-rule (num_hits, interval_start) vector of an IP
 * evicted from the device hot tier, so a returning repeat offender
 * refills its window state on slot claim instead of restarting from
 * zero.  One record per IP; the per-rule entries keep their INSERTION
 * order — the hot tier's shadow map is an OrderedDict and a refill
 * round-trip must hand back byte-identical state.
 *
 * Layout: one 128-byte wt_header, then capacity (power of two) records
 * of (128-byte record header + max_rules wt_entry).  Open addressing,
 * linear probe bounded at WT_MAX_PROBE.  Unlike the JAX package's fc_*
 * table, take() deletes — key_len -1 marks a tombstone (probes continue past
 * it; key search may still early-stop on a genuine empty because
 * inserts never skip one).
 *
 * Concurrency: NONE here by design.  The only caller is DeviceWindows,
 * which already serializes every slot/shadow mutation under its own
 * lock — the same external-locking convention as slotmgr.c.
 *
 * Full probe window: steal the stalest record iff its last-touch stamp
 * is older than the expiry horizon (an offender's record is refreshed
 * every spill, so live attackers are never the stalest-and-expired
 * victim); otherwise the new put is dropped and counted — bounded
 * memory, never silent.
 */

#define WT_MAGIC 0x626a787774303031LL /* "bjxwt001" */
#define WT_MAX_PROBE 64
#define WT_KEY_MAX 104
#define WT_TOMBSTONE (-1)

typedef struct {
    int64_t magic;
    int64_t capacity;  /* records; power of two */
    int64_t max_rules; /* wt_entry slots per record */
    int64_t count;     /* live records */
    int64_t dropped;   /* puts lost to a full, unexpired probe window */
    int64_t _pad[11];
} wt_header; /* 128 bytes */

typedef struct {
    int32_t key_len; /* 0 = empty, -1 = tombstone */
    int32_t n_entries;
    int64_t stamp_ns; /* last-touch; the steal policy's staleness key */
    char key[WT_KEY_MAX];
    int64_t _pad;
} wt_rec; /* 128 bytes; followed in memory by max_rules wt_entry */

typedef struct {
    int32_t rule_id;
    int32_t hits;
    int64_t start_s;
    int64_t start_ns;
} wt_entry; /* 24 bytes */

static inline int64_t wt_stride(const wt_header *h) {
    return (int64_t)sizeof(wt_rec) + h->max_rules * (int64_t)sizeof(wt_entry);
}

static inline wt_rec *wt_at(void *base, int64_t i) {
    wt_header *h = (wt_header *)base;
    return (wt_rec *)((char *)base + sizeof(wt_header) + i * wt_stride(h));
}

static inline wt_entry *wt_entries(wt_rec *r) {
    return (wt_entry *)((char *)r + sizeof(wt_rec));
}

int64_t wt_init(void *base, int64_t capacity, int64_t max_rules) {
    /* caller provides zeroed memory; capacity must be a power of 2 */
    if (capacity <= 0 || (capacity & (capacity - 1)) || max_rules <= 0)
        return -1;
    wt_header *h = (wt_header *)base;
    h->capacity = capacity;
    h->max_rules = max_rules;
    h->count = 0;
    h->dropped = 0;
    h->magic = WT_MAGIC;
    return 0;
}

int64_t wt_check(void *base) {
    wt_header *h = (wt_header *)base;
    if (h->magic != WT_MAGIC)
        return -1;
    return h->capacity;
}

int64_t wt_len(void *base) { return ((wt_header *)base)->count; }

int64_t wt_dropped(void *base) { return ((wt_header *)base)->dropped; }

void wt_clear(void *base) {
    wt_header *h = (wt_header *)base;
    for (int64_t i = 0; i < h->capacity; i++)
        wt_at(base, i)->key_len = 0;
    h->count = 0;
    h->dropped = 0;
}

static void wt_fill(wt_rec *r, const char *key, int32_t key_len,
                    int64_t now_ns, const int32_t *rule_ids,
                    const int32_t *hits, const int64_t *ss,
                    const int64_t *sns, int64_t n) {
    memcpy(r->key, key, (size_t)key_len);
    r->key_len = key_len;
    r->stamp_ns = now_ns;
    r->n_entries = (int32_t)n;
    wt_entry *e = wt_entries(r);
    for (int64_t k = 0; k < n; k++) {
        e[k].rule_id = rule_ids[k];
        e[k].hits = hits[k];
        e[k].start_s = ss[k];
        e[k].start_ns = sns[k];
    }
}

/* Spill one IP's window vector.  Returns 0 (inserted/updated) or -1
 * (dropped: probe window full of live records younger than expiry). */
int64_t wt_put(void *base, const char *key, int32_t key_len, int64_t now_ns,
               int64_t expiry_ns, const int32_t *rule_ids,
               const int32_t *hits, const int64_t *ss, const int64_t *sns,
               int64_t n) {
    wt_header *h = (wt_header *)base;
    if (key_len > WT_KEY_MAX)
        key_len = WT_KEY_MAX;
    if (n > h->max_rules)
        n = h->max_rules;
    uint64_t mask = (uint64_t)h->capacity - 1;
    uint64_t home = fc_hash(key, key_len) & mask;

    int64_t insert_at = -1;  /* first tombstone-or-empty in the window */
    int64_t stalest_at = -1;
    int64_t stalest_ns = INT64_MAX;
    for (int32_t p = 0; p < WT_MAX_PROBE; p++) {
        int64_t idx = (int64_t)((home + p) & mask);
        wt_rec *r = wt_at(base, idx);
        if (r->key_len == 0) {
            if (insert_at < 0)
                insert_at = idx;
            break; /* a key never lives past a genuine empty */
        }
        if (r->key_len == WT_TOMBSTONE) {
            if (insert_at < 0)
                insert_at = idx;
            continue;
        }
        if (r->key_len == key_len &&
            memcmp(r->key, key, (size_t)key_len) == 0) {
            wt_fill(r, key, key_len, now_ns, rule_ids, hits, ss, sns, n);
            return 0;
        }
        if (r->stamp_ns < stalest_ns) {
            stalest_ns = r->stamp_ns;
            stalest_at = idx;
        }
    }
    if (insert_at >= 0) {
        wt_fill(wt_at(base, insert_at), key, key_len, now_ns, rule_ids,
                hits, ss, sns, n);
        h->count++;
        return 0;
    }
    if (stalest_at >= 0 && now_ns - stalest_ns > expiry_ns) {
        /* steal: the victim's windows all expired, so losing its state
         * is semantically a restart-as-first-seen */
        wt_fill(wt_at(base, stalest_at), key, key_len, now_ns, rule_ids,
                hits, ss, sns, n);
        h->dropped++;
        return 0;
    }
    h->dropped++;
    return -1;
}

/* Move semantics for refill: copy the record's entries out and delete
 * it.  Returns the entry count, or -1 when the key is absent. */
int64_t wt_take(void *base, const char *key, int32_t key_len,
                int32_t *rule_ids_out, int32_t *hits_out, int64_t *ss_out,
                int64_t *sns_out) {
    wt_header *h = (wt_header *)base;
    if (key_len > WT_KEY_MAX)
        key_len = WT_KEY_MAX;
    uint64_t mask = (uint64_t)h->capacity - 1;
    uint64_t home = fc_hash(key, key_len) & mask;
    for (int32_t p = 0; p < WT_MAX_PROBE; p++) {
        wt_rec *r = wt_at(base, (int64_t)((home + p) & mask));
        if (r->key_len == 0)
            return -1;
        if (r->key_len == WT_TOMBSTONE)
            continue;
        if (r->key_len == key_len &&
            memcmp(r->key, key, (size_t)key_len) == 0) {
            int64_t n = r->n_entries;
            wt_entry *e = wt_entries(r);
            for (int64_t k = 0; k < n; k++) {
                rule_ids_out[k] = e[k].rule_id;
                hits_out[k] = e[k].hits;
                ss_out[k] = e[k].start_s;
                sns_out[k] = e[k].start_ns;
            }
            r->key_len = WT_TOMBSTONE;
            h->count--;
            return n;
        }
    }
    return -1;
}

/* Non-deleting read (introspection: DeviceWindows.get / format_states
 * must see warm-spilled state).  Same contract as wt_take otherwise. */
int64_t wt_get(void *base, const char *key, int32_t key_len,
               int32_t *rule_ids_out, int32_t *hits_out, int64_t *ss_out,
               int64_t *sns_out) {
    wt_header *h = (wt_header *)base;
    if (key_len > WT_KEY_MAX)
        key_len = WT_KEY_MAX;
    uint64_t mask = (uint64_t)h->capacity - 1;
    uint64_t home = fc_hash(key, key_len) & mask;
    for (int32_t p = 0; p < WT_MAX_PROBE; p++) {
        wt_rec *r = wt_at(base, (int64_t)((home + p) & mask));
        if (r->key_len == 0)
            return -1;
        if (r->key_len == WT_TOMBSTONE)
            continue;
        if (r->key_len == key_len &&
            memcmp(r->key, key, (size_t)key_len) == 0) {
            int64_t n = r->n_entries;
            wt_entry *e = wt_entries(r);
            for (int64_t k = 0; k < n; k++) {
                rule_ids_out[k] = e[k].rule_id;
                hits_out[k] = e[k].hits;
                ss_out[k] = e[k].start_s;
                sns_out[k] = e[k].start_ns;
            }
            return n;
        }
    }
    return -1;
}

/* Copy live keys out (table order) for introspection.  keys_blob must
 * hold max_entries*WT_KEY_MAX bytes.  Returns the number written. */
int64_t wt_snapshot_keys(void *base, char *keys_blob, int32_t *key_lens,
                         int64_t max_entries) {
    wt_header *h = (wt_header *)base;
    int64_t n = 0;
    for (int64_t i = 0; i < h->capacity && n < max_entries; i++) {
        wt_rec *r = wt_at(base, i);
        if (r->key_len <= 0)
            continue;
        memcpy(keys_blob + n * WT_KEY_MAX, r->key, (size_t)r->key_len);
        key_lens[n] = r->key_len;
        n++;
    }
    return n;
}

/* Batched membership probe over a distinct-ip blob (the admission
 * check's fast path: one C call per batch, not one per IP).  Writes
 * 0/1 per ip into out; returns the number present. */
int64_t wt_contains_batch(void *base, const uint8_t *blob,
                          const int64_t *offs, const int64_t *lens,
                          int64_t n, uint8_t *out) {
    wt_header *h = (wt_header *)base;
    uint64_t mask = (uint64_t)h->capacity - 1;
    int64_t found = 0;
    for (int64_t i = 0; i < n; i++) {
        const char *key = (const char *)blob + offs[i];
        int32_t key_len = (int32_t)lens[i];
        if (key_len > WT_KEY_MAX)
            key_len = WT_KEY_MAX;
        uint64_t home = fc_hash(key, key_len) & mask;
        uint8_t hit = 0;
        for (int32_t p = 0; p < WT_MAX_PROBE; p++) {
            wt_rec *r = wt_at(base, (int64_t)((home + p) & mask));
            if (r->key_len == 0)
                break;
            if (r->key_len == WT_TOMBSTONE)
                continue;
            if (r->key_len == key_len &&
                memcmp(r->key, key, (size_t)key_len) == 0) {
                hit = 1;
                break;
            }
        }
        out[i] = hit;
        found += hit;
    }
    return found;
}
