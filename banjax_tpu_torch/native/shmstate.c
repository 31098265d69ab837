/* shmstate.c — the port's copy of banjax_tpu/native/shmstate.c: the
 * shared-memory failed-challenge table (fc_*) and the warm tier of the
 * device-windows state (wt_*).
 *
 * fc_* backs the failed-challenge rate limiter when /auth_request is
 * served by several SO_REUSEPORT processes (httpapi/workers.py): every
 * process maps the same named segment, so an IP spreading failed
 * challenges across processes is counted exactly once, like the
 * reference's single-process mutex-guarded map (Go banjax:
 * internal/rate_limit.go:105-156).
 *
 * Layout: one 128-byte header then capacity (power of two) 128-byte slots.
 * Open addressing with linear probing, bounded at FC_MAX_PROBE; no
 * deletion (lookup never early-stops on stolen slots, so probe chains
 * stay valid).  When a key's probe window is full, the stalest expired
 * slot in the window is stolen — semantically identical to keeping it,
 * because an expired window restarts as if first-seen (OUTSIDE_INTERVAL
 * resets hits to 1 exactly like FIRST_TIME does).  If nothing in the
 * window is expired the apply degrades to an unstored first hit and a
 * dropped counter is bumped (visible in metrics).
 *
 * Concurrency: one per-slot spinlock (acquire/release atomics); at most
 * one lock is ever held at a time.  The lock word stores the OWNER'S PID
 * (0 = free), so a worker SIGKILLed mid-critical-section cannot wedge
 * every survivor whose probe chain crosses the slot: a waiter that sees a
 * dead owner (kill(pid, 0) == ESRCH) steals the lock at once, and any
 * owner, dead or wedged, is stolen from after a bounded wall-clock spin
 * (50 ms by default, fc_set_steal_ns).  Unlock is a CAS from our own pid,
 * so a robbed owner's late unlock cannot release the thief's lock.  The
 * worst case of a false steal is one corrupted rate-limit slot, never a
 * hang.
 *
 * The memory is the caller's (native/shm.py); the C side only reads and
 * writes records in it.  Pure C ABI (no Python.h), loaded with ctypes.
 */

#include <errno.h>
#include <signal.h>
#include <stdint.h>
#include <string.h>
#include <time.h>
#include <unistd.h>

#define FC_MAGIC 0x626a7868736d3032LL /* "bjxhsm02" — owner-pid lock words */
#define FC_MAX_PROBE 64
#define FC_KEY_MAX 104

/* match_type values mirror decisions/rate_limit.py RateLimitMatchType */
#define FC_FIRST_TIME 0
#define FC_OUTSIDE_INTERVAL 1
#define FC_INSIDE_INTERVAL 2
#define FC_EXCEEDED_BIT 0x10
#define FC_DROPPED_BIT 0x100

typedef struct {
    int64_t magic;
    int64_t capacity; /* slots; power of two */
    volatile int64_t dropped;
    int64_t _pad[13];
} fc_header; /* 128 bytes */

typedef struct {
    volatile int32_t lock;
    int32_t key_len; /* 0 = empty */
    int64_t interval_start_ns;
    int32_t num_hits;
    int32_t _pad;
    char key[FC_KEY_MAX];
} fc_slot; /* 128 bytes */

static int64_t fc_steal_after_ns = 50 * 1000 * 1000; /* 50 ms default */

/* test hook: lower the steal bound so the live-owner-steal path is
 * provable without a 50 ms wait per case */
void fc_set_steal_ns(int64_t ns) { fc_steal_after_ns = ns; }

static inline int32_t fc_self_tag(void) {
    /* benign race: every thread of a process writes the same value */
    static int32_t tag;
    if (tag == 0) {
        tag = (int32_t)getpid();
        if (tag == 0)
            tag = 1;
    }
    return tag;
}

static inline int64_t fc_mono_ns(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

static void fc_lock(fc_slot *s) {
    int32_t tag = fc_self_tag();
    int32_t expected = 0;
    if (__atomic_compare_exchange_n(&s->lock, &expected, tag, 0,
                                    __ATOMIC_ACQUIRE, __ATOMIC_RELAXED))
        return; /* uncontended fast path */
    int64_t t0 = 0;
    int32_t spins = 0;
    for (;;) {
        int32_t owner = __atomic_load_n(&s->lock, __ATOMIC_RELAXED);
        if (owner == 0) {
            expected = 0;
            if (__atomic_compare_exchange_n(&s->lock, &expected, tag, 0,
                                            __ATOMIC_ACQUIRE,
                                            __ATOMIC_RELAXED))
                return;
            continue;
        }
        if (++spins >= 1024) { /* syscalls only every ~1k spins */
            spins = 0;
            int64_t now = fc_mono_ns();
            if (t0 == 0)
                t0 = now;
            int dead = (owner != tag && kill((pid_t)owner, 0) != 0 &&
                        errno == ESRCH);
            if (dead || now - t0 > fc_steal_after_ns) {
                if (__atomic_compare_exchange_n(&s->lock, &owner, tag, 0,
                                                __ATOMIC_ACQUIRE,
                                                __ATOMIC_RELAXED))
                    return; /* stolen from a dead/wedged owner */
            }
        }
    }
}

static inline void fc_unlock(fc_slot *s) {
    /* release only if still ours: if the lock was stolen (we were the
     * presumed-dead owner), storing 0 here would unlock the thief */
    int32_t tag = fc_self_tag();
    __atomic_compare_exchange_n(&s->lock, &tag, 0, 0, __ATOMIC_RELEASE,
                                __ATOMIC_RELAXED);
}

static inline uint64_t fc_hash(const char *key, int32_t len) {
    uint64_t h = 0xcbf29ce484222325ULL;
    for (int32_t i = 0; i < len; i++) {
        h ^= (uint8_t)key[i];
        h *= 0x100000001b3ULL;
    }
    return h;
}

static inline fc_slot *fc_slots(void *base) {
    return (fc_slot *)((char *)base + sizeof(fc_header));
}

int64_t fc_init(void *base, int64_t capacity) {
    /* caller provides zeroed shared memory; capacity must be a power of 2 */
    if (capacity <= 0 || (capacity & (capacity - 1)))
        return -1;
    fc_header *h = (fc_header *)base;
    h->capacity = capacity;
    h->dropped = 0;
    __atomic_store_n(&h->magic, FC_MAGIC, __ATOMIC_RELEASE);
    return 0;
}

int64_t fc_check(void *base) {
    fc_header *h = (fc_header *)base;
    if (__atomic_load_n(&h->magic, __ATOMIC_ACQUIRE) != FC_MAGIC)
        return -1;
    return h->capacity;
}

/* The window transition — mirrors FailedChallengeRateLimitStates.apply
 * (rate_limit.go:125-156 quirks: strict >, exceed resets hits to 0). */
static inline int32_t fc_window(fc_slot *s, int64_t now_ns, int32_t threshold,
                                int32_t match, int32_t *out_hits) {
    int32_t rc = match;
    if (match == FC_OUTSIDE_INTERVAL || match == FC_FIRST_TIME) {
        s->num_hits = 1;
        s->interval_start_ns = now_ns;
    } else {
        s->num_hits += 1;
    }
    if (s->num_hits > threshold) {
        s->num_hits = 0;
        rc |= FC_EXCEEDED_BIT;
        *out_hits = 0;
    } else {
        *out_hits = s->num_hits;
    }
    return rc;
}

int32_t fc_apply(void *base, const char *key, int32_t key_len, int64_t now_ns,
                 int64_t interval_ns, int32_t threshold, int32_t *out_hits) {
    fc_header *hdr = (fc_header *)base;
    fc_slot *slots = fc_slots(base);
    uint64_t mask = (uint64_t)hdr->capacity - 1;
    if (key_len > FC_KEY_MAX)
        key_len = FC_KEY_MAX;
    uint64_t home = fc_hash(key, key_len) & mask;

    int64_t stalest_start = INT64_MAX;
    int64_t stalest_idx = -1;
    for (int32_t p = 0; p < FC_MAX_PROBE; p++) {
        fc_slot *s = &slots[(home + p) & mask];
        fc_lock(s);
        if (s->key_len == 0) {
            memcpy(s->key, key, (size_t)key_len);
            s->key_len = key_len;
            int32_t rc = fc_window(s, now_ns, threshold,
                                   FC_FIRST_TIME, out_hits);
            fc_unlock(s);
            return rc;
        }
        if (s->key_len == key_len && memcmp(s->key, key, (size_t)key_len) == 0) {
            int32_t match = (now_ns - s->interval_start_ns > interval_ns)
                                ? FC_OUTSIDE_INTERVAL
                                : FC_INSIDE_INTERVAL;
            int32_t rc = fc_window(s, now_ns, threshold, match,
                                   out_hits);
            fc_unlock(s);
            return rc;
        }
        if (s->interval_start_ns < stalest_start) {
            stalest_start = s->interval_start_ns;
            stalest_idx = (int64_t)((home + p) & mask);
        }
        fc_unlock(s);
    }

    /* probe window full: steal the stalest slot iff its window expired */
    if (stalest_idx >= 0) {
        fc_slot *s = &slots[stalest_idx];
        fc_lock(s);
        if (s->key_len != 0 && now_ns - s->interval_start_ns > interval_ns) {
            memcpy(s->key, key, (size_t)key_len);
            s->key_len = key_len;
            int32_t rc = fc_window(s, now_ns, threshold,
                                   FC_FIRST_TIME, out_hits);
            fc_unlock(s);
            return rc;
        }
        fc_unlock(s);
    }

    /* degraded: transient unstored first hit */
    __atomic_add_fetch(&hdr->dropped, 1, __ATOMIC_RELAXED);
    int32_t rc = FC_FIRST_TIME | FC_DROPPED_BIT;
    if (1 > threshold) {
        rc |= FC_EXCEEDED_BIT;
        *out_hits = 0;
    } else {
        *out_hits = 1;
    }
    return rc;
}

int64_t fc_count(void *base) {
    fc_header *hdr = (fc_header *)base;
    fc_slot *slots = fc_slots(base);
    int64_t n = 0;
    for (int64_t i = 0; i < hdr->capacity; i++)
        if (slots[i].key_len != 0)
            n++;
    return n;
}

int64_t fc_dropped(void *base) {
    fc_header *hdr = (fc_header *)base;
    return __atomic_load_n(&hdr->dropped, __ATOMIC_RELAXED);
}

/* Copy live entries out for format_states / metrics.  Returns the number
 * of entries written (at most max_entries).  keys_blob must hold
 * max_entries*FC_KEY_MAX bytes; entry i's key is keys_blob[i*FC_KEY_MAX :
 * i*FC_KEY_MAX+key_lens[i]]. */
int64_t fc_snapshot(void *base, char *keys_blob, int32_t *key_lens,
                    int32_t *hits, int64_t *starts, int64_t max_entries) {
    fc_header *hdr = (fc_header *)base;
    fc_slot *slots = fc_slots(base);
    int64_t n = 0;
    for (int64_t i = 0; i < hdr->capacity && n < max_entries; i++) {
        fc_slot *s = &slots[i];
        if (s->key_len == 0)
            continue;
        fc_lock(s);
        if (s->key_len != 0) {
            memcpy(keys_blob + n * FC_KEY_MAX, s->key, (size_t)s->key_len);
            key_lens[n] = s->key_len;
            hits[n] = s->num_hits;
            starts[n] = s->interval_start_ns;
            n++;
        }
        fc_unlock(s);
    }
    return n;
}

/* test hooks: plant/read a raw owner tag so the fault suite can simulate
 * a worker killed while holding a slot lock */
void fc_test_lock_slot(void *base, int64_t idx, int32_t tag) {
    __atomic_store_n(&fc_slots(base)[idx].lock, tag, __ATOMIC_RELEASE);
}

int32_t fc_test_slot_owner(void *base, int64_t idx) {
    return __atomic_load_n(&fc_slots(base)[idx].lock, __ATOMIC_ACQUIRE);
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
 * linear probe bounded at WT_MAX_PROBE.  Unlike the fc_* table above,
 * take() deletes — key_len -1 marks a tombstone (probes continue past
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
