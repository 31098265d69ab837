/* Shared-memory decision table: the compiled /auth_request fast path.
 *
 * A copy of banjax_tpu/native/decisiontable.c. The port maps it in one
 * shared anonymous mapping of a single serving process, or in a named
 * segment that the workers of multi-process serving attach.
 *
 * A shm-resident, open-addressed table of already-decided IPs — the
 * kernel-adjacent twin of the reference escalating decided IPs out of
 * userspace into ipset entries with per-entry timeouts.  Every fastserve
 * worker maps the same segment; the primary's DynamicDecisionLists
 * mirrors every insert/expiry/removal into it, and the HTTP fast path
 * answers a hit with one probe instead of the Python decision chain.
 *
 * Layout: one 128-byte header then capacity (power of two) 96-byte
 * slots.  Linear probing bounded at DT_MAX_PROBE.
 *
 * Concurrency model — read-mostly, seqlock-style:
 *   * ONE writer lock in the header (the fc_lock owner-pid idiom from
 *     shmstate.c: dead-owner steal via kill(pid,0)==ESRCH, bounded
 *     wall-clock steal for wedged owners, CAS-from-own-pid unlock).
 *     Writes are rare (a ban insert, a lazy expiry) so a single lock is
 *     plenty.
 *   * readers take NO lock: each slot carries a version word bumped to
 *     odd before mutation and back to even after; a reader snapshots
 *     the version, copies the slot, and retries if the version moved or
 *     was odd.  A bounded retry budget turns a pathological writer into
 *     a reported fault, never a spin — the caller falls open to the
 *     Python chain.
 *   * dt_clear is O(1): it bumps the header epoch, invalidating every
 *     slot at once (slots store the epoch they were written under).
 *     The epoch starts at 1 so freshly zeroed segments parse as stale.
 *
 * Deletion writes key_len = 0 under the slot version bump; probe chains
 * stay valid because readers and the insert scan never early-stop — the
 * whole (bounded) window is scanned, so a freed slot mid-chain cannot
 * hide a live entry behind it.  When a key's window is full of live,
 * unexpired, current-epoch entries the put is REFUSED and a dropped
 * counter is bumped — the entry simply stays Python-only and the chain
 * serves it (fail-open, never evict a live decision).
 *
 * Expiry is the caller's comparison (strictly `now - expires > 0`,
 * matching DynamicDecisionLists lazy expiry to the bit) — the table
 * returns the stored expiry; only dt_put consults `now` so a full
 * window can reuse an already-expired slot.
 */

#include <errno.h>
#include <signal.h>
#include <stdint.h>
#include <string.h>
#include <time.h>
#include <unistd.h>

#define DT_MAGIC 0x626a786474303141LL /* "bjxdt01A" */
#define DT_MAX_PROBE 64
#define DT_KEY_MAX 64
#define DT_READ_RETRIES 1024

typedef struct {
    int64_t magic;
    int64_t capacity;          /* slots; power of two */
    volatile int32_t lock;     /* writer lock: owner pid, 0 = free */
    int32_t _pad0;
    volatile uint64_t epoch;   /* bump = O(1) clear; starts at 1 */
    volatile int64_t count;    /* live entries this epoch (writer-kept) */
    volatile int64_t dropped;  /* refused puts (full window); monotone */
    volatile int64_t sessions; /* mirrored dynamic session-id entries */
    int64_t _pad[9];
} dt_header; /* 128 bytes */

typedef struct {
    volatile uint32_t version; /* seqlock: odd while a write is in flight */
    uint32_t epoch;            /* valid iff == (uint32_t)header->epoch */
    double expires;            /* unix seconds, as stored by Python */
    uint8_t key_len;           /* 0 = free */
    uint8_t decision;
    uint8_t flags;             /* bit0: from_baskerville */
    uint8_t _pad0;
    uint32_t site_hash;        /* FNV-1a of the banning domain (introspection) */
    char key[DT_KEY_MAX];
    int64_t _pad1;
} dt_slot; /* 96 bytes */

static int64_t dt_steal_after_ns = 50 * 1000 * 1000; /* 50 ms default */

void dt_set_steal_ns(int64_t ns) { dt_steal_after_ns = ns; }

static inline int32_t dt_self_tag(void) {
    static int32_t tag; /* benign race: same value from every thread */
    if (tag == 0) {
        tag = (int32_t)getpid();
        if (tag == 0)
            tag = 1;
    }
    return tag;
}

static inline int64_t dt_mono_ns(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

static void dt_lock(dt_header *h) {
    int32_t tag = dt_self_tag();
    int32_t expected = 0;
    if (__atomic_compare_exchange_n(&h->lock, &expected, tag, 0,
                                    __ATOMIC_ACQUIRE, __ATOMIC_RELAXED))
        return;
    int64_t t0 = 0;
    int32_t spins = 0;
    for (;;) {
        int32_t owner = __atomic_load_n(&h->lock, __ATOMIC_RELAXED);
        if (owner == 0) {
            expected = 0;
            if (__atomic_compare_exchange_n(&h->lock, &expected, tag, 0,
                                            __ATOMIC_ACQUIRE,
                                            __ATOMIC_RELAXED))
                return;
            continue;
        }
        if (++spins >= 1024) {
            spins = 0;
            int64_t now = dt_mono_ns();
            if (t0 == 0)
                t0 = now;
            int dead = (owner != tag && kill((pid_t)owner, 0) != 0 &&
                        errno == ESRCH);
            if (dead || now - t0 > dt_steal_after_ns) {
                if (__atomic_compare_exchange_n(&h->lock, &owner, tag, 0,
                                                __ATOMIC_ACQUIRE,
                                                __ATOMIC_RELAXED))
                    return;
            }
        }
    }
}

static inline void dt_unlock(dt_header *h) {
    int32_t tag = dt_self_tag();
    __atomic_compare_exchange_n(&h->lock, &tag, 0, 0, __ATOMIC_RELEASE,
                                __ATOMIC_RELAXED);
}

static inline uint64_t dt_hash(const char *key, int32_t len) {
    uint64_t h = 0xcbf29ce484222325ULL;
    for (int32_t i = 0; i < len; i++) {
        h ^= (uint8_t)key[i];
        h *= 0x100000001b3ULL;
    }
    return h;
}

uint32_t dt_site_hash(const char *key, int32_t len) {
    return (uint32_t)dt_hash(key, len);
}

static inline dt_slot *dt_slots(dt_header *h) {
    return (dt_slot *)((char *)h + sizeof(dt_header));
}

/* seqlock write bracket: the version is odd for the duration */
static inline uint32_t dt_write_begin(dt_slot *s) {
    uint32_t v = __atomic_load_n(&s->version, __ATOMIC_RELAXED);
    __atomic_store_n(&s->version, v + 1, __ATOMIC_RELAXED);
    __atomic_thread_fence(__ATOMIC_RELEASE);
    return v;
}

static inline void dt_write_end(dt_slot *s, uint32_t v) {
    __atomic_thread_fence(__ATOMIC_RELEASE);
    __atomic_store_n(&s->version, v + 2, __ATOMIC_RELEASE);
}

int64_t dt_init(void *base, int64_t capacity) {
    if (capacity < 2 || (capacity & (capacity - 1)) != 0)
        return -1;
    dt_header *h = (dt_header *)base;
    memset(base, 0,
           sizeof(dt_header) + (size_t)capacity * sizeof(dt_slot));
    h->capacity = capacity;
    h->epoch = 1;
    /* magic last, RELEASE: an attacher that sees the magic sees the rest */
    __atomic_store_n(&h->magic, DT_MAGIC, __ATOMIC_RELEASE);
    return (int64_t)(sizeof(dt_header) + (size_t)capacity * sizeof(dt_slot));
}

int64_t dt_check(void *base) {
    dt_header *h = (dt_header *)base;
    if (__atomic_load_n(&h->magic, __ATOMIC_ACQUIRE) != DT_MAGIC)
        return -1;
    return h->capacity;
}

/* Insert or replace.  Returns 0 on success, -1 when the probe window is
 * full of live entries (refused; dropped counter bumped). */
int32_t dt_put(void *base, const char *key, int32_t key_len,
               int32_t decision, int32_t flags, uint32_t site_hash,
               double expires, double now_s) {
    dt_header *h = (dt_header *)base;
    if (key_len <= 0 || key_len > DT_KEY_MAX)
        return -1;
    dt_slot *slots = dt_slots(h);
    uint64_t mask = (uint64_t)h->capacity - 1;
    uint64_t home = dt_hash(key, key_len);
    int64_t window =
        h->capacity < DT_MAX_PROBE ? h->capacity : DT_MAX_PROBE;

    dt_lock(h);
    uint32_t ep = (uint32_t)h->epoch;
    dt_slot *found = 0;
    dt_slot *reuse = 0;
    int reuse_was_live = 0;
    for (int64_t p = 0; p < window; p++) {
        dt_slot *s = &slots[(home + (uint64_t)p) & mask];
        if (s->key_len == 0 || s->epoch != ep) {
            if (!reuse) {
                reuse = s;
                reuse_was_live = 0;
            }
            continue;
        }
        if (s->key_len == (uint8_t)key_len &&
            memcmp(s->key, key, (size_t)key_len) == 0) {
            found = s;
            break;
        }
        if (!reuse && now_s - s->expires > 0.0) {
            reuse = s; /* steal an already-expired live slot */
            reuse_was_live = 1;
        }
    }
    dt_slot *target = found ? found : reuse;
    if (!target) {
        __atomic_fetch_add(&h->dropped, 1, __ATOMIC_RELAXED);
        dt_unlock(h);
        return -1;
    }
    uint32_t v = dt_write_begin(target);
    target->epoch = ep;
    target->expires = expires;
    target->decision = (uint8_t)decision;
    target->flags = (uint8_t)flags;
    target->site_hash = site_hash;
    if (!found) {
        memcpy(target->key, key, (size_t)key_len);
        target->key_len = (uint8_t)key_len;
    }
    dt_write_end(target, v);
    if (!found && !reuse_was_live)
        h->count++;
    dt_unlock(h);
    return 0;
}

/* Lock-free lookup.  Returns 0 on hit (outputs filled), -1 on miss,
 * -2 on a torn-read fault (reader retry budget exhausted — fall open). */
int32_t dt_get(void *base, const char *key, int32_t key_len,
               uint8_t *decision, uint8_t *flags, uint32_t *site_hash,
               double *expires) {
    dt_header *h = (dt_header *)base;
    if (key_len <= 0 || key_len > DT_KEY_MAX)
        return -1;
    dt_slot *slots = dt_slots(h);
    uint64_t mask = (uint64_t)h->capacity - 1;
    uint64_t home = dt_hash(key, key_len);
    uint32_t ep = (uint32_t)__atomic_load_n(&h->epoch, __ATOMIC_ACQUIRE);
    int64_t window =
        h->capacity < DT_MAX_PROBE ? h->capacity : DT_MAX_PROBE;

    for (int64_t p = 0; p < window; p++) {
        dt_slot *s = &slots[(home + (uint64_t)p) & mask];
        uint8_t c_key_len, c_decision, c_flags;
        uint32_t c_site_hash, c_epoch;
        double c_expires;
        char c_key[DT_KEY_MAX];
        int32_t tries = 0;
        for (;;) {
            uint32_t v1 = __atomic_load_n(&s->version, __ATOMIC_ACQUIRE);
            if (!(v1 & 1)) {
                c_key_len = s->key_len;
                c_epoch = s->epoch;
                c_decision = s->decision;
                c_flags = s->flags;
                c_site_hash = s->site_hash;
                c_expires = s->expires;
                if (c_key_len <= DT_KEY_MAX && c_key_len > 0)
                    memcpy(c_key, s->key, c_key_len);
                __atomic_thread_fence(__ATOMIC_ACQUIRE);
                uint32_t v2 =
                    __atomic_load_n(&s->version, __ATOMIC_RELAXED);
                if (v1 == v2)
                    break;
            }
            if (++tries >= DT_READ_RETRIES)
                return -2; /* writer wedged mid-slot: fall open */
        }
        if (c_key_len == 0 || c_epoch != ep)
            continue;
        if (c_key_len == (uint8_t)key_len &&
            memcmp(c_key, key, (size_t)key_len) == 0) {
            *decision = c_decision;
            *flags = c_flags;
            *site_hash = c_site_hash;
            *expires = c_expires;
            return 0;
        }
    }
    return -1;
}

int32_t dt_del(void *base, const char *key, int32_t key_len) {
    dt_header *h = (dt_header *)base;
    if (key_len <= 0 || key_len > DT_KEY_MAX)
        return -1;
    dt_slot *slots = dt_slots(h);
    uint64_t mask = (uint64_t)h->capacity - 1;
    uint64_t home = dt_hash(key, key_len);
    int64_t window =
        h->capacity < DT_MAX_PROBE ? h->capacity : DT_MAX_PROBE;

    dt_lock(h);
    uint32_t ep = (uint32_t)h->epoch;
    for (int64_t p = 0; p < window; p++) {
        dt_slot *s = &slots[(home + (uint64_t)p) & mask];
        if (s->key_len == (uint8_t)key_len && s->epoch == ep &&
            memcmp(s->key, key, (size_t)key_len) == 0) {
            uint32_t v = dt_write_begin(s);
            s->key_len = 0;
            dt_write_end(s, v);
            if (h->count > 0)
                h->count--;
            dt_unlock(h);
            return 0;
        }
    }
    dt_unlock(h);
    return -1;
}

void dt_clear(void *base) {
    dt_header *h = (dt_header *)base;
    dt_lock(h);
    __atomic_fetch_add(&h->epoch, 1, __ATOMIC_RELEASE);
    h->count = 0;
    __atomic_store_n(&h->sessions, 0, __ATOMIC_RELAXED);
    dt_unlock(h);
}

int64_t dt_len(void *base) {
    dt_header *h = (dt_header *)base;
    return __atomic_load_n(&h->count, __ATOMIC_RELAXED);
}

int64_t dt_dropped(void *base) {
    dt_header *h = (dt_header *)base;
    return __atomic_load_n(&h->dropped, __ATOMIC_RELAXED);
}

int64_t dt_session_add(void *base, int64_t delta) {
    dt_header *h = (dt_header *)base;
    int64_t now = __atomic_add_fetch(&h->sessions, delta, __ATOMIC_RELAXED);
    if (now < 0) { /* clamp: a stray double-decrement must not wedge the
                    * session guard permanently negative */
        __atomic_store_n(&h->sessions, 0, __ATOMIC_RELAXED);
        return 0;
    }
    return now;
}

int64_t dt_session_count(void *base) {
    dt_header *h = (dt_header *)base;
    int64_t n = __atomic_load_n(&h->sessions, __ATOMIC_RELAXED);
    return n < 0 ? 0 : n;
}

/* test hook: hold a slot's version odd, as a SIGKILLed writer would */
void dt_test_wedge_slot(void *base, const char *key, int32_t key_len) {
    dt_header *h = (dt_header *)base;
    dt_slot *slots = dt_slots(h);
    uint64_t mask = (uint64_t)h->capacity - 1;
    dt_slot *s = &slots[dt_hash(key, key_len) & mask];
    __atomic_store_n(&s->version, s->version | 1, __ATOMIC_RELEASE);
}

void dt_test_unwedge_slot(void *base, const char *key, int32_t key_len) {
    dt_header *h = (dt_header *)base;
    dt_slot *slots = dt_slots(h);
    uint64_t mask = (uint64_t)h->capacity - 1;
    dt_slot *s = &slots[dt_hash(key, key_len) & mask];
    __atomic_store_n(&s->version, (s->version | 1) + 1, __ATOMIC_RELEASE);
}
