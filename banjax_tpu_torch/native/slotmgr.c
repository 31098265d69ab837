/* slotmgr.c — native slot manager for the device-windows IP table (the
 * port's copy of banjax_tpu/native/slotmgr.c).
 *
 * Replaces the per-distinct-IP Python dict+LRU loop in
 * banjax_tpu_torch/matcher/windows.py (slots_for_unique_ips) with one C call
 * per batch over the unique-IP span array: in the all-distinct-IP worst
 * case that loop is the dominant residual on the host path once
 * parse/encode went native.
 *
 * Exact-parity contract with the Python path (the dict loop stays as the
 * differential oracle, tests/test_torch_native.py):
 *
 *   - two passes per batch, like the Python loop's ordering: pass 1
 *     (sm_lookup_batch) resolves hits and stamps their recency with the
 *     batch sequence number; pass 2 (sm_place_misses) assigns misses in
 *     ip order, popping the free stack first and evicting only at
 *     capacity.
 *   - free-stack order: slots pop ascending (0, 1, 2, ...); grown slots
 *     drain after every pre-grow slot — identical to the Python list's
 *     pop() order across _grow_locked calls.
 *   - eviction victim: minimum (last_used, slot) over assigned, unpinned
 *     slots not touched by THIS batch (last_used < seq) — exactly
 *     np.argmin's first-minimum tie-break.  The sorted candidate list is
 *     built once per batch and re-validated at consumption, which yields
 *     the same victim sequence as the per-miss argmin because nothing
 *     becomes MORE evictable mid-call (pins are frozen, recency only
 *     advances).
 *   - refusal: when every candidate is pinned/touched, return -1 with
 *     earlier misses already placed — the Python loop's partial-state
 *     refusal, after which the caller splits the batch.
 *
 * Recency (last_used, int64 per slot) and pin counts (int32 per slot)
 * stay in caller-owned numpy arrays shared by pointer, so the Python
 * side's vectorized pin release and introspection keep working
 * unchanged.  IP strings are malloc'd copies owned here; the Python
 * wrapper mirrors slot->ip only for misses/evictions (O(changes), not
 * O(ips)).
 *
 * Pure C ABI (no Python.h), loaded with ctypes — same convention as
 * fastparse.c.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    int64_t capacity;
    int64_t assigned;
    /* per-slot ip bytes (malloc'd); NULL = unassigned */
    uint8_t **ip;
    int32_t *ip_len;
    int64_t *tpos; /* slot -> its index in table (for O(1) delete) */
    /* open addressing, linear probe: value = slot, -1 empty, -2 tomb */
    int64_t *table;
    int64_t table_cap; /* power of two, >= 4 * capacity */
    int64_t tombs;
    /* free stack: pop from free_slots[free_top - 1] */
    int32_t *free_slots;
    int64_t free_top;
} sm_t;

static uint64_t sm_hash(const uint8_t *p, int64_t n) {
    uint64_t h = 1469598103934665603ULL;
    for (int64_t i = 0; i < n; i++) {
        h ^= p[i];
        h *= 1099511628211ULL;
    }
    return h;
}

static int64_t pow2_at_least(int64_t n) {
    int64_t c = 64;
    while (c < n)
        c <<= 1;
    return c;
}

/* insertion index for a key known to be ABSENT: first tombstone on the
 * probe path, else the terminating empty cell */
static int64_t sm_insert_pos(const sm_t *sm, const uint8_t *p, int64_t len) {
    uint64_t mask = (uint64_t)sm->table_cap - 1;
    uint64_t s = sm_hash(p, len) & mask;
    int64_t first_tomb = -1;
    for (;;) {
        int64_t v = sm->table[s];
        if (v == -1)
            return first_tomb >= 0 ? first_tomb : (int64_t)s;
        if (v == -2 && first_tomb < 0)
            first_tomb = (int64_t)s;
        s = (s + 1) & mask;
    }
}

static void sm_table_insert(sm_t *sm, int32_t slot) {
    int64_t pos = sm_insert_pos(sm, sm->ip[slot], sm->ip_len[slot]);
    if (sm->table[pos] == -2)
        sm->tombs--;
    sm->table[pos] = slot;
    sm->tpos[slot] = pos;
}

static int sm_table_rebuild(sm_t *sm, int64_t min_cap) {
    int64_t want = pow2_at_least(4 * min_cap);
    if (want != sm->table_cap) {
        int64_t *t = realloc(sm->table, sizeof(int64_t) * (size_t)want);
        if (!t)
            return -1;
        sm->table = t;
        sm->table_cap = want;
    }
    for (int64_t i = 0; i < sm->table_cap; i++)
        sm->table[i] = -1;
    sm->tombs = 0;
    for (int64_t s = 0; s < sm->capacity; s++)
        if (sm->ip[s])
            sm_table_insert(sm, (int32_t)s);
    return 0;
}

void *sm_create(int64_t capacity) {
    if (capacity < 1)
        return NULL;
    sm_t *sm = calloc(1, sizeof(sm_t));
    if (!sm)
        return NULL;
    sm->capacity = capacity;
    sm->ip = calloc((size_t)capacity, sizeof(uint8_t *));
    sm->ip_len = calloc((size_t)capacity, sizeof(int32_t));
    sm->tpos = calloc((size_t)capacity, sizeof(int64_t));
    sm->free_slots = malloc(sizeof(int32_t) * (size_t)capacity);
    sm->table_cap = pow2_at_least(4 * capacity);
    sm->table = malloc(sizeof(int64_t) * (size_t)sm->table_cap);
    if (!sm->ip || !sm->ip_len || !sm->tpos || !sm->free_slots || !sm->table) {
        free(sm->ip);
        free(sm->ip_len);
        free(sm->tpos);
        free(sm->free_slots);
        free(sm->table);
        free(sm);
        return NULL;
    }
    for (int64_t i = 0; i < sm->table_cap; i++)
        sm->table[i] = -1;
    /* pop order 0, 1, 2, ... — list(range(cap-1, -1, -1)).pop() parity */
    for (int64_t i = 0; i < capacity; i++)
        sm->free_slots[i] = (int32_t)(capacity - 1 - i);
    sm->free_top = capacity;
    return sm;
}

void sm_destroy(void *h) {
    sm_t *sm = h;
    if (!sm)
        return;
    for (int64_t s = 0; s < sm->capacity; s++)
        free(sm->ip[s]);
    free(sm->ip);
    free(sm->ip_len);
    free(sm->tpos);
    free(sm->free_slots);
    free(sm->table);
    free(sm);
}

void sm_clear(void *h) {
    sm_t *sm = h;
    for (int64_t s = 0; s < sm->capacity; s++) {
        free(sm->ip[s]);
        sm->ip[s] = NULL;
    }
    sm->assigned = 0;
    sm->tombs = 0;
    for (int64_t i = 0; i < sm->table_cap; i++)
        sm->table[i] = -1;
    for (int64_t i = 0; i < sm->capacity; i++)
        sm->free_slots[i] = (int32_t)(sm->capacity - 1 - i);
    sm->free_top = sm->capacity;
}

int64_t sm_assigned(void *h) { return ((sm_t *)h)->assigned; }

int64_t sm_free_count(void *h) { return ((sm_t *)h)->free_top; }

/* Extend to new_capacity.  New slots land at the BOTTOM of the free
 * stack (popped last, ascending) — matching the Python _grow_locked
 * free-list splice.  Returns 0 ok, -1 on allocation failure (manager
 * left at the old capacity, still consistent). */
int64_t sm_grow(void *h, int64_t new_capacity) {
    sm_t *sm = h;
    int64_t add = new_capacity - sm->capacity;
    if (add <= 0)
        return 0;
    uint8_t **ip = realloc(sm->ip, sizeof(uint8_t *) * (size_t)new_capacity);
    if (!ip)
        return -1;
    sm->ip = ip;
    int32_t *il = realloc(sm->ip_len, sizeof(int32_t) * (size_t)new_capacity);
    if (!il)
        return -1;
    sm->ip_len = il;
    int64_t *tp = realloc(sm->tpos, sizeof(int64_t) * (size_t)new_capacity);
    if (!tp)
        return -1;
    sm->tpos = tp;
    int32_t *fs =
        realloc(sm->free_slots, sizeof(int32_t) * (size_t)new_capacity);
    if (!fs)
        return -1;
    sm->free_slots = fs;
    memset(sm->ip + sm->capacity, 0, sizeof(uint8_t *) * (size_t)add);
    memmove(sm->free_slots + add, sm->free_slots,
            sizeof(int32_t) * (size_t)sm->free_top);
    for (int64_t i = 0; i < add; i++)
        sm->free_slots[i] = (int32_t)(new_capacity - 1 - i);
    sm->free_top += add;
    sm->capacity = new_capacity;
    if (sm->table_cap < 4 * new_capacity)
        /* rebuild OOM keeps the old table — denser but still valid
         * (assigned <= new_capacity <= table_cap / 2 after one double) */
        (void)sm_table_rebuild(sm, new_capacity);
    return 0;
}

/* Pass 1: resolve every ip.  Hits get their slot in slots_out and their
 * recency stamped seq (the Python loop's vectorized hit touch); misses
 * get slots_out = -1 and their index appended to miss_idx_out.  Returns
 * the miss count. */
int64_t sm_lookup_batch(void *h, const uint8_t *blob, const int64_t *offs,
                        const int64_t *lens, int64_t n, int64_t seq,
                        int64_t *last_used, int32_t *slots_out,
                        int64_t *miss_idx_out) {
    sm_t *sm = h;
    uint64_t mask = (uint64_t)sm->table_cap - 1;
    int64_t n_miss = 0;
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *p = blob + offs[i];
        int64_t len = lens[i];
        uint64_t s = sm_hash(p, len) & mask;
        int64_t slot = -1;
        for (;;) {
            int64_t v = sm->table[s];
            if (v == -1)
                break;
            if (v >= 0 && sm->ip_len[v] == (int32_t)len &&
                memcmp(sm->ip[v], p, (size_t)len) == 0) {
                slot = v;
                break;
            }
            s = (s + 1) & mask;
        }
        if (slot >= 0) {
            slots_out[i] = (int32_t)slot;
            last_used[slot] = seq;
        } else {
            slots_out[i] = -1;
            miss_idx_out[n_miss++] = i;
        }
    }
    return n_miss;
}

/* Read-only membership probe over a distinct-ip blob: like pass 1 but
 * WITHOUT the recency stamp — the admission gate must not refresh an
 * IP's LRU position just for asking whether it is resident (a refused
 * batch would otherwise keep every probe victim warm).  Writes 0/1 per
 * ip; returns the number present. */
int64_t sm_contains_batch(void *h, const uint8_t *blob, const int64_t *offs,
                          const int64_t *lens, int64_t n, uint8_t *out) {
    sm_t *sm = h;
    uint64_t mask = (uint64_t)sm->table_cap - 1;
    int64_t found = 0;
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *p = blob + offs[i];
        int64_t len = lens[i];
        uint64_t s = sm_hash(p, len) & mask;
        uint8_t hit = 0;
        for (;;) {
            int64_t v = sm->table[s];
            if (v == -1)
                break;
            if (v >= 0 && sm->ip_len[v] == (int32_t)len &&
                memcmp(sm->ip[v], p, (size_t)len) == 0) {
                hit = 1;
                break;
            }
            s = (s + 1) & mask;
        }
        out[i] = hit;
        found += hit;
    }
    return found;
}

typedef struct {
    int64_t lu;
    int32_t slot;
} sm_cand;

static int cand_cmp(const void *a, const void *b) {
    const sm_cand *x = a, *y = b;
    if (x->lu != y->lu)
        return x->lu < y->lu ? -1 : 1;
    return x->slot < y->slot ? -1 : (x->slot > y->slot ? 1 : 0);
}

/* Pass 2: place every miss, in ip order.  Free slots pop first; at
 * capacity the minimum-(last_used, slot) assigned, unpinned, untouched
 * slot is evicted (evict_out records them in order).  out_counts[0] =
 * evictions performed, out_counts[1] = misses successfully placed.
 * Returns 0, or -1 when an eviction was needed and every candidate is
 * pinned/touched (earlier misses stay placed and MUST be bookkept by
 * the caller — the Python refusal's partial-state semantics). */
int64_t sm_place_misses(void *h, const uint8_t *blob, const int64_t *offs,
                        const int64_t *lens, int64_t seq,
                        const int32_t *pin_counts, int64_t *last_used,
                        int32_t *slots_out, const int64_t *miss_idx,
                        int64_t n_miss, int64_t *evict_out,
                        int64_t *out_counts) {
    sm_t *sm = h;
    sm_cand *cand = NULL;
    int64_t cand_n = 0, cand_i = 0, n_evict = 0, placed = 0;
    int64_t rc = 0;
    for (int64_t m = 0; m < n_miss; m++) {
        int64_t i = miss_idx[m];
        int32_t slot;
        if (sm->free_top > 0) {
            slot = sm->free_slots[--sm->free_top];
        } else {
            if (!cand) {
                cand = malloc(sizeof(sm_cand) * (size_t)sm->capacity);
                if (!cand) {
                    rc = -1;
                    break;
                }
                for (int64_t s2 = 0; s2 < sm->capacity; s2++) {
                    if (sm->ip[s2] && pin_counts[s2] == 0 &&
                        last_used[s2] < seq) {
                        cand[cand_n].lu = last_used[s2];
                        cand[cand_n].slot = (int32_t)s2;
                        cand_n++;
                    }
                }
                qsort(cand, (size_t)cand_n, sizeof(sm_cand), cand_cmp);
            }
            slot = -1;
            while (cand_i < cand_n) {
                sm_cand c = cand[cand_i++];
                /* re-validate: the slot may have been consumed by an
                 * earlier eviction or touched by an earlier placement */
                if (!sm->ip[c.slot] || pin_counts[c.slot] != 0 ||
                    last_used[c.slot] >= seq || last_used[c.slot] != c.lu)
                    continue;
                slot = c.slot;
                break;
            }
            if (slot < 0) {
                rc = -1;
                break;
            }
            free(sm->ip[slot]);
            sm->ip[slot] = NULL;
            sm->table[sm->tpos[slot]] = -2;
            sm->tombs++;
            sm->assigned--;
            evict_out[n_evict++] = slot;
        }
        const uint8_t *p = blob + offs[i];
        int64_t len = lens[i];
        uint8_t *cp = malloc(len > 0 ? (size_t)len : 1);
        if (!cp) {
            /* undo nothing: the slot simply stays free/evicted; report
             * refusal so the caller retries smaller */
            if (sm->free_top < sm->capacity && sm->ip[slot] == NULL)
                sm->free_slots[sm->free_top++] = slot;
            rc = -1;
            break;
        }
        memcpy(cp, p, (size_t)len);
        sm->ip[slot] = cp;
        sm->ip_len[slot] = (int32_t)len;
        if ((sm->assigned + sm->tombs) * 2 > sm->table_cap)
            sm_table_rebuild(sm, sm->capacity);
        sm_table_insert(sm, slot);
        sm->assigned++;
        last_used[slot] = seq;
        slots_out[i] = slot;
        placed++;
    }
    free(cand);
    out_counts[0] = n_evict;
    out_counts[1] = placed;
    return rc;
}
