/* shmring.c — SPSC byte ring over POSIX shared memory, futex wakeup.
 *
 * A copy of banjax_tpu/native/shmring.c (same layout, so either package
 * attaches the other's ring).
 *
 * The fabric's co-located-shard transport (fabric/peer.py LinePipe):
 * one producer process writes whole wire frames, one consumer process
 * reads them, no TCP loopback, no syscall per byte.  Layout:
 *
 *   [0]  magic   u64   BANJRING — attach-time type check
 *   [8]  size    u64   data capacity in bytes (power of two)
 *   [16] head    u64   total bytes written  (producer-owned)
 *   [24] tail    u64   total bytes read     (consumer-owned)
 *   [32] wr_seq  u32   bumped after every publish  (consumer waits on it)
 *   [36] rd_seq  u32   bumped after every consume  (producer waits on it)
 *   [40..63]     reserved
 *   [64] data[size]
 *
 * Writes are all-or-nothing: ring_write blocks (futex with a bounded
 * slice, so a missed wake degrades to a poll, never a deadlock) until
 * the whole buffer fits, then copies and publishes with a release
 * store.  ring_read is exact-n-or-timeout.  Single producer, single
 * consumer — no locks anywhere, just acquire/release on head/tail.
 */

#include <errno.h>
#include <linux/futex.h>
#include <stdint.h>
#include <string.h>
#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>

#define RING_MAGIC 0x42414E4A52494E47ULL /* "BANJRING" */
#define RING_HEADER 64

typedef struct {
    uint64_t magic;
    uint64_t size;
    uint64_t head;
    uint64_t tail;
    uint32_t wr_seq;
    uint32_t rd_seq;
    uint8_t _pad[24];
} ring_hdr;

static int64_t now_ms(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)ts.tv_sec * 1000 + ts.tv_nsec / 1000000;
}

static void futex_wait_slice(uint32_t *addr, uint32_t val, int64_t slice_ms) {
    struct timespec ts;
    ts.tv_sec = slice_ms / 1000;
    ts.tv_nsec = (slice_ms % 1000) * 1000000;
    syscall(SYS_futex, addr, FUTEX_WAIT, val, &ts, NULL, 0);
}

static void futex_wake_all(uint32_t *addr) {
    syscall(SYS_futex, addr, FUTEX_WAKE, INT32_MAX, NULL, 0);
}

int64_t ring_init(void *base, int64_t capacity) {
    ring_hdr *h = (ring_hdr *)base;
    if (capacity <= 0 || (capacity & (capacity - 1)) != 0)
        return -1;
    memset(h, 0, sizeof(*h));
    h->size = (uint64_t)capacity;
    __atomic_store_n(&h->magic, RING_MAGIC, __ATOMIC_RELEASE);
    return 0;
}

int64_t ring_check(void *base) {
    ring_hdr *h = (ring_hdr *)base;
    if (__atomic_load_n(&h->magic, __ATOMIC_ACQUIRE) != RING_MAGIC)
        return -1;
    return (int64_t)h->size;
}

int64_t ring_readable(void *base) {
    ring_hdr *h = (ring_hdr *)base;
    uint64_t head = __atomic_load_n(&h->head, __ATOMIC_ACQUIRE);
    uint64_t tail = __atomic_load_n(&h->tail, __ATOMIC_ACQUIRE);
    return (int64_t)(head - tail);
}

/* All-or-nothing write of n bytes; 0 on success, -1 on timeout,
 * -2 if n can never fit (n > capacity). */
int64_t ring_write(void *base, const uint8_t *buf, int64_t n,
                   int64_t timeout_ms) {
    ring_hdr *h = (ring_hdr *)base;
    uint8_t *data = (uint8_t *)base + RING_HEADER;
    uint64_t size = h->size;
    if ((uint64_t)n > size)
        return -2;
    int64_t deadline = now_ms() + timeout_ms;
    uint64_t head = h->head; /* producer-owned: plain load is exact */
    for (;;) {
        uint32_t seq = __atomic_load_n(&h->rd_seq, __ATOMIC_ACQUIRE);
        uint64_t tail = __atomic_load_n(&h->tail, __ATOMIC_ACQUIRE);
        if (size - (head - tail) >= (uint64_t)n)
            break;
        int64_t left = deadline - now_ms();
        if (left <= 0)
            return -1;
        futex_wait_slice(&h->rd_seq, seq, left < 10 ? left : 10);
    }
    uint64_t pos = head & (size - 1);
    uint64_t first = size - pos;
    if (first > (uint64_t)n)
        first = (uint64_t)n;
    memcpy(data + pos, buf, first);
    memcpy(data, buf + first, (uint64_t)n - first);
    __atomic_store_n(&h->head, head + (uint64_t)n, __ATOMIC_RELEASE);
    __atomic_add_fetch(&h->wr_seq, 1, __ATOMIC_ACQ_REL);
    futex_wake_all(&h->wr_seq);
    return 0;
}

/* Exact-n read; 0 on success, -1 on timeout (nothing consumed). */
int64_t ring_read(void *base, uint8_t *buf, int64_t n, int64_t timeout_ms) {
    ring_hdr *h = (ring_hdr *)base;
    uint8_t *data = (uint8_t *)base + RING_HEADER;
    uint64_t size = h->size;
    if ((uint64_t)n > size)
        return -2;
    int64_t deadline = now_ms() + timeout_ms;
    uint64_t tail = h->tail; /* consumer-owned: plain load is exact */
    for (;;) {
        uint32_t seq = __atomic_load_n(&h->wr_seq, __ATOMIC_ACQUIRE);
        uint64_t head = __atomic_load_n(&h->head, __ATOMIC_ACQUIRE);
        if (head - tail >= (uint64_t)n)
            break;
        int64_t left = deadline - now_ms();
        if (left <= 0)
            return -1;
        futex_wait_slice(&h->wr_seq, seq, left < 10 ? left : 10);
    }
    uint64_t pos = tail & (size - 1);
    uint64_t first = size - pos;
    if (first > (uint64_t)n)
        first = (uint64_t)n;
    memcpy(buf, data + pos, first);
    if ((uint64_t)n > first)
        memcpy(buf + first, data, (uint64_t)n - first);
    __atomic_store_n(&h->tail, tail + (uint64_t)n, __ATOMIC_RELEASE);
    __atomic_add_fetch(&h->rd_seq, 1, __ATOMIC_ACQ_REL);
    futex_wake_all(&h->rd_seq);
    return 0;
}
