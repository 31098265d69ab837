// Bit-parallel shift-and NFA scan over byte-class-encoded lines, for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` of
// banjax_tpu/matcher/kernels/nfa_match.py (built by `_build_raw_call`).
// It computes WHAT that kernel computes — the raw accept words of
// banjax_tpu/matcher/nfa_jax.py `nfa_scan` — without its TPU machinery:
// the one-hot int8 matmul that gathers `table[cls]` on the MXU, its -128
// bias and plane recombination, and the transposed [W, block] layout
// exist because the TPU has no fast gather. Here `table[cls][w]` is one
// shared-memory load.
//
// Per byte t of a line (len bytes, class ids cls[t]):
//   bm     = table[cls[t]][w]
//   carry  = bit 31 of word w-1's state before this byte (0 for a shard's
//            first word; dropped entirely when the ruleset is carry_free)
//   d      = ((((d << 1) | carry) & shift_in) | inject | (d & selfloop)) & bm
//   acc   |= d & acc_any;   after the line's last byte also acc |= d & acc_end
// where inject = inj_always | inj_start at t == 0, inj_always after.
//
// What bounds it. Each byte of a line is one dependent step per word, so a
// thread that walks one line at a time waits out the latency of every step
// (table load, carry exchange, the update) with nothing else in flight:
// ~200-270 cycles a step for the single-stage fallback, walked that way.
// The work is 8.8 ALU-pipe instructions per (line byte, word) with carries
// at R = 8 (12.75 at R = 2, 19 at R = 1) and 7.75 carry-free at R = 1,
// counted from this kernel's SASS by banjax_tpu_torch/matcher/kernels/
// sass_alu.py: the update (3 LOP3), the accept (1 LOP3), the carry's pack
// and unpack (2 SHF), the class-id extract (PRMT) and the loop's share.
// So a large batch (the fallback) is bound by the integer pipe, and a
// small one (stage 2) by its longest line's chain of steps, each a
// shuffle, a named barrier and the update.
//
// Design.
// * Line groups: a thread carries the state (d, acc) of R lines for its
//   word (R = template parameter, 1/2/4/8; the wrapper picks the most that
//   still fills the card twice over), so R independent chains are in
//   flight in every step. Each line stops at its own len (bytes past the
//   end never touch it) and ORs acc_end once, from its state after its
//   last byte.
// * Length order: `length_order_kernel` sorts the lines by length on the
//   card (stable, per tile of 4,096; one LSD radix pass per key bit), into
//   scratch the wrapper allocates. Group g holds lines order[g*R ..
//   g*R+R): the kernel reads line order[i]'s class ids and writes output
//   row order[i], with no gather and no unsort. A group's lines end
//   together, and teams walk the groups longest first. A step loop without
//   the per-line check runs to the group's shortest line, a checked one to
//   its longest. Groups of one line that all start at once skip the sort.
// * Teams with carries: a team is ceil(wps/32) warps covering one shard's
//   words. The carry of all R lines crosses lanes in ONE shuffle (bit r of
//   a packed word per lane) and crosses warps in one word through a
//   double-buffered shared edge and one named barrier (`bar.sync 1+team`)
//   per byte, so several teams share a block and its copy of the table.
//   Per group, the team stages the lines' class ids (clamped, two u16 a
//   word, interleaved so a byte pair of R lines is one 16-byte load) in
//   shared memory. The byte loop takes two bytes an iteration.
// * Carry-free teams are exactly wps threads, packed into blocks of about
//   256, with no barrier at all: each thread streams its lines' class ids
//   through L1 two bytes ahead of the update and loads the table row one
//   byte ahead.
// * Persistent blocks: a block copies its shard's [C, wps] table slab into
//   shared memory once, with cp.async (through the read-only cache when it
//   does not fit), and its teams walk many groups. The launcher queries an
//   instantiation's attributes once per device and its occupancy once per
//   (device, block size, shared memory), and caches both: later launches
//   query nothing.
//
// -Xptxas -v (sm_90a, CUDA 12.8), registers per instantiation, 0 bytes of
// stack and spills in every one: carry (R = 1, 2, 4, 8) 39, 44, 55, 71 with
// the table in shared memory and 41, 48, 56, 72 without; carry-free 40,
// 40, 64, 119 and 40, 48, 70, 128; length_order_kernel 29 and 16,512 bytes
// of static shared memory. Dynamic shared memory: the table slab (C * wps
// * 4 bytes, 104,052 at stage 2's 69 x 377) plus, with carries, a team's
// class ids, edge, lines and lengths ((R * (L/2 + 1) + 2 * warps + 2 * R)
// words, rounded up to 4).

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxNamedTeams = 15;  // bar.sync ids 1..15; 0 is __syncthreads
constexpr int kSortTile = 4096;     // lines sorted by one block (4 a thread)
constexpr int kSortKeyBits = 19;    // lengths above 2^19 - 1 sort as equal
constexpr int kFreeBlock = 256;     // threads of a carry-free block (one team at least)

// Dynamic shared memory, indexed directly (not through a generic pointer)
// so that every access compiles to one LDS/STS at a 32-bit address.
extern __shared__ __align__(16) uint32_t smem[];

__device__ __forceinline__ uint32_t smem_at(uint32_t byte_off) {
  return *reinterpret_cast<const uint32_t*>(reinterpret_cast<const char*>(smem) + byte_off);
}

struct Masks {
  uint32_t si, inj_a, inj_0, sl, aa, ae;  // shift_in, inject (t > 0, t == 0), selfloop, accepts
};

__device__ __forceinline__ Masks load_masks(const uint32_t* masks, int W, int gw, bool active) {
  Masks m{0u, 0u, 0u, 0u, 0u, 0u};
  if (active) {
    m.si = masks[gw];
    m.inj_a = masks[W + gw];
    m.inj_0 = m.inj_a | masks[2 * W + gw];
    m.sl = masks[3 * W + gw];
    m.aa = masks[4 * W + gw];
    m.ae = masks[5 * W + gw];
  }
  return m;
}

__device__ __forceinline__ uint32_t nfa_update(uint32_t shifted, uint32_t d, uint32_t inj,
                                               uint32_t bm, const Masks& m) {
  return (((shifted & m.si) | inj) | (d & m.sl)) & bm;
}

__device__ __forceinline__ int clamp_class(int32_t c, int C) { return min(max(c, 0), C - 1); }

__device__ __forceinline__ int clamp_len(int32_t n, int L) { return min(max(n, 0), L); }

// One shard's [C, wps] slab of the table into shared memory at word tab0,
// as 4-byte cp.async copies that are all in flight at once (the slab's rows
// are wps words at offset shard * wps of the table's W-word rows).
template <bool kSmemTable>
__device__ __forceinline__ void stage_table(int tab0, const uint32_t* table, int C, int W,
                                            int wps, int shard) {
  if (kSmemTable) {
    const int rows_per_pass = blockDim.x / wps;
    const int r0 = threadIdx.x / wps;
    const int w = threadIdx.x - r0 * wps;
    if (r0 < rows_per_pass) {
      const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem + tab0) + 4u * (uint32_t)w;
      const uint32_t* src = table + (size_t)shard * wps + w;
      for (int c = r0; c < C; c += rows_per_pass) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst + 4u * (uint32_t)(c * wps)),
                     "l"(src + (size_t)c * W)
                     : "memory");
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
  __syncthreads();
}

// The line at place i of the length order (identity when there is none).
__device__ __forceinline__ int line_at(const int32_t* order, int i) { return order ? order[i] : i; }

// Row c of this thread's column of the table: in shared memory at byte
// tab_b + c * stride_b, else in device memory at tab_g[c * stride_g].
struct TableCol {
  uint32_t tab_b, stride_b;
  const uint32_t* tab_g;
  int stride_g;
};

template <bool kSmemTable>
__device__ __forceinline__ uint32_t table_row(const TableCol& tc, uint32_t c) {
  return kSmemTable ? smem_at(tc.tab_b + c * tc.stride_b) : __ldg(tc.tab_g + c * tc.stride_g);
}

__device__ __forceinline__ void team_sync(int id, int nthreads) {
  if (nthreads == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
  }
}

// ---------------------------------------------------------------- length order

// order[base + i] for the tile of up to kSortTile lines at base: the line
// indices of the tile in ascending clamped length, stable. One block a
// tile; an LSD radix sort one key bit a pass (a block-wide prefix sum of
// the zeros, then a stable split through shared memory), keys packed with
// the line's index in the tile: key << 12 | index.
__global__ void __launch_bounds__(kMaxThreads)
length_order_kernel(const int32_t* __restrict__ lens, int B, int L, int key_bits,
                    int32_t* __restrict__ order) {
  __shared__ uint32_t buf[kSortTile];
  __shared__ int warp_zeros[kMaxThreads / 32];
  const int base = blockIdx.x * kSortTile;
  const int n = min(kSortTile, B - base);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t key_max = (1u << kSortKeyBits) - 1u;
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = tid * 4 + j;
    // past the tile's end: all-ones keys, already last, stay last
    v[j] = e < n ? (min((uint32_t)clamp_len(lens[base + e], L), key_max) << 12) | (uint32_t)e
                 : 0xffffffffu;
  }
  for (int bit = 12; bit < 12 + key_bits; ++bit) {
    int zeros = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) zeros += ((v[j] >> bit) & 1u) ? 0 : 1;
    int incl = zeros;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_zeros[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int x = warp_zeros[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      warp_zeros[lane] = x;
    }
    __syncthreads();
    const int total = warp_zeros[kMaxThreads / 32 - 1];
    int z = incl - zeros + (warp ? warp_zeros[warp - 1] : 0);  // zeros before me
    int o = total + tid * 4 - z;                               // where my ones go
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if ((v[j] >> bit) & 1u) buf[o++] = v[j];
      else buf[z++] = v[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = buf[tid * 4 + j];
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = tid * 4 + j;
    if (e < n) order[base + e] = base + (int)(v[j] & 0xfffu);
  }
}

// ---------------------------------------------------------------- carries

struct CarryTeam {
  int cls0;      // word offset of [Lw][R] staged class ids: word q*R + r holds line
                 // r's class ids 2q (low half) and 2q+1 (high half)
  int edge0;     // word offset of [2][n_warps] packed carry words
  int lane, warp, n_warps, bar_id, tw;
};

// The R words holding step pair q's class ids, in 16-byte loads.
template <int R>
__device__ __forceinline__ void load_class_words(uint32_t (&cw)[R], int at) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int r = 0; r < R; r += 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(smem + at + r);
      cw[r] = x.x;
      cw[r + 1] = x.y;
      cw[r + 2] = x.z;
      cw[r + 3] = x.w;
    }
  } else if constexpr (R == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(smem + at);
    cw[0] = x.x;
    cw[1] = x.y;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) cw[r] = smem[at + r];
  }
}

// One byte t of the group's R lines: half kHi of cw holds their class ids.
template <int R, bool kSmemTable, bool kPred, int kHi>
__device__ __forceinline__ void carry_step(int t, uint32_t inj, const uint32_t (&cw)[R],
                                           uint32_t (&d)[R], uint32_t (&acc)[R],
                                           const int (&len)[R], const CarryTeam& k,
                                           const TableCol& tc, const Masks& m, int& buf) {
  uint32_t bm[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    bm[r] = table_row<kSmemTable>(tc, __byte_perm(cw[r], 0u, kHi ? 0x4432u : 0x4410u));
  // bit 31 of every line's state, packed: line 0 in bit R-1 ... line R-1 in bit 0
  uint32_t p = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) p = __funnelshift_l(d[r], p, 1);
  uint32_t up = __shfl_up_sync(0xffffffffu, p, 1);
  if (k.n_warps > 1) {
    const int e = k.edge0 + buf * k.n_warps;
    if (k.lane == 31) smem[e + k.warp] = p;
    team_sync(k.bar_id, k.tw);
    if (k.lane == 0) up = k.warp ? smem[e + k.warp - 1] : 0u;
    buf ^= 1;
  } else if (k.lane == 0) {
    up = 0u;
  }
  uint32_t q = up << (32 - R);  // line r's carry reaches bit 31 after r shifts
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t shifted = __funnelshift_l(q, d[r], 1);  // (d << 1) | carry
    q <<= 1;
    const uint32_t nd = nfa_update(shifted, d[r], inj, bm[r], m);
    if (!kPred || t < len[r]) {
      d[r] = nd;
      acc[r] |= nd & m.aa;
    }
  }
}

// Bytes [t0, t1) of the group's lines, two at a time: each pair's class
// ids come in one load of R words (two u16 each).
template <int R, bool kSmemTable, bool kPred>
__device__ __forceinline__ void carry_steps(int t0, int t1, uint32_t (&d)[R],
                                            uint32_t (&acc)[R], const int (&len)[R],
                                            const CarryTeam& k, const TableCol& tc,
                                            const Masks& m, int& buf) {
  uint32_t cw[R];
  int t = t0;
  if (t < t1 && (t & 1)) {  // the second byte of a pair begun before t0
    load_class_words<R>(cw, k.cls0 + (t >> 1) * R);
    carry_step<R, kSmemTable, kPred, 1>(t, m.inj_a, cw, d, acc, len, k, tc, m, buf);
    ++t;
  }
  for (; t + 1 < t1; t += 2) {
    load_class_words<R>(cw, k.cls0 + (t >> 1) * R);
    carry_step<R, kSmemTable, kPred, 0>(t, t ? m.inj_a : m.inj_0, cw, d, acc, len, k, tc, m,
                                        buf);
    carry_step<R, kSmemTable, kPred, 1>(t + 1, m.inj_a, cw, d, acc, len, k, tc, m, buf);
  }
  if (t < t1) {
    load_class_words<R>(cw, k.cls0 + (t >> 1) * R);
    carry_step<R, kSmemTable, kPred, 0>(t, t ? m.inj_a : m.inj_0, cw, d, acc, len, k, tc, m,
                                        buf);
  }
}

// Words of shared memory a team needs: class ids 0..L of R lines, the
// carry edge, the group's lines and lengths; a multiple of 4 so every
// team's class ids stay 16-byte aligned.
__host__ __device__ inline int team_words(int R, int L, int n_warps) {
  return ((R * (L / 2 + 1) + 2 * n_warps + 2 * R) + 3) & ~3;
}

template <int R, bool kSmemTable>
__global__ void nfa_carry_kernel(const int32_t* __restrict__ cls, long long ld,
                                 const int32_t* __restrict__ lens,
                                 const int32_t* __restrict__ order,
                                 const uint32_t* __restrict__ table,  // [C, W]
                                 const uint32_t* __restrict__ masks,  // [6, W]
                                 uint32_t* __restrict__ out,          // [B, W]
                                 int B, int L, int C, int W, int wps, int tw, int teams) {
  const int shard = blockIdx.y;
  const int team = threadIdx.x / tw;
  const int w = threadIdx.x - team * tw;
  const bool active = w < wps;
  CarryTeam k;
  k.lane = w & 31;
  k.warp = w >> 5;
  k.n_warps = tw >> 5;
  k.bar_id = 1 + team;
  k.tw = tw;
  const int Lw = L / 2 + 1;  // class-id pairs 0..L/2
  k.cls0 = team * team_words(R, L, k.n_warps);
  k.edge0 = k.cls0 + R * Lw;
  const int tab0 = teams * team_words(R, L, k.n_warps);

  stage_table<kSmemTable>(tab0, table, C, W, wps, shard);
  const Masks m = load_masks(masks, W, shard * wps + w, active);
  // an idle thread reads a valid column; its zero masks keep its state 0
  const int col = active ? w : 0;
  TableCol tc;
  tc.tab_b = 4u * (uint32_t)(tab0 + col);
  tc.stride_b = 4u * (uint32_t)wps;
  tc.tab_g = table + (size_t)shard * wps + col;
  tc.stride_g = W;

  const int rows0 = k.edge0 + 2 * k.n_warps;  // the group's lines [R], then lengths [R]
  const int lens0 = rows0 + R;
  const int n_groups = (B + R - 1) / R;
  const int n_teams = gridDim.x * teams;
  int buf = 0;
  for (int g = n_groups - 1 - (blockIdx.x * teams + team); g >= 0; g -= n_teams) {
    team_sync(k.bar_id, tw);  // the previous group's readers are done
    if (w < R) {  // thread w fetches the group's line w and its length
      const int i = g * R + w;
      const int row = i < B ? line_at(order, i) : -1;
      smem[rows0 + w] = (uint32_t)row;
      smem[lens0 + w] = row >= 0 ? (uint32_t)clamp_len(lens[row], L) : 0u;
    }
    team_sync(k.bar_id, tw);
    int len[R];
    int minlen = L, maxlen = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      len[r] = (int)smem[lens0 + r];
      minlen = min(minlen, len[r]);
      maxlen = max(maxlen, len[r]);
    }
    // stage class ids 0..maxlen of the group's lines (0 past a line's end)
    const int nw = maxlen / 2 + 1;
#pragma unroll 2
    for (int idx = w; idx < R * nw; idx += tw) {
      const int q = idx / R;
      const int r = idx - q * R;
      const int row = (int)smem[rows0 + r];
      const int n = (int)smem[lens0 + r];
      const int t0 = 2 * q;
      const int32_t* p = cls + (long long)row * ld;
      const uint32_t c0 = t0 < n ? (uint32_t)clamp_class(p[t0], C) : 0u;
      const uint32_t c1 = t0 + 1 < n ? (uint32_t)clamp_class(p[t0 + 1], C) : 0u;
      smem[k.cls0 + idx] = c0 | (c1 << 16);
    }
    team_sync(k.bar_id, tw);

    uint32_t d[R], acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) d[r] = acc[r] = 0u;
    carry_steps<R, kSmemTable, false>(0, minlen, d, acc, len, k, tc, m, buf);
    carry_steps<R, kSmemTable, true>(minlen, maxlen, d, acc, len, k, tc, m, buf);

    if (active) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = (int)smem[rows0 + r];
        if (row >= 0) out[(long long)row * W + shard * wps + w] = acc[r] | (d[r] & m.ae);
      }
    }
  }
}

// ---------------------------------------------------------------- carry-free

template <int R, bool kSmemTable, bool kPred>
__device__ __forceinline__ void free_steps(int t0, int t1, uint32_t (&d)[R],
                                           uint32_t (&acc)[R], uint32_t (&bm)[R],
                                           uint32_t (&c1)[R], const int (&len)[R],
                                           const int32_t* const (&p)[R], int C,
                                           const TableCol& tc, const Masks& m) {
  for (int t = t0; t < t1; ++t) {
    const uint32_t inj = t == 0 ? m.inj_0 : m.inj_a;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // class id two steps ahead, table row one step ahead
      const uint32_t c2 = t + 2 < len[r] ? (uint32_t)clamp_class(__ldg(p[r] + t + 2), C) : 0u;
      const uint32_t bm_next = table_row<kSmemTable>(tc, c1[r]);
      const uint32_t nd = nfa_update(d[r] << 1, d[r], inj, bm[r], m);
      if (!kPred || t < len[r]) {
        d[r] = nd;
        acc[r] |= nd & m.aa;
      }
      bm[r] = bm_next;
      c1[r] = c2;
    }
  }
}

template <int R, bool kSmemTable>
__global__ void nfa_free_kernel(const int32_t* __restrict__ cls, long long ld,
                                const int32_t* __restrict__ lens,
                                const int32_t* __restrict__ order,
                                const uint32_t* __restrict__ table,
                                const uint32_t* __restrict__ masks,
                                uint32_t* __restrict__ out,
                                int B, int L, int C, int W, int wps, int teams) {
  const int shard = blockIdx.y;
  stage_table<kSmemTable>(0, table, C, W, wps, shard);
  const int team = threadIdx.x / wps;
  if (team >= teams) return;
  const int w = threadIdx.x - team * wps;
  const Masks m = load_masks(masks, W, shard * wps + w, true);
  TableCol tc;
  tc.tab_b = 4u * (uint32_t)w;
  tc.stride_b = 4u * (uint32_t)wps;
  tc.tab_g = table + (size_t)shard * wps + w;
  tc.stride_g = W;

  const int n_groups = (B + R - 1) / R;
  const int n_teams = gridDim.x * teams;
  for (int g = n_groups - 1 - (blockIdx.x * teams + team); g >= 0; g -= n_teams) {
    const int32_t* p[R];
    int len[R];
    uint32_t d[R], acc[R], bm[R], c1[R];
    int minlen = L, maxlen = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = g * R + r;
      const long long row = i < B ? line_at(order, i) : 0;
      len[r] = i < B ? clamp_len(lens[row], L) : 0;
      p[r] = cls + row * ld;
      minlen = min(minlen, len[r]);
      maxlen = max(maxlen, len[r]);
      d[r] = acc[r] = 0u;
      const uint32_t c0 = 0 < len[r] ? (uint32_t)clamp_class(__ldg(p[r]), C) : 0u;
      bm[r] = table_row<kSmemTable>(tc, c0);
      c1[r] = 1 < len[r] ? (uint32_t)clamp_class(__ldg(p[r] + 1), C) : 0u;
    }
    free_steps<R, kSmemTable, false>(0, minlen, d, acc, bm, c1, len, p, C, tc, m);
    free_steps<R, kSmemTable, true>(minlen, maxlen, d, acc, bm, c1, len, p, C, tc, m);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = g * R + r;
      if (i < B) out[(long long)line_at(order, i) * W + shard * wps + w] = acc[r] | (d[r] & m.ae);
    }
  }
}

// ---------------------------------------------------------------- launch

// Launch settings belong to a device's context, so every cache is keyed
// by the device.
struct Configured {
  const void* fn;
  int device, max_threads;
};

struct Occupancy {
  const void* fn;
  int device, threads, smem, per_sm;
};

constexpr int kMaxDevices = 64;

std::mutex g_mu;
int g_sms[kMaxDevices];
Configured g_configured[256];  // instantiations whose attributes are set
int g_n_configured = 0;
Occupancy g_occ[256];
int g_n_occ = 0;

// Makes `device` current for a launch and gives the caller's back after.
struct DeviceScope {
  int prev = -1, device;
  cudaError_t err;
  explicit DeviceScope(int d) : device(d) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (prev >= 0 && prev != device) cudaSetDevice(prev);
  }
};

// The largest block an instantiation can run (its registers bound it); the
// first call on a device sets its shared-memory limit there and reads its
// attributes and the device's multiprocessor count.
cudaError_t max_threads_of(const void* fn, int device, int* max_threads) {
  std::lock_guard<std::mutex> lock(g_mu);
  for (int i = 0; i < g_n_configured; ++i) {
    if (g_configured[i].fn == fn && g_configured[i].device == device) {
      *max_threads = g_configured[i].max_threads;
      return cudaSuccess;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemLimit);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, fn)) != cudaSuccess) return err;
  if (g_sms[device] == 0 &&
      (err = cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return err;
  if (g_n_configured == 256) return cudaErrorUnknown;
  g_configured[g_n_configured++] = Configured{fn, device, attr.maxThreadsPerBlock};
  *max_threads = attr.maxThreadsPerBlock;
  return cudaSuccess;
}

// Resident blocks of fn on the device at this block size and shared memory
// (cached: one occupancy query per instantiation, device, block size and
// size).
cudaError_t resident_blocks(const void* fn, int device, int threads, int smem, int* blocks) {
  std::lock_guard<std::mutex> lock(g_mu);
  for (int i = 0; i < g_n_occ; ++i) {
    const Occupancy& o = g_occ[i];
    if (o.fn == fn && o.device == device && o.threads == threads && o.smem == smem) {
      *blocks = g_sms[device] * o.per_sm;
      return cudaSuccess;
    }
  }
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return err;
  per_sm = per_sm > 0 ? per_sm : 1;
  if (g_n_occ < 256) g_occ[g_n_occ++] = Occupancy{fn, device, threads, smem, per_sm};
  *blocks = g_sms[device] * per_sm;
  return cudaSuccess;
}

struct Problem {
  const int32_t* cls;
  long long ld;
  const int32_t* lens;
  int32_t* order;
  const uint32_t* table;
  const uint32_t* masks;
  uint32_t* out;
  int B, L, C, W, n_shards;
  int device;
  cudaStream_t stream;
};

int grid_x(int n_groups, int teams, int n_shards, int resident) {
  const int want = (n_groups + teams - 1) / teams;
  return max(1, min(want, max(1, resident / n_shards)));
}

// The length order, when it can help: groups of several lines end
// together, and teams that walk several groups take the longest first.
// Groups of one line that all start at once need no order, and R = 1 may
// go without (null: the lines in their own order).
const int32_t* length_order(const Problem& pb, int R, int n_groups, int teams_launched) {
  if (R == 1 && (pb.order == nullptr || n_groups <= teams_launched)) return nullptr;
  const int key_max = min(pb.L, (1 << kSortKeyBits) - 1);
  int key_bits = 1;
  while ((1 << key_bits) <= key_max) ++key_bits;
  length_order_kernel<<<(pb.B + kSortTile - 1) / kSortTile, kMaxThreads, 0, pb.stream>>>(
      pb.lens, pb.B, pb.L, key_bits, pb.order);
  return pb.order;
}

template <int R, bool kSmemTable>
cudaError_t launch_carry(const Problem& pb, int teams_cap) {
  const int wps = pb.W / pb.n_shards;
  const int tw = ((wps + 31) / 32) * 32;
  const void* fn = reinterpret_cast<const void*>(&nfa_carry_kernel<R, kSmemTable>);
  int max_threads = 0;
  cudaError_t err = max_threads_of(fn, pb.device, &max_threads);
  if (err != cudaSuccess) return err;
  const int n_groups = (pb.B + R - 1) / R;
  int teams = min(min(teams_cap, max_threads / tw), n_groups);
  if (tw > 32) teams = min(teams, kMaxNamedTeams);
  if (teams < 1) return cudaErrorInvalidConfiguration;
  const size_t tab = kSmemTable ? (size_t)pb.C * wps * 4 : 0;
  const int smem_bytes = (int)(tab + (size_t)teams * team_words(R, pb.L, tw / 32) * 4);
  int resident = 0;
  err = resident_blocks(fn, pb.device, teams * tw, smem_bytes, &resident);
  if (err != cudaSuccess) return err;
  const dim3 grid(grid_x(n_groups, teams, pb.n_shards, resident), pb.n_shards);
  const int32_t* order = length_order(pb, R, n_groups, grid.x * teams);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  nfa_carry_kernel<R, kSmemTable><<<grid, teams * tw, smem_bytes, pb.stream>>>(
      pb.cls, pb.ld, pb.lens, order, pb.table, pb.masks, pb.out, pb.B, pb.L, pb.C, pb.W, wps,
      tw, teams);
  return cudaGetLastError();
}

template <int R, bool kSmemTable>
cudaError_t launch_free(const Problem& pb) {
  const int wps = pb.W / pb.n_shards;
  const void* fn = reinterpret_cast<const void*>(&nfa_free_kernel<R, kSmemTable>);
  int max_threads = 0;
  cudaError_t err = max_threads_of(fn, pb.device, &max_threads);
  if (err != cudaSuccess) return err;
  const int n_groups = (pb.B + R - 1) / R;
  // blocks of about kFreeBlock threads: many blocks to an SM, so a batch
  // whose groups all fit on the card starts them all at once
  const int teams = min(min(max_threads, max(kFreeBlock, wps)) / wps, n_groups);
  if (teams < 1) return cudaErrorInvalidConfiguration;
  const int threads = ((teams * wps + 31) / 32) * 32;
  const int smem_bytes = kSmemTable ? pb.C * wps * 4 : 0;
  int resident = 0;
  err = resident_blocks(fn, pb.device, threads, smem_bytes, &resident);
  if (err != cudaSuccess) return err;
  const dim3 grid(grid_x(n_groups, teams, pb.n_shards, resident), pb.n_shards);
  const int32_t* order = length_order(pb, R, n_groups, grid.x * teams);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  nfa_free_kernel<R, kSmemTable><<<grid, threads, smem_bytes, pb.stream>>>(
      pb.cls, pb.ld, pb.lens, order, pb.table, pb.masks, pb.out, pb.B, pb.L, pb.C, pb.W, wps,
      teams);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_r(const Problem& pb, bool carry) {
  const int wps = pb.W / pb.n_shards;
  const size_t tab = (size_t)pb.C * wps * 4;
  if (!carry) return tab <= (size_t)kSmemLimit ? launch_free<R, true>(pb) : launch_free<R, false>(pb);
  // with carries: the table in shared memory beside as many teams as fit
  const size_t per_team = (size_t)team_words(R, pb.L, (wps + 31) / 32) * 4;
  if (tab + per_team <= (size_t)kSmemLimit)
    return launch_carry<R, true>(pb, (int)(((size_t)kSmemLimit - tab) / per_team));
  if (per_team > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  return launch_carry<R, false>(pb, (int)((size_t)kSmemLimit / per_team));
}

}  // namespace

// cls: [B, L] int32 class ids with row stride cls_ld (elements); lens: [B]
// int32; order: [B] int32 scratch, filled here with the line indices in
// ascending length (stable within each tile of 4,096 lines) unless groups
// of one line all start at once, or null when lines_per_thread is 1;
// table: [C, W]
// uint32 (W = n_shards * wps); masks: [6, W] uint32; out: [B, W] uint32 raw
// accept words; lines_per_thread: R, one of 1, 2, 4, 8. Launches the sort
// and the scan on `stream`, a stream of `device`, the device all the
// pointers are on; returns cudaGetLastError() after them.
extern "C" int nfa_scan_launch(const void* cls, long long cls_ld, const void* lens, void* order,
                               const void* table, const void* masks, void* out, int B, int L,
                               int C, int W, int n_shards, int carry, int lines_per_thread,
                               int device, void* stream) {
  if (B <= 0) return 0;
  if (n_shards <= 0 || W % n_shards != 0 || W / n_shards > kMaxThreads || C <= 0 || L < 0 ||
      C > 65536 || (lines_per_thread & (lines_per_thread - 1)) != 0 || lines_per_thread > 8 ||
      lines_per_thread < 1 || (order == nullptr && lines_per_thread > 1))
    return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaError_t err;
  const Problem pb{static_cast<const int32_t*>(cls), cls_ld,
                   static_cast<const int32_t*>(lens), static_cast<int32_t*>(order),
                   static_cast<const uint32_t*>(table), static_cast<const uint32_t*>(masks),
                   static_cast<uint32_t*>(out), B, L, C, W, n_shards, device,
                   static_cast<cudaStream_t>(stream)};
  switch (lines_per_thread) {
    case 1: err = launch_r<1>(pb, carry != 0); break;
    case 2: err = launch_r<2>(pb, carry != 0); break;
    case 4: err = launch_r<4>(pb, carry != 0); break;
    case 8: err = launch_r<8>(pb, carry != 0); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
