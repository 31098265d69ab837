// Batched SHA-256 proof-of-work check (kernel C), for Hopper.
//
// Replaces the Pallas TPU kernel `_pow_kernel` of
// banjax_tpu/matcher/kernels/pow_verify.py (via `_pow_call` and
// `leading_zero_bits_batch`). The sha-inv challenge accepts a cookie when
// the SHA-256 digest of hmac[20] || solution[32] starts with enough zero
// bits. That 52-byte message pads to a single 64-byte block: words 0-12
// are the message (big-endian), word 13 is 0x80000000, word 14 is 0 and
// word 15 is the bit length 416. Per lane the kernel runs the one
// compression from the fixed IV and writes the count of leading zero bits
// across the 8-word digest, as int32.
//
// Design: one thread per lane, 256 threads a block, grid ceil(B / 256);
// the ragged edge is masked, so the host API takes any B (the TPU
// kernel's 128-lane padding is gone). The kernel reads the packed
// [B, 52] uint8 messages directly: a row is 13 aligned 32-bit words,
// loaded once each and byte-swapped with __byte_perm, so the host does no
// packing and the host-to-device copy is 52 bytes a lane. The 64 rounds
// are fully unrolled with a rolling 16-word schedule in registers; K and
// the IV sit in constant memory (every thread of a warp reads the same word, which
// the constant cache broadcasts); rotations are funnel shifts, and Ch and
// Maj are written as single three-input logic expressions (LOP3). The
// leading-zero count is __clz per digest word, summed up to the first
// non-zero word.
//
// Bound on this card: integer operations. About 1,670 32-bit operations
// a lane, each three-input bitwise function counted as one LOP3 (64
// rounds of 17, 48 schedule steps of 11, the loads, swaps, digest adds
// and counts) against 56 bytes of traffic a lane; nothing is shared
// between lanes, so the kernel streams.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMsgBytes = 52;
constexpr int kMsgWords = kMsgBytes / 4;

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
    0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
    0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
    0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
    0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
    0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
    0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
    0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

__constant__ uint32_t kH0[8] = {
    0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

__device__ __forceinline__ uint32_t ch(uint32_t e, uint32_t f, uint32_t g) {
  return g ^ (e & (f ^ g));
}

__device__ __forceinline__ uint32_t maj(uint32_t a, uint32_t b, uint32_t c) {
  return (a & b) | (c & (a | b));
}

__global__ void __launch_bounds__(kThreads)
pow_verify_kernel(const uint8_t* __restrict__ msg, int32_t* __restrict__ out, int B) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= B) return;
  const uint32_t* row = reinterpret_cast<const uint32_t*>(msg + (size_t)lane * kMsgBytes);

  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < kMsgWords; ++i) w[i] = __byte_perm(__ldg(row + i), 0, 0x0123);
  w[13] = 0x80000000u;
  w[14] = 0u;
  w[15] = kMsgBytes * 8;

  uint32_t a = kH0[0], b = kH0[1], c = kH0[2], d = kH0[3];
  uint32_t e = kH0[4], f = kH0[5], g = kH0[6], h = kH0[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t wi;
    if (i < 16) {
      wi = w[i];
    } else {
      const uint32_t w15 = w[(i - 15) & 15];
      const uint32_t w2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wi = w[i & 15] + s0 + w[(i - 7) & 15] + s1;
      w[i & 15] = wi;
    }
    const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ch(e, f, g) + kK[i] + wi;
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + maj(a, b, c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }

  const uint32_t digest[8] = {a + kH0[0], b + kH0[1], c + kH0[2], d + kH0[3],
                              e + kH0[4], f + kH0[5], g + kH0[6], h + kH0[7]};
  int total = 0;
  bool live = true;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (live) total += __clz(digest[i]);
    live = live && digest[i] == 0u;
  }
  out[lane] = total;
}

}  // namespace

// msg: [B, 52] uint8, rows contiguous (4-byte aligned base); out: [B]
// int32. Returns cudaGetLastError().
extern "C" int pow_verify_launch(const void* msg, void* out, int B, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  pow_verify_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(msg), static_cast<int32_t*>(out), B);
  return (int)cudaGetLastError();
}
