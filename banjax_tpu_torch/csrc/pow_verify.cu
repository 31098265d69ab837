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
// What bounds a dispatch. The challenge storm verifies one or two lanes
// at a time, and the caller waits for the count: a few microseconds of
// one thread on the card against the host steps around it. So the
// verifier's dispatch (`pow_verify_dispatch`) is one C call that
// launches the kernel on pinned, device-mapped host memory (the payload
// slots are read over PCIe where the host wrote them, the counts written
// straight back into pinned memory: no copy, no allocation), on a
// high-priority stream of the verifier's own, and waits for that stream
// alone. A dispatch is then bound by the launch, one PCIe round trip for
// the payload and one for the count, and the stream sync; work queued on
// other streams (the log path's chunk programs) is not waited for.
//
// What bounds the body. Integer operations, about 1,617 32-bit
// operations a lane (each three-input bitwise function counted as one
// LOP3; `POW_OPS` in chip_smoke.py) against 56 bytes of traffic; nothing
// is shared between lanes, so the kernel streams. The ALU pipe (16 lanes a
// sub-partition) runs the rotations, LOP3s and most adds, so its share of
// the instructions is the tighter bound; chip_smoke.py counts it in the
// SASS of the built library (sass_alu.count_pow).
//
// Design: one thread per lane, 256 threads a block for a batch (a
// dispatch of fewer lanes takes one block of whole warps), grid
// ceil(B / 256); the ragged edge is masked, so the host API takes any B.
// A row is 13 aligned 32-bit words, loaded once each and byte-swapped
// with __byte_perm. The 64 rounds and the schedule are unrolled at
// compile time (one template instance a round), with everything the
// padding fixes folded into constants: the padding words never occupy a
// register, K[i] + W[i] for i = 13..15 is an immediate, and
// sigma1(W14) = sigma0(W14) = 0, sigma1(W15), sigma0(W15) and sigma0(W13)
// are constants (schedule steps 16, 17, 28, 29 and 30). The IV is a
// constant too, so the compiler folds most of the first rounds. The last
// round computes only `a`: the digest's first word settles the count
// unless it is zero (one lane in 2^32), and only then does the out-of-line
// `tail_bits` add the words past it, each only while every word before it
// is zero. Rotations are funnel shifts; Ch and Maj one LOP3 each; the
// leading-zero count is __clz.
//
// -Xptxas -v (sm_90a, CUDA 12.8): 32 registers, no stack or spills. The
// SASS has 1,393 instructions a lane on the path to the store, 1,248 of
// them on the ALU pipe (652 SHF, 347 LOP3, 231 IADD3); about 1.1 times
// that pipe's bound at 1,048,576 lanes on an H100. Moving one rotation of
// each Sigma and sigma to the FMA pipe (mul.hi plus mad.lo by 2^(32-n))
// took the ALU count to 1,031 but the kernel from 0.0875 to 0.0915 ms at
// 1,048,576 lanes, so the rotations stay funnel shifts.

#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMsgBytes = 52;
constexpr int kMsgWords = kMsgBytes / 4;

// The tables live inside constexpr functions, so device code never names a
// host variable; every call below has a constant (or, once the rounds are
// unrolled, a folded) index, so each read is an immediate.
__host__ __device__ constexpr uint32_t k_of(int i) {
  constexpr uint32_t k[64] = {
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
  return k[i];
}

__host__ __device__ constexpr uint32_t h0_of(int i) {
  constexpr uint32_t h[8] = {
      0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
      0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u,
  };
  return h[i];
}

// The block's fixed words 13-15: the 0x80 terminator, zero, the bit length.
__host__ __device__ constexpr bool is_pad(int j) { return j >= kMsgWords && j < 16; }
__host__ __device__ constexpr uint32_t pad_of(int j) {
  return j == kMsgWords ? 0x80000000u : j == kMsgWords + 1 ? 0u : kMsgBytes * 8;
}

__host__ __device__ constexpr uint32_t rotr_c(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}
__host__ __device__ constexpr uint32_t sig0_c(uint32_t x) {
  return rotr_c(x, 7) ^ rotr_c(x, 18) ^ (x >> 3);
}
__host__ __device__ constexpr uint32_t sig1_c(uint32_t x) {
  return rotr_c(x, 17) ^ rotr_c(x, 19) ^ (x >> 10);
}

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }
__device__ __forceinline__ uint32_t sig0(uint32_t x) { return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3); }
__device__ __forceinline__ uint32_t sig1(uint32_t x) { return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10); }
__device__ __forceinline__ uint32_t Sig0(uint32_t a) { return rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22); }
__device__ __forceinline__ uint32_t Sig1(uint32_t e) { return rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25); }
__device__ __forceinline__ uint32_t ch(uint32_t e, uint32_t f, uint32_t g) { return g ^ (e & (f ^ g)); }
__device__ __forceinline__ uint32_t maj(uint32_t a, uint32_t b, uint32_t c) {
  return (a & b) | (c & (a | b));
}

struct State {
  uint32_t a, b, c, d, e, f, g, h;
};

// Schedule word W[J] (J < 16, or J - 16 steps back in the rolling window
// w), and sigma0 / sigma1 of it: a compile-time constant for a padding word.
template <int J>
__device__ __forceinline__ uint32_t word(const uint32_t (&w)[16]) {
  if constexpr (is_pad(J)) {
    constexpr uint32_t v = pad_of(J);
    return v;
  } else {
    return w[J & 15];
  }
}

template <int J>
__device__ __forceinline__ uint32_t sigma0_of(const uint32_t (&w)[16]) {
  if constexpr (is_pad(J)) {
    constexpr uint32_t v = sig0_c(pad_of(J));
    return v;
  } else {
    return sig0(w[J & 15]);
  }
}

template <int J>
__device__ __forceinline__ uint32_t sigma1_of(const uint32_t (&w)[16]) {
  if constexpr (is_pad(J)) {
    constexpr uint32_t v = sig1_c(pad_of(J));
    return v;
  } else {
    return sig1(w[J & 15]);
  }
}

// K[I] + W[I], with W[I] computed into the window for I >= 16.
template <int I>
__device__ __forceinline__ uint32_t k_plus_w(uint32_t (&w)[16]) {
  constexpr uint32_t k = k_of(I);
  if constexpr (I < 16) {
    if constexpr (is_pad(I)) {
      constexpr uint32_t kw = k + pad_of(I);
      return kw;
    } else {
      return k + w[I];
    }
  } else {
    const uint32_t wi = sigma1_of<I - 2>(w) + word<I - 7>(w) + sigma0_of<I - 15>(w) +
                        word<I - 16>(w);
    w[I & 15] = wi;
    return k + wi;
  }
}

template <int I>
__device__ __forceinline__ void round_step(State& s, uint32_t (&w)[16]) {
  const uint32_t t1 = s.h + Sig1(s.e) + ch(s.e, s.f, s.g) + k_plus_w<I>(w);
  const uint32_t t2 = Sig0(s.a) + maj(s.a, s.b, s.c);
  s.h = s.g;
  s.g = s.f;
  s.f = s.e;
  s.e = s.d + t1;
  s.d = s.c;
  s.c = s.b;
  s.b = s.a;
  s.a = t1 + t2;
}

template <int... I>
__device__ __forceinline__ void rounds(State& s, uint32_t (&w)[16], std::integer_sequence<int, I...>) {
  (round_step<I>(s, w), ...);
}

// The leading zero bits past a zero first digest word: words 1-7 of the
// digest are a62..a60 + H1..H3, d62 + t1 + H4 and e62..e60 + H5..H7
// (the state s before round 63), each counted while all before it are zero.
__device__ __noinline__ int tail_bits(State s, uint32_t t1) {
  const uint32_t rest[7] = {s.a + h0_of(1), s.b + h0_of(2), s.c + h0_of(3), s.d + t1 + h0_of(4),
                            s.e + h0_of(5), s.f + h0_of(6), s.g + h0_of(7)};
  int total = 0;
  for (int i = 0; i < 7; ++i) {
    total += __clz(rest[i]);
    if (rest[i] != 0u) break;
  }
  return total;
}

__global__ void __launch_bounds__(kThreads)
pow_verify_kernel(const uint8_t* __restrict__ msg, int32_t* __restrict__ out, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const uint32_t* row = reinterpret_cast<const uint32_t*>(msg + (size_t)lane * kMsgBytes);

  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < kMsgWords; ++i) w[i] = __byte_perm(row[i], 0, 0x0123);

  State s{h0_of(0), h0_of(1), h0_of(2), h0_of(3), h0_of(4), h0_of(5), h0_of(6), h0_of(7)};
  rounds(s, w, std::make_integer_sequence<int, 63>{});

  // round 63 computes only a
  const uint32_t t1 = s.h + Sig1(s.e) + ch(s.e, s.f, s.g) + k_plus_w<63>(w);
  const uint32_t first = t1 + Sig0(s.a) + maj(s.a, s.b, s.c) + h0_of(0);
  int total = __clz(first);
  if (first == 0u) total += tail_bits(s, t1);
  out[lane] = total;
}

// Makes `device` current for a call and gives the caller's back after.
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

cudaError_t launch(const void* msg, void* out, int B, cudaStream_t stream) {
  // a dispatch of a few lanes runs as one block of whole warps
  const int threads = B < kThreads ? (B + 31) / 32 * 32 : kThreads;
  pow_verify_kernel<<<(B + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const uint8_t*>(msg), static_cast<int32_t*>(out), B);
  return cudaGetLastError();
}

}  // namespace

// msg: [B, 52] uint8 on `device`, rows contiguous (4-byte aligned base);
// out: [B] int32 there. Launches on `stream` (a stream of `device`) and
// returns cudaGetLastError().
extern "C" int pow_verify_launch(const void* msg, void* out, int B, int device, void* stream) {
  if (B <= 0) return 0;
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  return (int)launch(msg, out, B, static_cast<cudaStream_t>(stream));
}

// The verifier's dispatch. msg_host: [B, 52] uint8 and out_host: [B] int32
// in pinned host memory mapped into `device`'s address space at the same
// pointers (pow_verify_check_mapped). Launches on `stream`, waits for that
// stream alone, and returns the first CUDA error (0 when the counts are in
// out_host).
extern "C" int pow_verify_dispatch(const void* msg_host, void* out_host, int B, int device,
                                   void* stream) {
  if (B <= 0) return 0;
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaError_t err = launch(msg_host, out_host, B, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
  return (int)err;
}

// 0 when `ptr` is host memory that `device` addresses at the same pointer
// (pinned and mapped under unified addressing); cudaErrorInvalidValue when
// it is not, or the CUDA error of the query.
extern "C" int pow_verify_check_mapped(const void* ptr, int device) {
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaPointerAttributes attr;
  const cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  if (err != cudaSuccess) return (int)err;
  const bool mapped = attr.type == cudaMemoryTypeHost && attr.hostPointer == ptr &&
                      attr.devicePointer == ptr;
  return mapped ? 0 : (int)cudaErrorInvalidValue;
}
