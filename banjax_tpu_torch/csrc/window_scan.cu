// The fixed-window recurrence over key-sorted window events, for Hopper.
//
// Replaces the Pallas TPU kernel `_scan_kernel` of
// banjax_tpu/matcher/kernels/fused_match_window.py (via `_scan_call` and
// `window_scan`), which runs banjax_tpu/matcher/windows.py `_window_step`
// as one sequential loop over all E events. Per event k, with carry
// (hits, start_s, start_ns):
//   b      : reload (h0, s0, n0, have) = (g_hits, g_ss, g_sns, g_valid);
//            otherwise (carry, have = true)
//   restart when !have or ts - start > interval (int32 (s, ns) pairs with
//   borrow); else hits + 1. exceeded = hits > limit, then hits := 0.
//   match_type = 0 (!have), 1 (outside), 2 (inside).
//   A pad event writes these outputs but leaves the carry unchanged and
//   reports the carry as its (hits, start_s, start_ns).
//
// What bounds it. The recurrence is serial only within a carry segment
// (a run of non-pad events from a boundary to the next), so the least
// time is the longest segment's chain of dependent steps, about 8
// dependent integer operations each; the bytes (52 an event: 8 int32
// columns and 3 flag bytes in, 4 int32 columns and a flag byte out) and the
// operations (SCAN_OPS in chip_smoke.py) are far below that at the
// matcher's sizes. Walked from device memory (an event's index, then ten
// fields at it), the longest segment costs one global round trip a step.
//
// Design. One block of 1024 threads walks the events in tiles of 4,096
// (4 per thread), in order:
// 1. Each thread loads its 4 events' 8 int32 columns with 16-byte loads
//    and the b / g_valid / pad flags as bytes (the bytes of torch.bool),
//    all before the prefix sum, so the loads overlap it. A thread whose
//    group of 4 is cut by the end of the events loads element by element
//    and touches nothing past the last event.
// 2. A block-wide prefix sum of (non-pad, boundary) counts, packed in one
//    int, gives every event its place in a stable partition: non-pad
//    events first, in order, then the pads. The thread scatters its
//    events' fields to those places in shared memory (and keeps the
//    places in registers for step 5), with the boundary positions (the
//    segment starts) and, for a pad, the position of the last non-pad
//    event before it (`aux`).
// 3. One thread walks each segment over consecutive shared-memory
//    positions. Only a segment's first event can reload, so the loop
//    reads five fields an event, issued one event ahead of the step that
//    needs them; each step writes its outputs over its own dead inputs.
//    The tile's first segment, when it does not start at a boundary,
//    continues the previous tile's carry (kept in shared memory), which
//    makes any E exact.
// 4. Every pad event computes its outputs in parallel from the carry left
//    at its previous non-pad position (or the tile's incoming carry).
// 5. Each thread writes its 4 events' outputs back in event order with
//    16-byte stores (element by element for a cut group); `exceeded` as
//    one byte each (a torch.bool).
// Shared memory: 38 bytes an event, 155,648 for a full tile.
//
// -Xptxas -v (sm_90a, CUDA 12.8): 58 registers (the bound of 1,024-thread
// blocks is 64), 0 bytes of stack and spills, 144 bytes of static shared
// memory beside the dynamic tile.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 1024;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr uint32_t kNsPerS = 1000000000u;
constexpr int kBytesPerEvent = 9 * 4 + 2;  // 8 columns, aux; b, g_valid

enum Col { GH, GS, GN, TS, TN, LIM, IVS, IVN, kCols };

struct Args {
  const int32_t* in[kCols];  // g_hits, g_ss, g_sns, e_ts_s, e_ts_ns, limit, iv_s, iv_ns
  const uint8_t* b;
  const uint8_t* gv;
  const uint8_t* pad;
  int32_t* out[4];  // hits, start_s, start_ns, match_type
  uint8_t* ex;
  int E;
  int T;  // tile capacity: min(E, kTile)
};

struct Carry {
  int32_t h, s, n;
};

struct Out {
  int32_t h, s, n, mt, ex;
};

__device__ __forceinline__ Out step(bool b, int32_t gh, int32_t gs, int32_t gn, bool gv,
                                    int32_t ts, int32_t tn, int32_t lim, int32_t ivs,
                                    int32_t ivn, bool pad, Carry c) {
  const int32_t h0 = b ? gh : c.h;
  const int32_t s0 = b ? gs : c.s;
  const int32_t n0 = b ? gn : c.n;
  const bool have = b ? gv : true;
  // (ts, tn) - (s0, n0) with borrow, in wrapping 32-bit arithmetic
  int32_t ds = (int32_t)((uint32_t)ts - (uint32_t)s0);
  int32_t dns = (int32_t)((uint32_t)tn - (uint32_t)n0);
  if (dns < 0) {
    ds = (int32_t)((uint32_t)ds - 1u);
    dns = (int32_t)((uint32_t)dns + kNsPerS);
  }
  const bool outside = have && ((ds > ivs) || (ds == ivs && dns > ivn));
  const bool restart = !have || outside;
  const int32_t h1 = restart ? 1 : (int32_t)((uint32_t)h0 + 1u);
  Out o;
  o.s = restart ? ts : s0;
  o.n = restart ? tn : n0;
  const bool exceeded = h1 > lim;
  o.h = exceeded ? 0 : h1;
  o.mt = !have ? 0 : (outside ? 1 : 2);
  o.ex = exceeded ? 1 : 0;
  if (pad) {
    o.h = c.h;
    o.s = c.s;
    o.n = c.n;
  }
  return o;
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

__device__ __forceinline__ int4 load4(const int32_t* p, int k, int cnt, bool full) {
  if (full && (reinterpret_cast<uintptr_t>(p + k) & 15) == 0)
    return __ldg(reinterpret_cast<const int4*>(p + k));
  int4 v = make_int4(0, 0, 0, 0);
  if (cnt > 0) v.x = __ldg(p + k);
  if (cnt > 1) v.y = __ldg(p + k + 1);
  if (cnt > 2) v.z = __ldg(p + k + 2);
  if (cnt > 3) v.w = __ldg(p + k + 3);
  return v;
}

__device__ __forceinline__ uint32_t load4_bytes(const uint8_t* p, int k, int cnt, bool full) {
  if (full && (reinterpret_cast<uintptr_t>(p + k) & 3) == 0)
    return __ldg(reinterpret_cast<const uint32_t*>(p + k));
  uint32_t v = 0;
  for (int j = 0; j < cnt; ++j) v |= (uint32_t)__ldg(p + k + j) << (8 * j);
  return v;
}

__device__ __forceinline__ void store4(int32_t* p, int k, int cnt, bool full, int4 v) {
  if (full && (reinterpret_cast<uintptr_t>(p + k) & 15) == 0) {
    *reinterpret_cast<int4*>(p + k) = v;
    return;
  }
  if (cnt > 0) p[k] = v.x;
  if (cnt > 1) p[k + 1] = v.y;
  if (cnt > 2) p[k + 2] = v.z;
  if (cnt > 3) p[k + 3] = v.w;
}

__device__ __forceinline__ void store4_bytes(uint8_t* p, int k, int cnt, bool full, uint32_t v) {
  if (full && (reinterpret_cast<uintptr_t>(p + k) & 3) == 0) {
    *reinterpret_cast<uint32_t*>(p + k) = v;
    return;
  }
  for (int j = 0; j < cnt; ++j) p[k + j] = (uint8_t)(v >> (8 * j));
}

__device__ __forceinline__ int lane_of(int4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ bool byte_of(uint32_t v, int j) { return ((v >> (8 * j)) & 0xffu) != 0; }

// Walk one segment, positions [q0, q1) of the tile's non-pad events.
__device__ __forceinline__ void walk(int q0, int q1, Carry c, int32_t* col, uint8_t* fb,
                                     const uint8_t* fv, int T) {
  // the first event may reload (a boundary); the rest continue the carry
  Out o = step(fb[q0] != 0, col[GH * T + q0], col[GS * T + q0], col[GN * T + q0],
               fv[q0] != 0, col[TS * T + q0], col[TN * T + q0], col[LIM * T + q0],
               col[IVS * T + q0], col[IVN * T + q0], false, c);
  int q = q0 + 1;
  // the next event's fields, loaded one step ahead
  int nq = min(q, q1 - 1);
  int32_t ts = col[TS * T + nq], tn = col[TN * T + nq], lim = col[LIM * T + nq];
  int32_t ivs = col[IVS * T + nq], ivn = col[IVN * T + nq];
  col[GH * T + q0] = o.h;
  col[GS * T + q0] = o.s;
  col[GN * T + q0] = o.n;
  col[TS * T + q0] = o.mt;
  fb[q0] = (uint8_t)o.ex;
  c = Carry{o.h, o.s, o.n};
  for (; q < q1; ++q) {
    nq = min(q + 1, q1 - 1);
    const int32_t ts1 = col[TS * T + nq], tn1 = col[TN * T + nq], lim1 = col[LIM * T + nq];
    const int32_t ivs1 = col[IVS * T + nq], ivn1 = col[IVN * T + nq];
    o = step(false, 0, 0, 0, false, ts, tn, lim, ivs, ivn, false, c);
    col[GH * T + q] = o.h;
    col[GS * T + q] = o.s;
    col[GN * T + q] = o.n;
    col[TS * T + q] = o.mt;
    fb[q] = (uint8_t)o.ex;
    c = Carry{o.h, o.s, o.n};
    ts = ts1;
    tn = tn1;
    lim = lim1;
    ivs = ivs1;
    ivn = ivn1;
  }
}

__global__ void __launch_bounds__(kThreads) window_scan_kernel(Args a) {
  extern __shared__ __align__(16) int32_t sm[];
  const int T = a.T;
  int32_t* col = sm;             // [kCols][T] fields; the outputs overwrite GH, GS, GN, TS
  int32_t* aux = sm + kCols * T;  // [0, n_b): segment starts; [n_np, n): previous non-pad (-1: none)
  uint8_t* fb = reinterpret_cast<uint8_t*>(aux + T);  // boundary flag; then exceeded
  uint8_t* fv = fb + T;                                // g_valid flag
  __shared__ int warp_tot[kThreads / 32];
  __shared__ Carry entry;  // the carry into the tile

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) entry = Carry{0, 0, 0};

  for (int base = 0; base < a.E; base += T) {
    const int n = min(T, a.E - base);
    const int e0 = tid * kPerThread;  // my events: e0 .. e0 + cnt - 1 of the tile
    const int k0 = base + e0;
    // `full` gates the 16-byte loads and stores and is computed on its own:
    // tested as `cnt == kPerThread` on cnt = max(0, min(kPerThread, rem)),
    // ptxas (CUDA 12.8, sm_90a) read the predicate of the fused clamp as
    // that test and took the 16-byte paths for any rem >= 0, which wrote up
    // to four elements past the last event and, on a second tile,
    // overwrote the start of the next output row
    const int rem = n - e0;
    const bool full = rem >= kPerThread;
    const int cnt = full ? kPerThread : max(0, rem);

    // 1. my events' fields and flags
    int4 v[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = load4(a.in[c], k0, cnt, full);
    const uint32_t pw = load4_bytes(a.pad, k0, cnt, full);
    const uint32_t bw = load4_bytes(a.b, k0, cnt, full);
    const uint32_t vw = load4_bytes(a.gv, k0, cnt, full);

    // 2. exclusive prefix of (non-pad, non-pad boundary) counts, packed
    int x = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (j < cnt && !byte_of(pw, j)) x += 1 + (byte_of(bw, j) ? (1 << 16) : 0);
    }
    const int incl = warp_inclusive_sum(x, lane);
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) warp_tot[lane] = warp_inclusive_sum(warp_tot[lane], lane);
    __syncthreads();
    const int total = warp_tot[kThreads / 32 - 1];
    const int excl = incl - x + (warp ? warp_tot[warp - 1] : 0);
    const int n_np = total & 0xffff;
    const int n_b = total >> 16;
    int r_np = excl & 0xffff;
    int r_b = excl >> 16;

    // 3. scatter to the stable partition: non-pads by rank, then the pads
    int pos[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      pos[j] = 0;
      if (j >= cnt) continue;
      if (!byte_of(pw, j)) {
        pos[j] = r_np;
        if (byte_of(bw, j)) aux[r_b++] = r_np;
        ++r_np;
      } else {
        pos[j] = n_np + (e0 + j - r_np);
        aux[pos[j]] = r_np - 1;
      }
      fb[pos[j]] = byte_of(bw, j) ? 1 : 0;
      fv[pos[j]] = byte_of(vw, j) ? 1 : 0;
#pragma unroll
      for (int c = 0; c < kCols; ++c) col[c * T + pos[j]] = lane_of(v[c], j);
    }
    __syncthreads();

    // 4. one thread per segment; the first continues the incoming carry
    const Carry in = entry;
    const int head = (n_np > 0 && fb[0] == 0) ? 1 : 0;
    const int n_seg = n_b + head;
    // every thread has read fb[0] (a boundary flag) before the walk of
    // position 0 overwrites it with that event's exceeded flag
    __syncthreads();
    for (int s = tid; s < n_seg; s += kThreads) {
      const int q0 = s < head ? 0 : aux[s - head];
      const int q1 = s + 1 < n_seg ? aux[s + 1 - head] : n_np;
      walk(q0, q1, in, col, fb, fv, T);
    }
    __syncthreads();
    if (tid == 0 && n_np > 0)
      entry = Carry{col[GH * T + n_np - 1], col[GS * T + n_np - 1], col[GN * T + n_np - 1]};

    // 5. pads: outputs from the carry at the previous non-pad position
    for (int q = n_np + tid; q < n; q += kThreads) {
      const int j = aux[q];
      const Carry c = j >= 0 ? Carry{col[GH * T + j], col[GS * T + j], col[GN * T + j]} : in;
      const Out o = step(fb[q] != 0, col[GH * T + q], col[GS * T + q], col[GN * T + q],
                         fv[q] != 0, col[TS * T + q], col[TN * T + q], col[LIM * T + q],
                         col[IVS * T + q], col[IVN * T + q], true, c);
      col[GH * T + q] = o.h;
      col[GS * T + q] = o.s;
      col[GN * T + q] = o.n;
      col[TS * T + q] = o.mt;
      fb[q] = (uint8_t)o.ex;
    }
    __syncthreads();

    // 6. my events' outputs, back in event order
    const int src[4] = {GH, GS, GN, TS};
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      int4 w = make_int4(0, 0, 0, 0);
      if (cnt > 0) w.x = col[src[o] * T + pos[0]];
      if (cnt > 1) w.y = col[src[o] * T + pos[1]];
      if (cnt > 2) w.z = col[src[o] * T + pos[2]];
      if (cnt > 3) w.w = col[src[o] * T + pos[3]];
      store4(a.out[o], k0, cnt, full, w);
    }
    uint32_t ew = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (j < cnt) ew |= (uint32_t)fb[pos[j]] << (8 * j);
    }
    store4_bytes(a.ex, k0, cnt, full, ew);
    __syncthreads();  // the next tile reuses the shared memory
  }
}

constexpr int kMaxDevices = 64;
std::mutex g_mu;
bool g_configured[kMaxDevices];  // per device: the kernel's shared-memory limit is set

// Raises the kernel's dynamic shared-memory limit once on each device (the
// setting belongs to the device's context), `device` being current.
cudaError_t configure(int device) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_configured[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      window_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytesPerEvent * kTile);
  g_configured[device] = err == cudaSuccess;
  return err;
}

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

}  // namespace

// Inputs, each [E]: boundary, g_valid and pad as bytes (torch.bool); g_hits,
// g_ss, g_sns, e_ts_s, e_ts_ns, limit, iv_s, iv_ns as int32. Outputs, each
// [E]: hits, start_s, start_ns, match_type as int32 and exceeded as bytes
// (torch.bool). No scratch. Launches on `stream`, a stream of `device`, the
// device all the pointers are on; returns cudaGetLastError() after the
// launch.
extern "C" int window_scan_launch(const void* b, const void* gh, const void* gs,
                                  const void* gn, const void* gv, const void* ts,
                                  const void* tn, const void* lim, const void* ivs,
                                  const void* ivn, const void* pad, void* h_out, void* s_out,
                                  void* n_out, void* mt_out, void* ex_out, int E, int device,
                                  void* stream) {
  if (E <= 0) return 0;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  const cudaError_t err = configure(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  const void* ins[kCols] = {gh, gs, gn, ts, tn, lim, ivs, ivn};
  for (int c = 0; c < kCols; ++c) a.in[c] = static_cast<const int32_t*>(ins[c]);
  a.b = static_cast<const uint8_t*>(b);
  a.gv = static_cast<const uint8_t*>(gv);
  a.pad = static_cast<const uint8_t*>(pad);
  void* outs[4] = {h_out, s_out, n_out, mt_out};
  for (int o = 0; o < 4; ++o) a.out[o] = static_cast<int32_t*>(outs[o]);
  a.ex = static_cast<uint8_t*>(ex_out);
  a.E = E;
  a.T = E < kTile ? E : kTile;
  window_scan_kernel<<<1, kThreads, (size_t)kBytesPerEvent * a.T,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
