// Helpers shared by the chunkwise mLSTM's forward passes (B7,
// mlstm_chunk.cu) and backward passes (B7-bwd, mlstm_chunk_bwd.cu), for
// sm_90a: 256 threads over a 64-row tile, the gate scans of a chunk in one
// warp, cp.async (B7-bwd's ring), the strides and the shape check.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mt {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LMAX = 64;
constexpr unsigned FULL = 0xffffffffu;

// Scan of one chunk's gates in warp 0: b = cumsum(f~), w = i~ - b and
// g = cummax(w), two steps a lane (-inf past L).
struct GateScan {
  float b0, b1, w0, w1, g0, g1;
};

__device__ __forceinline__ GateScan gate_scan(const float* iv,
                                              const float* fv, int L,
                                              int lane) {
  const int s0 = 2 * lane, s1 = 2 * lane + 1;
  const bool ok0 = s0 < L, ok1 = s1 < L;
  const float f0 = ok0 ? fv[s0] : 0.0f, f1 = ok1 ? fv[s1] : 0.0f;
  float x = f0 + f1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  float excl = __shfl_up_sync(FULL, x, 1);
  if (lane == 0) excl = 0.0f;
  GateScan r;
  r.b0 = excl + f0;
  r.b1 = excl + (f0 + f1);
  r.w0 = ok0 ? iv[s0] - r.b0 : -INFINITY;
  r.w1 = ok1 ? iv[s1] - r.b1 : -INFINITY;
  const float mx1 = fmaxf(r.w0, r.w1);
  float mx = mx1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(FULL, mx, off);
    if (lane >= off) mx = fmaxf(mx, y);
  }
  float mexcl = __shfl_up_sync(FULL, mx, 1);
  if (lane == 0) mexcl = -INFINITY;
  r.g0 = fmaxf(mexcl, r.w0);
  r.g1 = fmaxf(mexcl, mx1);
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Strides of q, k, v (element (b, h, t, d) at b qs_b + h qs_h + t qs_t + d)
// and of the gates (b gs_b + h gs_h + t gs_t).
struct Strides {
  int64_t qs_b, qs_h, qs_t, gs_b, gs_h, gs_t;
};

inline bool shape_ok(int B, int H, int T, int D, int L) {
  return L > 0 && L <= LMAX && T % L == 0 && D > 0 && D <= 256 && H > 0 &&
         (int64_t)B * H <= 65535;
}

}  // namespace mt
