// Helpers shared by the split-TF32 flash attention (flash_tf32x3.cu) and
// its backward's mma.sync kernel at D 256 (flash_tf32x3_bwd.cu): the tf32
// hi + lo split, the m16n8k8 tf32 mma.sync, and the staging of f32 rows
// into shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int THREADS = 128;  // 4 warps a block, in both kernels

// x rounded to tf32 (10 mantissa bits) to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds: half a tf32 ulp added to the magnitude bits,
// the 13 low bits cleared. Two integer operations issue at a far higher
// rate than cvt.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = x rounded to tf32, lo = (x - hi) rounded to tf32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


// Eight consecutive elements of a row, as f32.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Rows [lo, lo + ROWS) of a (T, D) matrix into shared memory with row
// stride S, times `mul`; rows past T are zero. Synchronous.
template <int D, int ROWS, int S>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int lo, int Tlen, float mul,
                                           float* dst) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    float x[8];
    if (lo + r < Tlen) {
      load8(src + (long long)(lo + r) * D + c * 8, x);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] *= mul;
    store8(dst + r * S + c * 8, x);
  }
}


}  // namespace tf32x3
