// Helpers shared by the RG-LRU scan (rglru_scan.cu, B6) and its backward
// (rglru_scan_bwd.cu, B6-bwd): the tile both launch, the loads and stores
// of a lane's V channels of a row, the fast gate functions, and the
// release / acquire pair of the decoupled look-back. The backward reads
// each forward tile's inclusive h, so the two must tile T and D alike.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rglru {

constexpr int AGG = 1, INC = 2;

// The tile launched (rglru_scan.cu's note says why): 8 warps of 12 steps, 4 channels a lane,
// two blocks an SM.
constexpr int TILE_WARPS = 8, TILE_R = 12, TILE_V = 4, TILE_MINB = 2;
constexpr int TILE_L = TILE_WARPS * TILE_R, TILE_C = 32 * TILE_V;

// V values of one row as loaded, in 32-bit words: f32 one to a word, bf16
// two (unpacked when the gates are computed, so that the loads of all R
// rows are in flight in as few registers as they take).
template <typename TX, int V>
struct Raw {
  static constexpr int WORDS = V * (int)sizeof(TX) / 4;
  uint32_t w[WORDS];
};

__device__ __forceinline__ float unpack_one(const uint32_t* w, int j,
                                            float) {
  return __uint_as_float(w[j]);
}
__device__ __forceinline__ float unpack_one(const uint32_t* w, int j,
                                            __nv_bfloat16) {
  const uint32_t u = w[j >> 1];
  return __uint_as_float(j & 1 ? u & 0xffff0000u : u << 16);
}
template <typename TX, int V>
__device__ __forceinline__ float unpack(const Raw<TX, V>& r, int j) {
  return unpack_one(r.w, j, TX());
}

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// The V values at p + i (channels [c, c + V) of a row); `n` of them exist
// (n <= 0: none, read as 0). VEC: rows on 16-byte boundaries and D % 8 ==
// 0, so n >= V or n <= 0 and one vector load takes the V values.
template <bool VEC, typename TX, int V>
__device__ __forceinline__ Raw<TX, V> load_raw(const TX* p, int64_t i,
                                               int n) {
  Raw<TX, V> o;
  constexpr int W = Raw<TX, V>::WORDS;
  if (VEC && n > 0) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p + i);
    if constexpr (W % 4 == 0) {
#pragma unroll
      for (int k = 0; k < W / 4; ++k) {
        const uint4 u = __ldcs(reinterpret_cast<const uint4*>(q) + k);
        o.w[4 * k] = u.x; o.w[4 * k + 1] = u.y;
        o.w[4 * k + 2] = u.z; o.w[4 * k + 3] = u.w;
      }
    } else {
      static_assert(W == 2, "4 f32 in one 16-byte load, 4 bf16 in 8");
      const uint2 u = __ldcs(reinterpret_cast<const uint2*>(q));
      o.w[0] = u.x; o.w[1] = u.y;
    }
  } else {
    constexpr int E = 4 / (int)sizeof(TX);  // elements a word
#pragma unroll
    for (int k = 0; k < W; ++k) {
      uint32_t w = 0;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (!VEC && k * E + e < n)
          w |= bits(p[i + k * E + e]) << (32 / E * e);
      o.w[k] = w;
    }
  }
  return o;
}

__device__ __forceinline__ void store1(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store1(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// y for channels [c, c + V) of a row: vector stores under VEC, else one
// element at a time for the n that exist.
template <bool VEC, int V>
__device__ __forceinline__ void store_row(float* p, int64_t i, int n,
                                          const float* v) {
  if (VEC) {
    if (n > 0) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k)
        __stcs(reinterpret_cast<float4*>(p + i) + k,
               make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                           v[4 * k + 3]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < n) store1(p, i + j, v[j]);
  }
}

template <bool VEC, int V>
__device__ __forceinline__ void store_row(__nv_bfloat16* p, int64_t i, int n,
                                          const float* v) {
  if (VEC) {
    static_assert(V == 4, "4 bf16, one 8-byte store");
    if (n > 0)
      __stcs(reinterpret_cast<uint2*>(p + i),
             make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3])));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < n) store1(p, i + j, v[j]);
  }
}

__device__ __forceinline__ float load_lam(const float* p, int i) {
  return p[i];
}
__device__ __forceinline__ float load_lam(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float fast_sigmoid(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

__device__ __forceinline__ float fast_sqrt(float v) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// A map h -> A h + H.
struct Map {
  float A, H;
};

// The number of tiles of a (B, T, D) launch.
inline int64_t tiles(int B, int T, int D) {
  return (int64_t)B * ((T + TILE_L - 1) / TILE_L) *
         ((D + TILE_C - 1) / TILE_C);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace rglru
