// Banded (causal sliding-window) flash attention with GQA, for sm_90a.
//
// Replaces the TPU kernel `_flash_kernel` (wrapper `flash_attention_pallas`)
// of src/repro/kernels/local_attention/local_attention.py. It computes the
// same function and is laid out anew for a GPU:
//
//   * one block of 128 threads owns one (batch * q head, query tile) pair
//     and loops over the key tiles itself; the TPU grid's sequential kv axis
//     and its scratch carry between grid steps have no counterpart. The loop
//     visits exactly the key tiles that meet [q_lo - W + 1, q_hi] — the
//     band — so tiles above the diagonal or wholly behind the window cost
//     nothing. Query tiles are issued last-first, so the long rows of a
//     causal pass start before the short ones.
//   * q head h reads kv head h / (Hq / Hkv), as the reference's index map.
//   * the query tile (scaled by 1/sqrt(D) after the upcast, as the
//     reference does), the key tile (both transposed, d-major) and the value
//     tile are staged in shared memory as f32; the running max, the
//     normaliser and the accumulator stay in registers, in f32. Threads form
//     16 row groups x 8 column groups: a thread holds RT query rows, CT
//     score columns and D/8 output columns; a row's max and sum are joined
//     over its 8 column groups by xor shuffles. The probabilities go through
//     shared memory (transposed) into the P.V product.
//   * the mask is (k_pos <= q_pos) & (k_pos > q_pos - W), masked scores are
//     -1e30 and masked probabilities 0, and a row whose normaliser stayed 0
//     divides by 1 — the reference's rules (local_attention.py:69, :84).
//   * every product is an f32 FMA on the upcast inputs, as the TPU kernel
//     computes after its upcast; no tensor cores, so the rounding is that of
//     f32 arithmetic for f32 and bf16 inputs alike.
//   * any T: rows and keys past T are zero-filled on load and never written
//     (the causal mask already excludes keys past a live query).
//
// What bounds it on an H100: the scores and the P.V product are 4*D FLOP per
// live (query, key) pair, far above the bytes of q, k, v and o (PERF.md
// gives the bound at the main path's shapes). This first design runs them
// on the f32 FMA units (67 TFLOP/s peak), not on the tensor cores (989
// TFLOP/s bf16), and shared-memory traffic limits it below that. bf16
// inputs at D in {64, 128, 256} go to the tensor-core design of
// csrc/flash_tc.cu instead; this kernel keeps f32 inputs and the other
// head sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int THREADS = 128;  // 16 row groups x 8 column groups
constexpr float NEG_INF = -1e30f;

template <int D>
struct Tile {
  static constexpr int RT = D > 128 ? 2 : 4;    // query rows per thread
  static constexpr int BQ = 16 * RT;            // query rows per block
  static constexpr int BK = D > 128 ? 32 : 64;  // keys per tile
  static constexpr int CT = BK / 8;             // score columns per thread
  static constexpr int DT = D / 8;              // output columns per thread
  static constexpr int VW = DT % 4 == 0 ? 4 : 2;  // output column chunk
  // Shared floats: Qt[D][BQ], Kt[D][BK], Vs[BK][D], Pt[BK][BQ].
  static constexpr int SMEM_FLOATS = D * BQ + D * BK + BK * D + BK * BQ;
};

// Eight consecutive elements of a row, as f32.
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// N consecutive shared floats (16-byte aligned for N % 4 == 0, 8-byte for
// N % 2 == 0).
template <int N>
__device__ __forceinline__ void lds(const float* p, float* x) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = t.x; x[4 * i + 1] = t.y; x[4 * i + 2] = t.z; x[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 t = reinterpret_cast<const float2*>(p)[i];
      x[2 * i] = t.x; x[2 * i + 1] = t.y;
    }
  }
}

// Rows [lo, lo + ROWS) of a (T, D) matrix into shared memory, transposed
// (dst[d * ROWS + r]) and multiplied by `mul`; rows past T are zero. A warp
// covers 32 consecutive rows of one 8-column chunk, so the transposed
// stores fall in 32 distinct banks.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void stage_t(const T* __restrict__ src, int lo,
                                        int Tlen, float mul, float* dst) {
  for (int i = threadIdx.x; i < ROWS * (D / 8); i += THREADS) {
    const int r = i % ROWS, dc = i / ROWS;
    float x[8];
    if (lo + r < Tlen) {
      load8(src + (long long)(lo + r) * D + dc * 8, x);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) dst[(dc * 8 + u) * ROWS + r] = x[u] * mul;
  }
}

// Rows [lo, lo + ROWS) of a (T, D) matrix into shared memory as they are
// (dst[r * D + d]); rows past T are zero.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int lo,
                                      int Tlen, float* dst) {
  for (int i = threadIdx.x; i < ROWS * (D / 8); i += THREADS) {
    const int dc = i % (D / 8), r = i / (D / 8);
    float x[8];
    if (lo + r < Tlen) {
      load8(src + (long long)(lo + r) * D + dc * 8, x);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = 0.f;
    }
    float4* o = reinterpret_cast<float4*>(dst + r * D + dc * 8);
    o[0] = make_float4(x[0], x[1], x[2], x[3]);
    o[1] = make_float4(x[4], x[5], x[6], x[7]);
  }
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
             int Tlen, int W, float scale) {
  using C = Tile<D>;
  constexpr int RT = C::RT, BQ = C::BQ, BK = C::BK, CT = C::CT;
  constexpr int DT = C::DT, VW = C::VW;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;             // [D][BQ]
  float* Kt = Qt + D * BQ;      // [D][BK]
  float* Vs = Kt + D * BK;      // [BK][D]
  float* Pt = Vs + BK * D;      // [BK][BQ]

  const int nq = (Tlen + BQ - 1) / BQ;
  const int q_lo = (nq - 1 - (int)blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const long long q_off = (long long)bh * Tlen * D;
  const long long kv_off =
      ((long long)b * Hkv + h / (Hq / Hkv)) * (long long)Tlen * D;
  const int rg = threadIdx.x >> 3, cg = threadIdx.x & 7;
  const int row0 = rg * RT;

  stage_t<D, BQ>(q + q_off, q_lo, Tlen, scale, Qt);

  float m[RT], l[RT], acc[RT][DT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[i][t] = 0.f;
  }

  const int q_hi = min(q_lo + BQ, Tlen) - 1;
  const int kt_lo = max(q_lo - W + 1, 0) / BK;
  const int kt_hi = q_hi / BK;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k_lo = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    stage_t<D, BK>(k + kv_off, k_lo, Tlen, 1.f, Kt);
    stage<D, BK>(v + kv_off, k_lo, Tlen, Vs);
    __syncthreads();

    // Scores: column (c * 8 + cg) * 4 + u of the tile for c < CT / 4.
    float s[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RT], kv[CT];
      lds<RT>(Qt + d * BQ + row0, qv);
#pragma unroll
      for (int c = 0; c < CT / 4; ++c)
        lds<4>(Kt + d * BK + (c * 8 + cg) * 4, kv + 4 * c);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // Mask and online softmax, one row at a time.
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int q_pos = q_lo + row0 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int k_pos = k_lo + ((j / 4) * 8 + cg) * 4 + (j % 4);
        const bool live = (k_pos <= q_pos) && (k_pos > q_pos - W);
        s[i][j] = live ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int col = ((j / 4) * 8 + cg) * 4 + (j % 4);
        const int k_pos = k_lo + col;
        const bool live = (k_pos <= q_pos) && (k_pos > q_pos - W);
        const float p = live ? expf(s[i][j] - m_new) : 0.f;
        Pt[col * BQ + row0 + i] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int t = 0; t < DT; ++t) acc[i][t] *= alpha;
    }
    __syncthreads();

    // acc += P . V; output column (c * 8 + cg) * VW + u for c < DT / VW.
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float pv[RT], vv[DT];
      lds<RT>(Pt + j * BQ + row0, pv);
#pragma unroll
      for (int c = 0; c < DT / VW; ++c)
        lds<VW>(Vs + j * D + (c * 8 + cg) * VW, vv + VW * c);
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int t = 0; t < DT; ++t) acc[i][t] = fmaf(pv[i], vv[t], acc[i][t]);
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int q_pos = q_lo + row0 + i;
    if (q_pos >= Tlen) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
    T* out = o + q_off + (long long)q_pos * D;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int col = ((t / VW) * 8 + cg) * VW + (t % VW);
      store(out + col, acc[i][t] / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Tlen, int W,
                   cudaStream_t stream) {
  using C = Tile<D>;
  const int smem = C::SMEM_FLOATS * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tlen + C::BQ - 1) / C::BQ, B * Hq);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hkv, Tlen, W, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int Hq, int Hkv, int Tlen, int D, int W,
                     cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Tlen, W, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Tlen, W, s);
    case 80: return launch<T, 80>(q, k, v, o, B, Hq, Hkv, Tlen, W, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Tlen, W, s);
    case 256: return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Tlen, W, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the banded flash attention on `stream`: q (B, Hq, T, D), k and v
// (B, Hkv, T, D), o like q, all contiguous, dtype 0 = float32, 1 = bfloat16.
// W is the window (T for full causal). Returns the CUDA error code of the
// launch (0 = success). Allocates nothing and does not synchronise.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Hq,
                                      int Hkv, int T, int D, int W, int dtype,
                                      void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_d<float>(q, k, v, o, B, Hq, Hkv, T, D, W, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, T, D, W, s);
  return (int)cudaErrorInvalidValue;
}
