// The backward of the split-TF32 banded flash attention (flash_tf32x3.cu)
// with GQA, for sm_90a: f32 q, k, v, o, dO at every head size of the
// registry (D 16, 64, 80, 128, 256), f32 lse. (bf16 runs forward and
// backward on bf16 tensor cores: csrc/flash_tc.cu, csrc/flash_tc_bwd.cu.)
//
// Replaces the backward that the JAX package gets by differentiating its
// attention (`jax.grad` through `_chunked_attention`); the TPU kernel
// `_flash_kernel` of src/repro/kernels/local_attention/local_attention.py
// has no backward of its own. Same function as the forward: the mask is
// (k_pos <= q_pos) & (k_pos > q_pos - W), q head h reads kv head
// h / (Hq / Hkv), W = T is full causal. With scale = the forward's f32
// 1/sqrt(D), s = (q scale) . k as the forward forms it and lse the
// forward's per-row log-sum-exp:
//
//   P  = exp(s - lse)                 (0 where masked)
//   dV = P^T dO       dP = dO V^T     delta = rowsum(dO * O)
//   dS = P * (dP - delta)
//   dQ = scale dS K   dK = dS^T (q scale)    (dK, dV summed over G)
//
// What bounds it on an H100: 5 products of 2*D FLOP per live (query, key)
// pair, 10*D in all, on the tensor cores at the TF32 peak (494.7
// TFLOP/s). The split issues 3x those passes on mma.sync, which runs at a
// fraction of wgmma's peak: this kernel is right first, not fast.
//
// Design (simple; each block recomputes what it needs):
//
//   * a pre-pass (`flash_tf32x3_bwd_prep_kernel`) writes delta =
//     rowsum(dO * O) per row in f32 and zeroes dq, which is its own f32
//     accumulator.
//   * one block of 4 warps per (64-key tile, b * kv head, chunk of DC
//     output columns); DC = D up to D 80, 64 above, so that a warp's dK and
//     dV accumulators (16 keys x DC, f32) stay in registers. Each chunk's
//     block recomputes S and dP over the whole of D: 1.4x the products at
//     D 128, 2.2x at D 256. K and V (the whole tile, f32 in shared memory)
//     are staged once; the block then loops over the G q heads of its kv
//     head and, for each, over the 32-row query tiles that meet the tile's
//     band [k_lo, k_hi + W - 1] n [0, T), staging q * scale, dO, lse and
//     delta of each.
//   * warp w owns keys [16 w, 16 w + 16) of the tile: S^T = K_w (q scale)^T
//     and dP^T = V_w dO^T as mma.sync m16n8k8 (16 keys x 32 queries), P^T
//     and dS^T formed in registers, dV_w += P^T dO[:, chunk] and dK_w +=
//     dS^T (q scale)[:, chunk] with P^T and dS^T as A fragments straight
//     from the accumulators (the forward's pairing: k index t stands for
//     query 2t and t + 4 for 2t + 1). A warp whose 16 keys meet none of
//     the tile's 32 queries skips all of it.
//   * dQ in the same pass: each warp writes its dS^T to shared memory, and
//     after a barrier warp w computes rows [16 (w % 2), +16) of the tile's
//     dQ over half of the chunk's columns and all 64 keys, then adds it
//     into the f32 accumulator with float2 atomics (so dq's f32 sums land
//     in an order that varies from call to call; dk and dv do not).
//   * every operand split into tf32 hi + lo as in the forward (its note),
//     the dropped lo*lo term below 2^-21 of a product: three passes a
//     product.
//   * dK and dV sum each query tile's share in a fresh fragment and add it
//     to their registers in f32: kept as one mma.sync accumulator over all
//     G x T queries they drift, the tensor cores' accumulation not rounding
//     to nearest (1.1e-4 of max |dv| from the f32 plain version at D 256,
//     G 8, T 1,500 on the H100, where the f32 check allows 1e-4).
//
// Rows and keys past T read as zero, are masked and never written. At W = 0
// no query tile is visited and dq, dk, dv are 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "flash_tf32x3.cuh"

using namespace tf32x3;

namespace {

constexpr int BKV = 64;       // keys per block, 16 a warp
constexpr int BQT = 32;       // query rows per step
constexpr int DSS = BQT + 4;  // dS^T row stride: 4 (mod 32)
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int DC = D > 80 ? 64 : D;  // output columns per block
  static constexpr int NCH = D / DC;          // column chunks (grid.z)
  static constexpr int KD = D / 8;            // k-steps over D
  static constexpr int NC = DC / 8;           // n-tiles of a warp's dK, dV
  static constexpr int NQ = DC / 16;          // n-tiles of a warp's dQ
  // Row stride of K, V, q and dO in floats: 8 (mod 32), so that the
  // 8-byte fragment loads (row g, d 2t) are free of bank conflicts.
  static constexpr int S = D + ((8 - D) % 32 + 32) % 32;
  static constexpr int SMEM_FLOATS =
      2 * BKV * S + 2 * BQT * S + BKV * DSS + 2 * BQT;
  static constexpr int MIN_BLOCKS = D > 128 ? 1 : 2;
};

// An A fragment (16 x 8) as tf32 hi and lo: elements (row g, k t), (row
// g + 8, k t), (row g, k t + 4), (row g + 8, k t + 4).
struct FragA {
  uint32_t h[4], l[4];
};

__device__ __forceinline__ void frag_a(FragA& f, float a0, float a1,
                                       float a2, float a3) {
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], f.h[i], f.l[i]);
}

// d += a * b with b's two values (k t, n g) and (k t + 4, n g): the small
// terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, a.l, bh0, bh1);
  mma(d, a.h, bl0, bl1);
  mma(d, a.h, bh0, bh1);
}

// acc += A^T B over a query tile: A^T (16 keys x BQT queries) the warp's
// S-shaped accumulator `a` (element e of n-tile j: key g + 8 (e / 2),
// query 8j + 2t + e % 2), read as A fragments (k t = query 8j + 2t, k t +
// 4 = 8j + 2t + 1); B rows of BQT queries from `b` (row 2t of the tile,
// column g of the chunk; stride S), NC n-tiles of 8 columns. The tile's
// sum is formed in a fresh fragment, then added to acc in f32 (the note:
// a long chain of mma.sync accumulation drifts).
template <int NC, int S>
__device__ __forceinline__ void tile_product(float (&acc)[NC][4],
                                             const float (&a)[BQT / 8][4],
                                             const float* b) {
  float t[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[c][e] = 0.f;
#pragma unroll
  for (int j = 0; j < BQT / 8; ++j) {
    FragA f;
    frag_a(f, a[j][0], a[j][2], a[j][1], a[j][3]);
    const float* row = b + 8 * j * S;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      mma3(t[c], f, row[8 * c], row[S + 8 * c]);
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] += t[c][e];
}

// delta = rowsum(dO * O) per row (b * Hq + h, t), and that row of dq (the
// f32 accumulator) zeroed. 8 threads a row.
template <int D>
__global__ void __launch_bounds__(256)
flash_tf32x3_bwd_prep_kernel(const float* __restrict__ o,
                             const float* __restrict__ dout,
                             float* __restrict__ delta,
                             float* __restrict__ dq_acc, long long rows) {
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x / 8;
  const int sub = threadIdx.x % 8;
  float acc = 0.f;
  if (row < rows) {
    for (int c = sub; c < D / 8; c += 8) {
      float x[8], y[8];
      load8(o + row * D + c * 8, x);
      load8(dout + row * D + c * 8, y);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
      float z[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      store8(dq_acc + row * D + c * 8, z);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (sub == 0 && row < rows) delta[row] = acc;
}

template <int D>
__global__ void __launch_bounds__(THREADS, Cfg<D>::MIN_BLOCKS)
flash_tf32x3_bwd_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq_acc, float* __restrict__ dk,
                        float* __restrict__ dv, int Hq, int Hkv, int Tlen,
                        int W, float scale) {
  using C = Cfg<D>;
  constexpr int S = C::S, KD = C::KD, NC = C::NC, NQ = C::NQ, DC = C::DC;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;               // [BKV][S]
  float* Vs = Ks + BKV * S;       // [BKV][S]
  float* Qs = Vs + BKV * S;       // [BQT][S]: q * scale
  float* Os = Qs + BQT * S;       // [BQT][S]: dO
  float* dSt = Os + BQT * S;      // [BKV][DSS]: dS^T
  float* lse2 = dSt + BKV * DSS;  // [BQT]: lse * log2(e), +inf past T
  float* dlt = lse2 + BQT;        // [BQT]: delta, 0 past T

  const int kt = blockIdx.x, bk = blockIdx.y;
  const int col0 = blockIdx.z * DC;
  const int b = bk / Hkv, hk = bk % Hkv, G = Hq / Hkv;
  const int k_lo = kt * BKV;
  const long long kv_off = (long long)bk * Tlen * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kw = k_lo + warp * 16;  // the warp's first key

  stage_rows<D, BKV, S>(k + kv_off, k_lo, Tlen, 1.f, Ks);
  stage_rows<D, BKV, S>(v + kv_off, k_lo, Tlen, 1.f, Vs);

  float dK[NC][4], dV[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[c][e] = dV[c][e] = 0.f;

  // The query tiles that meet [k_lo, k_lo + BKV - 1 + W - 1] n [0, T).
  const int qt_lo = k_lo / BQT;
  const int qt_hi =
      W > 0 ? min(k_lo + BKV - 1 + W - 1, Tlen - 1) / BQT : qt_lo - 1;
  for (int gi = 0; gi < G; ++gi) {
    const long long q_row = ((long long)b * Hq + hk * G + gi) * Tlen;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BQT;
      __syncthreads();  // the previous step is done with Qs, Os, dSt
      stage_rows<D, BQT, S>(q + q_row * D, q0, Tlen, scale, Qs);
      stage_rows<D, BQT, S>(dout + q_row * D, q0, Tlen, 1.f, Os);
      if (threadIdx.x < BQT) {
        const int t = q0 + threadIdx.x;
        lse2[threadIdx.x] = t < Tlen ? lse[q_row + t] * LOG2E : INFINITY;
        dlt[threadIdx.x] = t < Tlen ? delta[q_row + t] : 0.f;
      }
      __syncthreads();

      const bool dead = kw >= Tlen || kw > q0 + BQT - 1 || kw + 15 <= q0 - W;
      float* dsa = dSt + (warp * 16 + g) * DSS + 2 * tq;  // key rows g, g + 8
      if (dead) {
#pragma unroll
        for (int j = 0; j < BQT / 8; ++j) {
          *reinterpret_cast<float2*>(dsa + 8 * j) = make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(dsa + 8 * DSS + 8 * j) =
              make_float2(0.f, 0.f);
        }
      } else {
        // ---- S^T = K_w (q scale)^T and dP^T = V_w dO^T: 16 x 32 ----
        float st[BQT / 8][4], dpt[BQT / 8][4];
#pragma unroll
        for (int j = 0; j < BQT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
        const float* Ka = Ks + (warp * 16 + g) * S + 2 * tq;
        const float* Va = Vs + (warp * 16 + g) * S + 2 * tq;
        const float* Qb = Qs + g * S + 2 * tq;
        const float* Ob = Os + g * S + 2 * tq;
#pragma unroll 2
        for (int kk = 0; kk < KD; ++kk) {
          // (key g, k t) = d 8kk + 2t, (key g, k t + 4) = d 8kk + 2t + 1
          const float2 ka = *reinterpret_cast<const float2*>(Ka + 8 * kk);
          const float2 kb =
              *reinterpret_cast<const float2*>(Ka + 8 * S + 8 * kk);
          const float2 va = *reinterpret_cast<const float2*>(Va + 8 * kk);
          const float2 vb =
              *reinterpret_cast<const float2*>(Va + 8 * S + 8 * kk);
          FragA fk, fv;
          frag_a(fk, ka.x, kb.x, ka.y, kb.y);
          frag_a(fv, va.x, vb.x, va.y, vb.y);
#pragma unroll
          for (int j = 0; j < BQT / 8; ++j) {
            // (k t, query 8j + g) and (k t + 4, query 8j + g)
            const float2 y =
                *reinterpret_cast<const float2*>(Qb + 8 * j * S + 8 * kk);
            const float2 z =
                *reinterpret_cast<const float2*>(Ob + 8 * j * S + 8 * kk);
            mma3(st[j], fk, y.x, y.y);
            mma3(dpt[j], fv, z.x, z.y);
          }
        }
        // ---- P^T, dS^T (element e of n-tile j: key g + 8 (e / 2), query
        // 8j + 2t + e % 2) ----
#pragma unroll
        for (int j = 0; j < BQT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kw + g + (e >> 1) * 8;
            const int ql = 8 * j + 2 * tq + (e & 1);
            const int qp = q0 + ql;
            const bool live = key <= qp && key > qp - W && qp < Tlen;
            const float p =
                live ? exp2f(fmaf(st[j][e], LOG2E, -lse2[ql])) : 0.f;
            st[j][e] = p;
            dpt[j][e] = p * (dpt[j][e] - dlt[ql]);
          }
#pragma unroll
        for (int j = 0; j < BQT / 8; ++j) {
          *reinterpret_cast<float2*>(dsa + 8 * j) =
              make_float2(dpt[j][0], dpt[j][1]);
          *reinterpret_cast<float2*>(dsa + 8 * DSS + 8 * j) =
              make_float2(dpt[j][2], dpt[j][3]);
        }
        // ---- dV_w += P^T dO[:, chunk], dK_w += dS^T (q scale)[:, chunk],
        // each query tile's share added in f32 ----
        tile_product<NC, S>(dV, st, Os + 2 * tq * S + col0 + g);
        tile_product<NC, S>(dK, dpt, Qs + 2 * tq * S + col0 + g);
      }
      __syncthreads();  // dS^T complete

      // ---- dQ rows [qr, qr + 16) x columns [cq, cq + DC / 2) over the
      // tile's 64 keys: A = dS (query, k t = key 8kk + 2t), B = K ----
      const int qr = (warp & 1) * 16;
      const int cq = col0 + (warp >> 1) * (DC / 2);
      float acc[NQ][4];
#pragma unroll
      for (int c = 0; c < NQ; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < BKV / 8; ++kk) {
        const float* r0 = dSt + (8 * kk + 2 * tq) * DSS + qr + g;
        FragA fa;
        frag_a(fa, r0[0], r0[8], r0[DSS], r0[DSS + 8]);
        const float* kr = Ks + (8 * kk + 2 * tq) * S + cq + g;
#pragma unroll
        for (int c = 0; c < NQ; ++c)
          mma3(acc[c], fa, kr[8 * c], kr[S + 8 * c]);
      }
      const int ra = q0 + qr + g, rb = ra + 8;
#pragma unroll
      for (int c = 0; c < NQ; ++c) {
        const int col = cq + 8 * c + 2 * tq;
        if (ra < Tlen)
          atomicAdd(reinterpret_cast<float2*>(dq_acc + (q_row + ra) * D + col),
                    make_float2(acc[c][0] * scale, acc[c][1] * scale));
        if (rb < Tlen)
          atomicAdd(reinterpret_cast<float2*>(dq_acc + (q_row + rb) * D + col),
                    make_float2(acc[c][2] * scale, acc[c][3] * scale));
      }
    }
  }

  // ---- dK, dV rows of the warp's keys < T ----
  const int ka = kw + g, kb = ka + 8;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const long long col = col0 + 8 * c + 2 * tq;
    if (ka < Tlen) {
      store2(dk + kv_off + (long long)ka * D + col, dK[c][0], dK[c][1]);
      store2(dv + kv_off + (long long)ka * D + col, dV[c][0], dV[c][1]);
    }
    if (kb < Tlen) {
      store2(dk + kv_off + (long long)kb * D + col, dK[c][2], dK[c][3]);
      store2(dv + kv_off + (long long)kb * D + col, dV[c][2], dV[c][3]);
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* lse, const float* dout,
                   float* dq, float* dk, float* dv, float* delta, int B,
                   int Hq, int Hkv, int Tlen, int W, cudaStream_t s) {
  using C = Cfg<D>;
  const long long rows = (long long)B * Hq * Tlen;
  flash_tf32x3_bwd_prep_kernel<D><<<(unsigned)((rows + 31) / 32), 256, 0, s>>>(
      o, dout, delta, dq, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int smem = C::SMEM_FLOATS * (int)sizeof(float);
  e = cudaFuncSetAttribute(flash_tf32x3_bwd_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tlen + BKV - 1) / BKV, B * Hkv, C::NCH);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_tf32x3_bwd_kernel<D><<<grid, THREADS, smem, s>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, Hq, Hkv, Tlen, W, scale);
  return cudaGetLastError();
}

}  // namespace

// Launches the split-TF32 flash attention backward on `stream`: f32 q, o,
// dout and dq (B, Hq, T, D), k, v, dk and dv (B, Hkv, T, D), D in {16, 64,
// 80, 128, 256}, contiguous on 16-byte boundaries; lse (B, Hq, T) f32 as
// the forward wrote it; delta: B * Hq * T floats of scratch. W is the
// window (T for full causal). Returns the CUDA error code (0 = success).
// Allocates nothing and does not synchronise.
extern "C" int flash_attention_bwd_tf32x3_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int B, int Hq, int Hkv, int T, int D, int W, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B * Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define TF32X3_BWD_ARGS                                                     \
  (const float*)q, (const float*)k, (const float*)v, (const float*)o,       \
      (const float*)lse, (const float*)dout, (float*)dq, (float*)dk,        \
      (float*)dv, (float*)delta, B, Hq, Hkv, T, W, s
  switch (D) {
    case 16: return (int)launch<16>(TF32X3_BWD_ARGS);
    case 64: return (int)launch<64>(TF32X3_BWD_ARGS);
    case 80: return (int)launch<80>(TF32X3_BWD_ARGS);
    case 128: return (int)launch<128>(TF32X3_BWD_ARGS);
    case 256: return (int)launch<256>(TF32X3_BWD_ARGS);
  }
#undef TF32X3_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
