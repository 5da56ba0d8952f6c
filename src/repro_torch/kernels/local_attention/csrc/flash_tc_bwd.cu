// B5-bwd: the backward of the banded (causal sliding-window) flash attention
// with GQA, on Hopper's tensor cores, for sm_90a: bf16 q, k, v, o, dO at D
// in {64, 128, 256} (the (dtype, D) set of csrc/flash_tc.cu), f32 lse.
//
// Replaces the backward that the JAX package gets from differentiating its
// attention (`jax.grad` through `_chunked_attention`, whose
// `jax.checkpoint` on the KV loop recomputes the scores); the TPU kernel
// `_flash_kernel` of src/repro/kernels/local_attention/local_attention.py
// has no backward of its own. Same function as the forward kernel: the mask
// is (k_pos <= q_pos) & (k_pos > q_pos - W), q head h reads kv head
// h / (Hq / Hkv), W = T is full causal. With s = q.k, scale = the forward's
// f32 1/sqrt(D) and lse the forward's per-row log-sum-exp of s * scale:
//
//   P  = exp(s * scale - lse)        (0 where masked)
//   dV = P^T dO       dP = dO V^T     delta = rowsum(dO * O)
//   dS = P * (dP - delta)
//   dQ = scale * dS K                 dK = scale * dS^T Q   (summed over G)
//
// What bounds it on an H100: 5 products of 2*D FLOP per live (query, key)
// pair, 10*D in all, against q, k, v, o, dO read once and dq, dk, dv
// written once: the tensor cores (989 TFLOP/s bf16). The design, a simple
// one that is right first (mma.sync m16n8k16, bf16 operands, f32
// accumulation; wgmma and TMA are later work):
//
//   * three kernels. `delta` reduces rowsum(dO * O) in f32 (8 threads a
//     row). `dkdv`: one block per (b, kv head, 64-key tile), key tiles
//     issued first-to-last (the long columns of a causal pass start first);
//     it loops over the G query heads of its group and, for each, over the
//     64-query tiles that meet [k_lo, k_hi + W - 1] n [0, T), so it sums
//     dK and dV over the group itself and no two blocks write one row.
//     `dq`: one block per (b, q head, 64-query tile), query tiles issued
//     last-first like the forward's, looping over the key tiles that meet
//     [q_lo - W + 1, q_hi]. dQ gets its own kernel rather than f32 atomics
//     from `dkdv`: it recomputes S and dP (7 products a pair instead of 5),
//     but writes each dQ row once, deterministically, with no f32 scratch
//     of (B, Hq, T, D) and no cast pass.
//   * both loop kernels share one shape: 8 warps; the block's fixed 64-row
//     tiles (K, V / Q, dO) and a 2-stage ring of streamed 64-row tiles
//     (Q, dO, lse, delta / K, V), filled by cp.async one tile ahead, in
//     shared memory rows padded by 16 bytes so that ldmatrix is free of
//     bank conflicts (dK/dV: 217 KiB at D = 256, 121 KiB at D = 128).
//     Phase 1: each warp computes a 16 x 32 piece of S (or S^T) and dP (or
//     dP^T) over k = D, forms P and dS in registers and writes them to
//     shared memory as bf16. Phase 2: each warp accumulates a 16 x D/2
//     piece of dV and dK (or dQ) from those tiles, so at D = 256 a thread
//     holds 2 x 64 f32 accumulators.
//   * P and dS enter the tensor cores as one bf16 each (relative error
//     2^-9 per element, summed over many keys with random signs): the
//     stated tolerance of the card check (each of dq, dk, dv within
//     2^-6 * max |plain| and rel L2 2^-7 of the f32 plain version) holds
//     them; the forward's exact hi/lo split is not needed here.
//   * only tiles that cross the diagonal, the window's lower edge or the
//     end of the sequence are masked; a masked P is set to 0 (a select, so
//     an overflowing exponent never reaches dS). A row whose forward
//     normaliser was 0 (W = 0 only) has lse = +inf, so its P is 0; at
//     W = 0 no tile is visited and dq, dk, dv are 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int BR = 64;        // rows of the block's fixed tile
constexpr int BC = 64;        // rows of each streamed tile
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct BwdTile {
  static constexpr int ROW = D * 2 + 16;     // padded bytes of a D-wide row
  static constexpr int TILE = BR * ROW;      // one 64 x D tile (BR == BC)
  static constexpr int PROW = BC * 2 + 16;   // padded bytes of a 64-wide row
  static constexpr int PTILE = BR * PROW;    // one 64 x 64 bf16 tile
  static constexpr int VEC = BC * 4;         // 64 f32 (lse or delta)
  // dkdv: K, V; two stages of Q, dO, lse, delta; P^T and dS^T.
  static constexpr int SMEM_DKDV = 2 * TILE + 2 * (2 * TILE + 2 * VEC)
                                   + 2 * PTILE;
  // dq: Q, dO, lse, delta; two stages of K, V; dS.
  static constexpr int SMEM_DQ = 2 * TILE + 2 * VEC + 2 * (2 * TILE) + PTILE;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c(16 x 8) += a(16 x 16) b(16 x 8), bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of one head's (T, D) bf16 matrix into a padded
// shared tile by cp.async, rows past T filled with zeros.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* head, int row0,
                                          int T) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = threadIdx.x; i < BR * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool in = row0 + r < T;
    const __nv_bfloat16* src = head + (in ? (long long)(row0 + r) * D + c * 8
                                          : 0);
    cp_async16(dst + r * BwdTile<D>::ROW + c * 16, src, in ? 16 : 0);
  }
}

// acc(16 x 32) += X[16 rb .., :] Y[32 cb .., :]^T over k = D; X and Y are
// padded [row][d] tiles. acc[j] is the j-th 8-column piece.
template <int D>
__device__ __forceinline__ void mma_xyt(float (&acc)[4][4], uint32_t s_x,
                                        uint32_t s_y, int rb, int cb,
                                        int lane) {
  constexpr int ROW = BwdTile<D>::ROW;
  const uint32_t a_addr =
      s_x + (16 * rb + (lane & 15)) * ROW + (lane >> 4) * 16;
  const uint32_t b_addr = s_y
      + (32 * cb + (lane & 7) + ((lane >> 4) << 3)) * ROW
      + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], b0[4], b1[4];
    ldsm_x4(a_addr + kk * 32, a);
    ldsm_x4(b_addr + kk * 32, b0);
    ldsm_x4(b_addr + 16 * ROW + kk * 32, b1);
    mma16816(acc[0], a, b0[0], b0[1]);
    mma16816(acc[1], a, b0[2], b0[3]);
    mma16816(acc[2], a, b1[0], b1[1]);
    mma16816(acc[3], a, b1[2], b1[3]);
  }
}

// acc(16 x D/2) += R[16 rb .., 0:64] Z[0:64, hb D/2 ..]; R a padded 64 x 64
// bf16 tile, Z a padded [row][d] tile read transposed.
template <int D>
__device__ __forceinline__ void mma_rz(float (&acc)[D / 16][4], uint32_t s_r,
                                       uint32_t s_z, int rb, int hb,
                                       int lane) {
  constexpr int ROW = BwdTile<D>::ROW, PROW = BwdTile<D>::PROW;
  const uint32_t a_addr =
      s_r + (16 * rb + (lane & 15)) * PROW + (lane >> 4) * 16;
  const uint32_t b_addr =
      s_z + (lane & 15) * ROW + (hb * (D / 2) + (lane >> 4) * 8) * 2;
#pragma unroll
  for (int kc = 0; kc < BC / 16; ++kc) {
    uint32_t a[4];
    ldsm_x4(a_addr + kc * 32, a);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      uint32_t b[4];
      ldsm_x4_t(b_addr + kc * 16 * ROW + i * 32, b);
      mma16816(acc[2 * i], a, b[0], b[1]);
      mma16816(acc[2 * i + 1], a, b[2], b[3]);
    }
  }
}

// Rows of a 16 x D/2 accumulator piece (rows 16 rb + lane/4 and + 8,
// columns hb D/2 + 8 j + 2 (lane % 4)) times `mul`, as bf16, rows < T.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* head,
                                           const float (&acc)[D / 16][4],
                                           int row0, int rb, int hb, int lane,
                                           int T, float mul) {
  const int r = row0 + 16 * rb + lane / 4;
  const int c = hb * (D / 2) + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    if (r < T)
      *reinterpret_cast<uint32_t*>(head + (long long)r * D + c + 8 * j) =
          pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    if (r + 8 < T)
      *reinterpret_cast<uint32_t*>(head + (long long)(r + 8) * D + c + 8 * j) =
          pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * (THREADS / 8) + threadIdx.x / 8;
  const int sub = threadIdx.x % 8;
  float acc = 0.f;
  if (row < rows) {
    const uint4* po = reinterpret_cast<const uint4*>(o + row * D);
    const uint4* pd = reinterpret_cast<const uint4*>(dout + row * D);
#pragma unroll
    for (int c = sub; c < D / 8; c += 8) {
      const uint4 a = po[c], b = pd[c];
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]);
        const float2 y = __bfloat1622float2(b2[e]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (sub == 0 && row < rows) delta[row] = acc;
}

// Whether a 64-query tile at q0 and a 64-key tile at k0 hold a pair that is
// not live (across the diagonal or the window's lower edge, or past T).
__device__ __forceinline__ bool edge_tile(int q0, int k0, int T, int W) {
  return k0 + BC - 1 > q0 || k0 <= q0 + BR - 1 - W || q0 + BR > T ||
         k0 + BC > T;
}

__device__ __forceinline__ bool live(int qp, int kp, int T, int W) {
  return kp <= qp && kp > qp - W && qp < T;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Hq, int Hkv, int T,
                      int W, float sl2, float scale) {
  using C = BwdTile<D>;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t s_k = base, s_v = base + C::TILE;
  const uint32_t s_stage = base + 2 * C::TILE;  // [2][Q, dO]
  const uint32_t s_p = s_stage + 4 * C::TILE;
  const uint32_t s_ds = s_p + C::PTILE;
  float* const v_lse = reinterpret_cast<float*>(
      smem + 4 * C::TILE + 2 * C::TILE + 2 * C::PTILE);  // [2][BC]
  float* const v_delta = v_lse + 2 * BC;                  // [2][BC]

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv, kvh = bkv % Hkv;
  const int G = Hq / Hkv;
  const int k_lo = blockIdx.y * BR;
  const int qt_lo = blockIdx.y;  // BR == BC: the first query tile >= k_lo
  const int qt_hi = min(k_lo + BR - 1 + W - 1, T - 1) / BC;
  const int n_qt = W > 0 ? qt_hi - qt_lo + 1 : 0;
  const int n_it = G * n_qt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rb = warp & 3, cb = warp >> 2;

  const long long kv_off = (long long)bkv * T;
  load_tile<D>(s_k, k + kv_off * D, k_lo, T);
  load_tile<D>(s_v, v + kv_off * D, k_lo, T);
  cp_async_commit();

  auto stage_in = [&](int it) {
    const int st = it & 1;
    const int h = kvh * G + it / n_qt;
    const int q0 = (qt_lo + it % n_qt) * BC;
    const long long off = (long long)(b * Hq + h) * T;
    load_tile<D>(s_stage + (2 * st) * C::TILE, q + off * D, q0, T);
    load_tile<D>(s_stage + (2 * st + 1) * C::TILE, dout + off * D, q0, T);
    if (threadIdx.x < BC) {
      const int row = q0 + threadIdx.x;
      v_lse[st * BC + threadIdx.x] = row < T ? lse[off + row] * LOG2E
                                             : INFINITY;
      v_delta[st * BC + threadIdx.x] = row < T ? delta[off + row] : 0.f;
    }
  };

  float acc_dk[D / 16][4], acc_dv[D / 16][4];
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

  if (n_it > 0) stage_in(0);
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) stage_in(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t s_q = s_stage + (2 * st) * C::TILE;
    const uint32_t s_do = s_q + C::TILE;
    const int q0 = (qt_lo + it % n_qt) * BC;

    // Phase 1: S^T = K Q^T and dP^T = V dO^T, 16 keys x 32 queries a warp.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_xyt<D>(s, s_k, s_q, rb, cb, lane);
    mma_xyt<D>(dp, s_v, s_do, rb, cb, lane);
    const bool edge = edge_tile(q0, k_lo, T, W);
    const float* lse2 = v_lse + st * BC;
    const float* dlt = v_delta + st * BC;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * rb + lane / 4 + (e >> 1) * 8;
        const int c = 32 * cb + 8 * j + 2 * (lane % 4) + (e & 1);
        float p = ex2(fmaf(s[j][e], sl2, -lse2[c]));
        if (edge && !live(q0 + c, k_lo + r, T, W)) p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dlt[c]);
      }
    {
      const int r = 16 * rb + lane / 4;
      const int c = 32 * cb + 2 * (lane % 4);
      uint8_t* const sp = smem + (s_p - base);
      uint8_t* const sds = smem + (s_ds - base);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o0 = r * C::PROW + (c + 8 * j) * 2;
        const int o1 = o0 + 8 * C::PROW;
        *reinterpret_cast<uint32_t*>(sp + o0) = pack_bf16(s[j][0], s[j][1]);
        *reinterpret_cast<uint32_t*>(sp + o1) = pack_bf16(s[j][2], s[j][3]);
        *reinterpret_cast<uint32_t*>(sds + o0) = pack_bf16(dp[j][0], dp[j][1]);
        *reinterpret_cast<uint32_t*>(sds + o1) = pack_bf16(dp[j][2], dp[j][3]);
      }
    }
    __syncthreads();

    // Phase 2: dV += P^T dO, dK += dS^T Q, 16 keys x D/2 columns a warp.
    mma_rz<D>(acc_dv, s_p, s_do, rb, cb, lane);
    mma_rz<D>(acc_dk, s_ds, s_q, rb, cb, lane);
    __syncthreads();
  }
  cp_async_wait<0>();

  store_rows<D>(dk + kv_off * D, acc_dk, k_lo, rb, cb, lane, T, scale);
  store_rows<D>(dv + kv_off * D, acc_dv, k_lo, rb, cb, lane, T, 1.f);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Hq, int Hkv, int T,
                    int W, float sl2, float scale) {
  using C = BwdTile<D>;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_u32(smem);
  const uint32_t s_q = base, s_do = base + C::TILE;
  const uint32_t s_stage = base + 2 * C::TILE;  // [2][K, V]
  const uint32_t s_ds = s_stage + 4 * C::TILE;
  float* const v_lse = reinterpret_cast<float*>(smem + 6 * C::TILE
                                                + C::PTILE);  // [BR]
  float* const v_delta = v_lse + BR;                          // [BR]

  const int nq = (T + BR - 1) / BR;
  const int q_lo = (nq - 1 - (int)blockIdx.y) * BR;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int q_hi = min(q_lo + BR, T) - 1;
  const int kt_lo = max(q_lo - W + 1, 0) / BC;
  const int kt_hi = q_hi / BC;
  const int n_it = W > 0 ? kt_hi - kt_lo + 1 : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rb = warp & 3, cb = warp >> 2;

  const long long q_off = (long long)bh * T;
  const long long kv_off = (long long)bkv * T;
  load_tile<D>(s_q, q + q_off * D, q_lo, T);
  load_tile<D>(s_do, dout + q_off * D, q_lo, T);
  cp_async_commit();
  if (threadIdx.x < BR) {
    const int row = q_lo + threadIdx.x;
    v_lse[threadIdx.x] = row < T ? lse[q_off + row] * LOG2E : INFINITY;
    v_delta[threadIdx.x] = row < T ? delta[q_off + row] : 0.f;
  }

  auto stage_in = [&](int it) {
    const int st = it & 1;
    const int k0 = (kt_hi - it) * BC;
    load_tile<D>(s_stage + (2 * st) * C::TILE, k + kv_off * D, k0, T);
    load_tile<D>(s_stage + (2 * st + 1) * C::TILE, v + kv_off * D, k0, T);
  };

  float acc_dq[D / 16][4];
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dq[j][e] = 0.f;

  if (n_it > 0) stage_in(0);
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) stage_in(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t s_k = s_stage + (2 * st) * C::TILE;
    const uint32_t s_v = s_k + C::TILE;
    const int k0 = (kt_hi - it) * BC;

    // Phase 1: S = Q K^T and dP = dO V^T, 16 queries x 32 keys a warp.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_xyt<D>(s, s_q, s_k, rb, cb, lane);
    mma_xyt<D>(dp, s_do, s_v, rb, cb, lane);
    const bool edge = edge_tile(q_lo, k0, T, W);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * rb + lane / 4 + (e >> 1) * 8;
        const int c = 32 * cb + 8 * j + 2 * (lane % 4) + (e & 1);
        float p = ex2(fmaf(s[j][e], sl2, -v_lse[r]));
        if (edge && !live(q_lo + r, k0 + c, T, W)) p = 0.f;
        dp[j][e] = p * (dp[j][e] - v_delta[r]);
      }
    {
      const int r = 16 * rb + lane / 4;
      const int c = 32 * cb + 2 * (lane % 4);
      uint8_t* const sds = smem + (s_ds - base);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o0 = r * C::PROW + (c + 8 * j) * 2;
        *reinterpret_cast<uint32_t*>(sds + o0) = pack_bf16(dp[j][0], dp[j][1]);
        *reinterpret_cast<uint32_t*>(sds + o0 + 8 * C::PROW) =
            pack_bf16(dp[j][2], dp[j][3]);
      }
    }
    __syncthreads();

    // Phase 2: dQ += dS K, 16 queries x D/2 columns a warp.
    mma_rz<D>(acc_dq, s_ds, s_k, rb, cb, lane);
    __syncthreads();
  }
  cp_async_wait<0>();

  store_rows<D>(dq + q_off * D, acc_dq, q_lo, rb, cb, lane, T, scale);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* lse, const void* dout, void* dq, void* dk,
                   void* dv, void* delta, int B, int Hq, int Hkv, int T, int W,
                   cudaStream_t stream) {
  using C = BwdTile<D>;
  typedef __nv_bfloat16 bf;
  const long long rows = (long long)B * Hq * T;
  const long long delta_blocks = (rows + THREADS / 8 - 1) / (THREADS / 8);
  const int nq = (T + BR - 1) / BR;
  if (nq > 65535 || delta_blocks > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM_DKDV);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM_DQ);
  if (e != cudaSuccess) return e;
  const float sl2 = (float)(1.4426950408889634 / sqrt((double)D));
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_bwd_delta_kernel<D><<<(unsigned)delta_blocks, THREADS, 0, stream>>>(
      (const bf*)o, (const bf*)dout, (float*)delta, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<D><<<dim3(B * Hkv, nq), THREADS, C::SMEM_DKDV,
                              stream>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout,
      (const float*)lse, (const float*)delta, (bf*)dk, (bf*)dv, Hq, Hkv, T, W,
      sl2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<D><<<dim3(B * Hq, nq), THREADS, C::SMEM_DQ, stream>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout,
      (const float*)lse, (const float*)delta, (bf*)dq, Hq, Hkv, T, W, sl2,
      scale);
  return cudaGetLastError();
}

}  // namespace

// Launches B5-bwd on `stream`: bf16 q, o, dout, dq (B, Hq, T, D); k, v, dk,
// dv (B, Hkv, T, D); f32 lse (B, Hq, T) in natural-log units of the scaled
// scores (as flash_tc.cu writes it) and f32 scratch delta (B, Hq, T); all
// contiguous with 16-byte aligned bases, D in {64, 128, 256}; W is the
// window (T for full causal, 0 for none). Three kernels: delta, dk/dv, dq.
// Returns the CUDA error code of the launches (0 = success). Allocates
// nothing and does not synchronise.
extern "C" int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int B, int Hq, int Hkv, int T, int D, int W, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || (long long)B * Hkv > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64:
      return (int)launch<64>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Hq,
                             Hkv, T, W, s);
    case 128:
      return (int)launch<128>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Hq,
                              Hkv, T, W, s);
    case 256:
      return (int)launch<256>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, Hq,
                              Hkv, T, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
