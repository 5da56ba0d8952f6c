// The f32 backward of the banded flash attention with GQA, for sm_90a:
// f32 q, k, v, o, dO at every head size of the registry (D 16, 64, 80,
// 128, 256), f32 lse from the split-TF32 forward (flash_tf32x3.cu). (bf16
// runs forward and backward on bf16 tensor cores: csrc/flash_tc.cu,
// csrc/flash_tc_bwd.cu.)
//
// Replaces the backward that the JAX package gets by differentiating its
// attention (`jax.grad` through `_chunked_attention`); the TPU kernel
// `_flash_kernel` of src/repro/kernels/local_attention/local_attention.py
// has no backward of its own. Same function as the forward: the mask is
// (k_pos <= q_pos) & (k_pos > q_pos - W), q head h reads kv head
// h / (Hq / Hkv), W = T is full causal. With s = q.k, scale = the
// forward's f32 1/sqrt(D) and lse the forward's per-row log-sum-exp of
// s * scale:
//
//   P  = exp(s * scale - lse)         (0 where masked)
//   dV = P^T dO       dP = dO V^T     delta = rowsum(dO * O)
//   dS = P * (dP - delta)
//   dQ = scale dS K   dK = scale dS^T Q      (dK, dV summed over G)
//
// What bounds it on an H100: 5 products of 2*D FLOP per live (query, key)
// pair, 10*D in all, at f32 accuracy on the tensor cores; against the
// TF32 peak (494.7 TFLOP/s) that is the bound chip_smoke.py states.
//
// Design at D 16, 64, 80 and 128 (`split_bwd_kernel`): B5-bwd's pipeline
// (flash_tc_bwd.cu) on bf16 wgmma, every f32 operand split into three
// bf16 pieces.
//
//   * Why bf16 pieces and not tf32: tf32 wgmma takes only K-major
//     operands from shared memory, and the backward contracts over d (S,
//     dP), over queries (dV, dK) and over keys (dQ), so a tf32 design
//     needs transposed hi and lo planes of Q, dO and K beside the direct
//     ones: more than 227 KB at a 64-key tile and D 128. bf16 wgmma reads
//     MN-major operands as well, so one plane of each piece serves every
//     product.
//   * The split: x = x1 + x2 + x3, x1 = bf16(x), x2 = bf16(x - x1), x3 =
//     bf16(x - x1 - x2), all rounded to nearest. x - x1 is exact in f32
//     and spans at most 16 significant bits, x - x1 - x2 at most 8, so x3
//     is exact and the three pieces sum to x (for |x| >= 2^-110; below,
//     x3's last bits fall under bf16's smallest subnormal, 2^-133, and
//     the sum is within 2^-134 of x). A product a.b keeps the six piece
//     products a_i b_j with i + j <= 4 (1-based); the three dropped are
//     below 2^-24 |a||b| each, as small as the mma.sync split's dropped
//     lo*lo (2^-22). Six bf16 passes issue as long as three tf32 ones.
//   * a pre-pass (`split_bwd_prep_kernel`) writes, per query row padded to
//     a multiple of 64, delta = rowsum(dO * O) in f32 and lse * log2(e)
//     (+inf on the padding), zeroes dq (the TMA reductions' target), and
//     writes the three pieces of q and dO; `split_kv_kernel` writes those
//     of k and v. Each tensor's pieces are one bf16 array (3, B*H, T, D),
//     read by one tensor map whose third coordinate is piece * B*H + head.
//     At 2 x 16 / 8 heads x 2,048 x 128 the pre-passes read 134 MB and
//     write 185 MB: 0.095 ms at the H100 SXM's 3.35 TB/s.
//   * one block per (b, kv head, 64-key tile), key tiles issued
//     first-to-last, looping over the G query heads of its group and, for
//     each, the 32-query tiles that meet [k_lo, k_hi + W - 1] n [0, T).
//     The producer warpgroup (24 registers) has one thread issue TMA
//     loads: the pieces of K and V once, then the pieces of each Q and dO
//     tile and its lse and delta (bulk copies) into a 2-stage ring. Rows
//     are staged as whole 64-column chunks of 128 bytes with the 128-byte
//     swizzle (D 16 at 64 columns, D 80 at 128; TMA zero-fills past T and
//     D and counts the zeros in the barrier's bytes).
//   * two consumer warpgroups (240 registers) split the work as B5-bwd's
//     D 256 kernel does: warpgroup 0 forms S^T = K Q^T (m64n32k16, both
//     K-major), P^T, and dV += P^T dO; warpgroup 1 forms dP^T = V dO^T,
//     dS^T = P^T (dP^T - delta) with P^T handed over through shared memory
//     in f32 (each thread's fragment at the same place: no rounding), and
//     dK += dS^T Q. P^T and dS^T are split in registers and enter as
//     register A operands (the accumulator layout is the A layout), dO and
//     Q MN-major. Warpgroup 1 writes dS's pieces query-major (K-major for
//     the next product), and each warpgroup w computes rows [64 w, 64 w +
//     64) of dQ^T = K^T dS^T (K read MN-major, dS K-major; at D 16 and 64
//     warpgroup 0 alone, at D 80 warpgroup 1's rows 80-127 are zeros). Its
//     f32 tile goes transposed into a staging tile (boxes of 32 columns,
//     128-byte swizzle), times scale, and one thread adds it into dq by
//     TMA reductions (cp.reduce.async.bulk.tensor .add.f32; rows past T
//     and columns past D dropped). The order of those f32 sums varies from
//     run to run, so dq may differ in its last bits between two calls on
//     the same inputs; dk and dv do not.
//   * the accumulation chains stay short. The tensor cores' f32
//     accumulation does not round to nearest: the mma.sync design measured
//     1.1e-4 of max |dv| at D 256, G 8, T 1,500 from one accumulator over
//     all G x T queries, against a 1e-4 check (H100 80GB HBM3, 700 W). Here each query tile's share
//     of dV or dK (six passes x two k-steps: 12 wgmma adds) is summed in a
//     fresh accumulator and added to the running f32 sum by the thread,
//     rounding to nearest; S^T and dP^T issue the five small piece products
//     over all of D before the main one, so the large terms meet an
//     accumulator that is still small only D / 16 times; dQ^T's tile is
//     fresh per query tile (24 adds).
//
// The shared-memory plan (BK = 64 keys, BQ = 32 queries, 2 stages, DP =
// D staged at whole 64-column chunks; bytes):
//
//   K, V pieces   2 x 3 x 64 x DP x 2      DP 128: 98,304   DP 64: 49,152
//   Q, dO stages  2 x 2 x 3 x 32 x DP x 2           98,304          49,152
//   dS pieces     3 x 32 x 64 x 2                   12,288          12,288
//   P^T hand-over / warpgroup 0's dQ^T staging       8,192           8,192
//   warpgroup 1's dQ^T staging (64 x 32 f32)         8,192           8,192
//   lse2, delta (2 stages), 5 mbarriers, 1 KB for the swizzle's alignment
//                                                    1,576           1,576
//   total                                          226,856         128,552
//
// against the 232,448 bytes a block may have: D 80 and 128 (DP 128) fit
// with 5.5 KB to spare, and 64-query tiles (192 KB of Q and dO) or a
// third stage do not. The hand-over tile doubles as warpgroup 0's staging
// (its last reduction is waited for before the next P^T is written).
// Registers of a consumer thread at D 128: the running dV or dK (64 f32),
// the fresh tile (64), S^T or dP^T (16), the pieces of P^T or dS^T (24)
// and dQ^T (16); the running sum and its tile are 2 x D / 2 f32.
//
// D 256 stays on the first design, the mma.sync kernel
// (`flash_tf32x3_bwd_kernel`): its K and V pieces alone would take 196,608
// bytes of shared memory at 64 keys, and its running dV or dK with a fresh
// tile 256 registers a thread. Its note follows below.
//
// Rows and keys past T read as zero, are masked and never written. A row
// whose forward normaliser was 0 (W = 0 only) has lse = +inf, so its P is
// 0; at W = 0 no tile is visited and dq, dk, dv are 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "flash_hopper.cuh"
#include "flash_tf32x3.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int ROW_PAD = 64;  // lse * log2(e) and delta rows: a multiple of it
constexpr int NP = 3;        // bf16 pieces of an f32 operand

__device__ __forceinline__ bool live(int qp, int kp, int T, int W) {
  return kp <= qp && kp > qp - W && qp < T;
}

// The pieces of four consecutive f32 values into three planes `plane`
// elements apart.
__device__ __forceinline__ void store_pieces(__nv_bfloat16* p, long long plane,
                                             float4 x) {
  uint32_t a[NP], b[NP];
  split3(x.x, x.y, a[0], a[1], a[2]);
  split3(x.z, x.w, b[0], b[1], b[2]);
#pragma unroll
  for (int i = 0; i < NP; ++i)
    *reinterpret_cast<uint2*>(p + i * plane) = make_uint2(a[i], b[i]);
}

// Per row (b*Hq + h, t) of the padded (B*Hq, Tp) vectors: delta =
// rowsum(dO * O) and lse2 = lse * log2(e) for t < T, 0 and +inf on the
// padding; the row of dq zeroed and the pieces of its q and dO rows
// written (planes `plane` elements apart). 8 threads a row.
template <int D>
__global__ void __launch_bounds__(256)
split_bwd_prep_kernel(const float* __restrict__ q, const float* __restrict__ o,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ delta, float* __restrict__ dq,
                      __nv_bfloat16* __restrict__ qp,
                      __nv_bfloat16* __restrict__ dop, long long rows_p, int T,
                      int Tp, long long plane) {
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x / 8;
  const int sub = threadIdx.x % 8;
  const long long bh = row / Tp;
  const int t = (int)(row - bh * Tp);
  const bool valid = row < rows_p && t < T;
  const long long src = bh * T + t;
  float acc = 0.f;
  if (valid) {
#pragma unroll
    for (int c = sub; c < D / 4; c += 8) {
      const long long i = src * D + 4 * c;
      const float4 x = *reinterpret_cast<const float4*>(o + i);
      const float4 y = *reinterpret_cast<const float4*>(dout + i);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
      *reinterpret_cast<float4*>(dq + i) = make_float4(0.f, 0.f, 0.f, 0.f);
      store_pieces(qp + i, plane, *reinterpret_cast<const float4*>(q + i));
      store_pieces(dop + i, plane, y);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (sub == 0 && row < rows_p) {
    delta[row] = valid ? acc : 0.f;
    lse2[row] = valid ? lse[src] * LOG2E : INFINITY;
  }
}

// The pieces of k (blockIdx.y 0) or v (1), n4 runs of four values each.
__global__ void __launch_bounds__(256)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                __nv_bfloat16* __restrict__ kp, __nv_bfloat16* __restrict__ vp,
                long long n4) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  const float* const src = blockIdx.y == 0 ? k : v;
  store_pieces((blockIdx.y == 0 ? kp : vp) + 4 * i, 4 * n4,
               *reinterpret_cast<const float4*>(src + 4 * i));
}

// ---------------------------------------------------------------------------
// The wgmma design (D 16, 64, 80 and 128).
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 384;  // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;

template <int D>
struct SplitBwd {
  static constexpr int BK = 64;                  // keys per block
  static constexpr int BQ = 32;                  // queries per streamed tile
  static constexpr int STAGES = 2;
  static constexpr int NCH = (D + CHUNK - 1) / CHUNK;  // 64-column chunks
  static constexpr int KV_PIECE = BK * NCH * ROW_BYTES;  // one piece of K, V
  static constexpr int Q_PIECE = BQ * NCH * ROW_BYTES;   // of a Q, dO tile
  static constexpr int DS_PIECE = BQ * BK * 2;   // dS, 32 queries x 64 keys
  static constexpr int F32_TILE = BK * BQ * 4;   // P^T; a dQ^T staging tile
  static constexpr int VEC = BQ * 4;             // 32 f32 (lse2 or delta)
  static constexpr int SMEM = 1024 + 2 * NP * KV_PIECE
                              + STAGES * 2 * NP * Q_PIECE + NP * DS_PIECE
                              + 2 * F32_TILE + STAGES * 2 * VEC
                              + 8 * (1 + 2 * STAGES);
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// D(64 x 32) += A(64 x 16) * B(32 x 16)^T, both in shared memory with the
// 128-byte swizzle: B K-major; A K-major (TA 0) or MN-major (TA 1, read
// transposed from a (K, M) tile).
template <int TA>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA));
}

// The producer's one thread: the pieces of K and V of the block's key tile
// once, then for iteration `it` (query head bh0 + it / n_qt, query tile
// qt_lo + it % n_qt) the pieces of that tile's Q and dO and its lse2 and
// delta into stage it % STAGES, once the consumers have freed it.
template <class C>
__device__ __forceinline__ void produce(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* lse2, const float* delta,
    uint32_t s_k, uint32_t s_stage, uint32_t s_vec, uint32_t bars, int bkv,
    int BHkv, int bh0, int BHq, int k_lo, int qt_lo, int n_qt, int n_it,
    int Tp) {
  constexpr int STAGES = C::STAGES;
  mbar_expect_tx(bars, 2 * NP * C::KV_PIECE);
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) {
      const uint32_t dst = s_k + p * C::KV_PIECE + c * C::BK * ROW_BYTES;
      tma_load(dst, tm_k, c * CHUNK, k_lo, p * BHkv + bkv, bars);
      tma_load(dst + NP * C::KV_PIECE, tm_v, c * CHUNK, k_lo, p * BHkv + bkv,
               bars);
    }
  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES, use = it / STAGES;
    const uint32_t full = bars + 8u * (1 + st);
    if (use > 0) mbar_wait(bars + 8u * (1 + STAGES + st), (use - 1) & 1);
    const int bh = bh0 + it / n_qt;
    const int q0 = (qt_lo + it % n_qt) * C::BQ;
    const uint32_t sq = s_stage + st * 2 * NP * C::Q_PIECE;
    const uint32_t sv = s_vec + st * 2 * C::VEC;
    mbar_expect_tx(full, 2 * NP * C::Q_PIECE + 2 * C::VEC);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        const uint32_t dst = sq + p * C::Q_PIECE + c * C::BQ * ROW_BYTES;
        tma_load(dst, tm_q, c * CHUNK, q0, p * BHq + bh, full);
        tma_load(dst + NP * C::Q_PIECE, tm_do, c * CHUNK, q0, p * BHq + bh,
                 full);
      }
    const long long row = (long long)bh * Tp + q0;
    bulk_load(sv, lse2 + row, C::VEC, full);
    bulk_load(sv + C::VEC, delta + row, C::VEC, full);
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
split_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_dq,
                 const float* __restrict__ lse2,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int Hq, int Hkv, int T, int Tp, int W,
                 float sl2, float scale) {
  using C = SplitBwd<D>;
  constexpr int BK = C::BK, BQ = C::BQ, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_k = (raw + 1023u) & ~1023u;  // [piece] K, then V
  const uint32_t s_v = s_k + NP * C::KV_PIECE;
  const uint32_t s_stage = s_v + NP * C::KV_PIECE;  // [STAGES][Q, dO][piece]
  const uint32_t s_ds = s_stage + STAGES * 2 * NP * C::Q_PIECE;  // [piece]
  const uint32_t s_f0 = s_ds + NP * C::DS_PIECE;  // P^T; warpgroup 0's dQ^T
  const uint32_t s_f1 = s_f0 + C::F32_TILE;       // warpgroup 1's dQ^T
  const uint32_t s_vec = s_f1 + C::F32_TILE;      // [STAGES][lse2, delta]
  const uint32_t bars = s_vec + STAGES * 2 * C::VEC;
  const uint32_t bar_kv = bars;
  auto bar_full = [&](int st) { return bars + 8u * (1 + st); };
  auto bar_empty = [&](int st) { return bars + 8u * (1 + STAGES + st); };

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv, kvh = bkv % Hkv;
  const int G = Hq / Hkv;
  const int k_lo = blockIdx.y * BK;
  const int qt_lo = k_lo / BQ;  // the first query tile that meets the keys
  const int qt_hi = min(k_lo + BK - 1 + W - 1, T - 1) / BQ;
  const int n_qt = W > 0 ? qt_hi - qt_lo + 1 : 0;
  const int n_it = G * n_qt;
  const int bh0 = b * Hq + kvh * G;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0)
      produce<C>(&tm_q, &tm_k, &tm_v, &tm_do, lse2, delta, s_k, s_stage,
                 s_vec, bars, bkv, gridDim.x, bh0, gridDim.x * G, k_lo, qt_lo,
                 n_qt, n_it, Tp);
    return;
  }

  // ---- consumers: warpgroup 0 owns S, P and dV, warpgroup 1 dP, dS, dK --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int w = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  // This thread's rows r0 and r0 + 8 of a 64-row accumulator, and its
  // columns c0 + 8 j and c0 + 8 j + 1.
  const int r0 = (tid / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  float* const hand = reinterpret_cast<float*>(smem_raw + (s_f0 - raw));
  const uint32_t s_a = w == 0 ? s_k : s_v;  // A of S^T or of dP^T

  float run[D / 2];  // dV (warpgroup 0) or dK / scale (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) run[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES, ph = (it / STAGES) & 1;
    const int bh = bh0 + it / n_qt;
    const int q0 = (qt_lo + it % n_qt) * BQ;
    const uint32_t sq = s_stage + st * 2 * NP * C::Q_PIECE;
    const uint32_t sdo = sq + NP * C::Q_PIECE;
    const float* const lse_v = reinterpret_cast<const float*>(
        smem_raw + (s_vec + st * 2 * C::VEC - raw));

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1): 64 keys x
    // 32 queries over D, the five small piece products first.
    float x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = 0.f;
    mbar_wait(bar_full(st), ph);
    fence_regs(x);
    wgmma_fence();
    {
      const uint32_t sb = w == 0 ? sq : sdo;
#pragma unroll
      for (int t = 0; t < 6; ++t)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes
          wgmma_ss_n32<0>(
              x,
              smem_desc(s_a + piece_a(t) * C::KV_PIECE
                            + (kk / 4) * BK * ROW_BYTES + off, 16, 1024),
              smem_desc(sb + piece_b(t) * C::Q_PIECE
                            + (kk / 4) * BQ * ROW_BYTES + off, 16, 1024));
        }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(x);

    if (w == 0) {
      // P^T, masked pairs exactly 0, to warpgroup 1 in f32. The hand-over
      // tile was this warpgroup's last dQ^T staging: wait until its
      // reduction has read it.
      if (tid == 0) bulk_wait_read();
      named_bar(3, 128);
      const bool edge =
          k_lo + BK - 1 > q0 || k_lo <= q0 + BQ - 1 - W || q0 + BQ > T;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_v + 8 * j + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + c0 + (e & 1);
          const int r = r0 + 8 * (e >> 1);
          float p = ex2(fmaf(x[4 * j + e], sl2, -((e & 1) ? l2.y : l2.x)));
          if (edge && !live(q0 + c, k_lo + r, T, W)) p = 0.f;
          x[4 * j + e] = p;
          hand[(4 * j + e) * 128 + tid] = p;
        }
      }
      named_bar(1, 256);
    } else {
      // dS^T = P^T (dP^T - delta).
      named_bar(1, 256);
      const float* const dlt_v = lse_v + BQ;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(dlt_v + 8 * j + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[4 * j + e] = hand[(4 * j + e) * 128 + tid]
                         * (x[4 * j + e] - ((e & 1) ? dl.y : dl.x));
      }
    }

    // The pieces of P^T or dS^T as A operands: k-step kq takes queries
    // [16 kq, 16 kq + 16).
    uint32_t a[2][NP][4];
#pragma unroll
    for (int kq = 0; kq < 2; ++kq)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split3(x[8 * kq + 2 * r], x[8 * kq + 2 * r + 1], a[kq][0][r],
               a[kq][1][r], a[kq][2][r]);
    if (w == 1) {
      // dS's pieces, query-major (32 rows of 64 keys, 128-byte swizzle: the
      // 16-byte unit j of row q sits at unit j ^ (q % 8)). Register pair
      // a[kq][.][r] holds key r0 + 8 (r % 2) at queries 16 kq + 8 (r / 2) +
      // c0 and + 1.
      uint8_t* const p = smem_raw + (s_ds - raw);
#pragma unroll
      for (int kq = 0; kq < 2; ++kq)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = r0 + 8 * (r & 1);
          const int q = 16 * kq + 8 * (r >> 1) + c0;
#pragma unroll
          for (int pc = 0; pc < NP; ++pc)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              *reinterpret_cast<uint16_t*>(
                  p + pc * C::DS_PIECE + (q + e) * ROW_BYTES
                  + (((key >> 3) ^ ((q + e) & 7)) << 4) + (key & 7) * 2) =
                  (uint16_t)(a[kq][pc][r] >> (16 * e));
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }

    // This tile's share of dV = P^T dO or dK / scale = dS^T Q in a fresh
    // accumulator; dO and Q MN-major, k-step kq is 16 query rows.
    float tile[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) tile[i] = 0.f;
    fence_regs(tile);
    fence_regs(a);
    wgmma_fence();
    {
      const uint32_t sb = w == 0 ? sdo : sq;
#pragma unroll
      for (int t = 0; t < 6; ++t)
#pragma unroll
        for (int kq = 0; kq < 2; ++kq)
          wgmma_rs<D>(tile, a[kq][piece_a(t)],
                      smem_desc(sb + piece_b(t) * C::Q_PIECE
                                    + kq * 16 * ROW_BYTES,
                                BQ * ROW_BYTES, 1024));
    }
    wgmma_commit();
    named_bar(2, 256);  // dS's pieces written
    wgmma_wait_all();
    fence_regs(tile);
    fence_regs(a);
    mbar_arrive(bar_empty(st));
#pragma unroll
    for (int i = 0; i < D / 2; ++i) run[i] += tile[i];

    // Rows [64 w, 64 w + 64) of dQ^T = K^T dS^T (this query tile's dQ over
    // the block's 64 keys), then scale * dQ^T into this warpgroup's
    // staging, transposed (boxes of 32 rows x 32 f32 columns, 128-byte
    // swizzle), and one thread adds it into dq by TMA reductions.
    if (w < C::NCH) {
      float dq[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) dq[i] = 0.f;
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 6; ++t)
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_ss_n32<1>(
              dq,
              smem_desc(s_k + piece_a(t) * C::KV_PIECE + w * BK * ROW_BYTES
                            + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024),
              smem_desc(s_ds + piece_b(t) * C::DS_PIECE + kk * 32, 16,
                        1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
      const uint32_t stage = w == 0 ? s_f0 : s_f1;
      if (w == 1) {  // warpgroup 0 waited before it wrote P^T
        if (tid == 0) bulk_wait_read();
        named_bar(4, 128);
      }
      uint8_t* const p = smem_raw + (stage - raw);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = r0 + 8 * hh, q = 8 * j + c0 + e;
            *reinterpret_cast<float*>(
                p + (d >> 5) * (BQ * ROW_BYTES) + q * ROW_BYTES
                + ((((d & 31) >> 2) ^ (q & 7)) << 4) + (d & 3) * 4) =
                dq[4 * j + 2 * hh + e] * scale;
          }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_bar(3 + w, 128);
      if (tid == 0) {
#pragma unroll
        for (int bx = 0; bx < 2; ++bx)
          if (64 * w + 32 * bx < D)
            tma_reduce_add(stage + bx * BQ * ROW_BYTES, &tm_dq,
                           64 * w + 32 * bx, q0, bh);
        bulk_commit();
      }
    }
  }
  if (tid == 0) bulk_wait();

  // dV (warpgroup 0) or dK = scale * run (warpgroup 1); rows past T are
  // not written.
  const float mul = w == 0 ? 1.f : scale;
  float* const out = (w == 0 ? dv : dk) + (long long)bkv * T * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k_lo + r0 + 8 * hh;
    if (key < T) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(out + (long long)key * D + 8 * j + c0) =
            make_float2(run[4 * j + 2 * hh] * mul,
                        run[4 * j + 2 * hh + 1] * mul);
    }
  }
}

template <int D>
cudaError_t launch_split(const float* q, const float* k, const float* v,
                         const float* o, const float* lse, const float* dout,
                         float* dq, float* dk, float* dv, float* rowvec,
                         __nv_bfloat16* pieces, int B, int Hq, int Hkv, int T,
                         int W, cudaStream_t stream) {
  using C = SplitBwd<D>;
  const int Tp = (T + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  const long long BHq = (long long)B * Hq, BHkv = (long long)B * Hkv;
  const long long rows_p = BHq * Tp;
  const long long prep_blocks = (rows_p + 31) / 32;
  const long long plane_q = BHq * T * D, plane_k = BHkv * T * D;
  const long long kv_blocks = (plane_k / 4 + 255) / 256;
  const int nk = (T + C::BK - 1) / C::BK;
  if (pieces == nullptr || nk > 65535 || prep_blocks > 2147483647LL
      || kv_blocks > 2147483647LL || NP * BHq > 2147483647LL)
    return cudaErrorInvalidValue;
  float* const lse2 = rowvec;
  float* const delta = lse2 + rows_p;
  __nv_bfloat16* const qp = pieces;
  __nv_bfloat16* const dop = qp + NP * plane_q;
  __nv_bfloat16* const kp = dop + NP * plane_q;
  __nv_bfloat16* const vp = kp + NP * plane_k;
  const float sl2 = (float)(1.4426950408889634 / sqrt((double)D));
  const float scale = (float)(1.0 / sqrt((double)D));
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  if (!make_map(&tm_q, qp, D, T, (int)(NP * BHq), C::BQ) ||
      !make_map(&tm_do, dop, D, T, (int)(NP * BHq), C::BQ) ||
      !make_map(&tm_k, kp, D, T, (int)(NP * BHkv), C::BK) ||
      !make_map(&tm_v, vp, D, T, (int)(NP * BHkv), C::BK) ||
      !make_map_f32(&tm_dq, dq, D, T, (int)BHq, C::BQ))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      split_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (e != cudaSuccess) return e;
  split_bwd_prep_kernel<D><<<(unsigned)prep_blocks, 256, 0, stream>>>(
      q, o, dout, lse, lse2, delta, dq, qp, dop, rows_p, T, Tp, plane_q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  split_kv_kernel<<<dim3((unsigned)kv_blocks, 2), 256, 0, stream>>>(
      k, v, kp, vp, plane_k / 4);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  split_bwd_kernel<D><<<dim3((unsigned)BHkv, nk), WG_THREADS, C::SMEM,
                        stream>>>(tm_q, tm_k, tm_v, tm_do, tm_dq, lse2, delta,
                                  dk, dv, Hq, Hkv, T, Tp, W, sl2, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// D 256: the mma.sync design.
//
//   * a pre-pass (`flash_tf32x3_bwd_prep_kernel`) writes delta =
//     rowsum(dO * O) per row in f32 and zeroes dq, which is its own f32
//     accumulator.
//   * one block of 4 warps per (64-key tile, b * kv head, chunk of 64
//     output columns), so that a warp's dK and dV accumulators (16 keys x
//     64, f32) stay in registers. Each chunk's block recomputes S and dP
//     over the whole of D (2.2x the products). K and V (the whole tile, f32
//     in shared memory) are staged once; the block then loops over the G q
//     heads of its kv head and, for each, over the 32-row query tiles that
//     meet the tile's band, staging q * scale, dO, lse and delta of each.
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
//     into the f32 accumulator with float2 atomics.
//   * every operand split into tf32 hi + lo as in the forward (its note),
//     the dropped lo*lo term below 2^-21 of a product: three passes a
//     product. dK and dV sum each query tile's share in a fresh fragment
//     and add it to their registers in f32 (the accumulation note above).
// ---------------------------------------------------------------------------

using namespace tf32x3;

constexpr int BKV = 64;       // keys per block, 16 a warp
constexpr int BQT = 32;       // query rows per step
constexpr int DSS = BQT + 4;  // dS^T row stride: 4 (mod 32)

struct Cfg256 {
  static constexpr int D = 256;
  static constexpr int DC = 64;          // output columns per block
  static constexpr int NCH = D / DC;     // column chunks (grid.z)
  static constexpr int KD = D / 8;       // k-steps over D
  static constexpr int NC = DC / 8;      // n-tiles of a warp's dK, dV
  static constexpr int NQ = DC / 16;     // n-tiles of a warp's dQ
  // Row stride of K, V, q and dO in floats: 8 (mod 32), so that the
  // 8-byte fragment loads (row g, d 2t) are free of bank conflicts.
  static constexpr int S = D + 8;
  static constexpr int SMEM_FLOATS =
      2 * BKV * S + 2 * BQT * S + BKV * DSS + 2 * BQT;
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
// sum is formed in a fresh fragment, then added to acc in f32.
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
__global__ void __launch_bounds__(256)
flash_tf32x3_bwd_prep_kernel(const float* __restrict__ o,
                             const float* __restrict__ dout,
                             float* __restrict__ delta,
                             float* __restrict__ dq_acc, long long rows) {
  constexpr int D = Cfg256::D;
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

__global__ void __launch_bounds__(THREADS, 1)
flash_tf32x3_bwd_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq_acc, float* __restrict__ dk,
                        float* __restrict__ dv, int Hq, int Hkv, int Tlen,
                        int W, float scale) {
  using C = Cfg256;
  constexpr int D = C::D, S = C::S, KD = C::KD, NC = C::NC, NQ = C::NQ,
                DC = C::DC;
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
            const bool lv = key <= qp && key > qp - W && qp < Tlen;
            const float p =
                lv ? exp2f(fmaf(st[j][e], LOG2E, -lse2[ql])) : 0.f;
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

cudaError_t launch_mma_sync(const float* q, const float* k, const float* v,
                            const float* o, const float* lse,
                            const float* dout, float* dq, float* dk,
                            float* dv, float* delta, int B, int Hq, int Hkv,
                            int Tlen, int W, cudaStream_t s) {
  using C = Cfg256;
  if (B * Hkv > 65535) return cudaErrorInvalidValue;
  const long long rows = (long long)B * Hq * Tlen;
  flash_tf32x3_bwd_prep_kernel<<<(unsigned)((rows + 31) / 32), 256, 0, s>>>(
      o, dout, delta, dq, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int smem = C::SMEM_FLOATS * (int)sizeof(float);
  e = cudaFuncSetAttribute(flash_tf32x3_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tlen + BKV - 1) / BKV, B * Hkv, C::NCH);
  const float scale = (float)(1.0 / sqrt((double)C::D));
  flash_tf32x3_bwd_kernel<<<grid, THREADS, smem, s>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, Hq, Hkv, Tlen, W, scale);
  return cudaGetLastError();
}

}  // namespace

// Launches the f32 flash attention backward on `stream`: f32 q, o, dout and
// dq (B, Hq, T, D), k, v, dk and dv (B, Hkv, T, D), D in {16, 64, 80, 128,
// 256}; f32 lse (B, Hq, T) as the forward (flash_tf32x3.cu) wrote it; f32
// scratch `rowvec` (2, B*Hq, Tp), Tp = T rounded up to a multiple of 64
// (lse * log2(e) and delta); bf16 scratch `pieces` of 3 * (2*B*Hq +
// 2*B*Hkv) * T * D elements (the pieces of q, dO, k and v; unused, and
// may be null, at D 256); all contiguous with 16-byte aligned bases. W is
// the window (T for full causal, 0 for none). D 16-128: the pre-pass, the
// k/v split and `split_bwd_kernel`; D 256: the mma.sync pre-pass and
// kernel (rowvec's first B*Hq*T floats as delta). Returns the CUDA error
// code of the launches (0 = success). Allocates nothing and does not
// synchronise.
extern "C" int flash_attention_bwd_tf32x3_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* rowvec, void* pieces, int B, int Hq, int Hkv, int T, int D, int W,
    void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || (long long)B * Hkv > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SPLIT_BWD_ARGS                                                      \
  (const float*)q, (const float*)k, (const float*)v, (const float*)o,       \
      (const float*)lse, (const float*)dout, (float*)dq, (float*)dk,        \
      (float*)dv, (float*)rowvec
  switch (D) {
    case 16:
      return (int)launch_split<16>(SPLIT_BWD_ARGS, (__nv_bfloat16*)pieces, B,
                                   Hq, Hkv, T, W, s);
    case 64:
      return (int)launch_split<64>(SPLIT_BWD_ARGS, (__nv_bfloat16*)pieces, B,
                                   Hq, Hkv, T, W, s);
    case 80:
      return (int)launch_split<80>(SPLIT_BWD_ARGS, (__nv_bfloat16*)pieces, B,
                                   Hq, Hkv, T, W, s);
    case 128:
      return (int)launch_split<128>(SPLIT_BWD_ARGS, (__nv_bfloat16*)pieces,
                                    B, Hq, Hkv, T, W, s);
    case 256:
      return (int)launch_mma_sync(SPLIT_BWD_ARGS, B, Hq, Hkv, T, W, s);
  }
#undef SPLIT_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
