// B5-bwd: the backward of the banded (causal sliding-window) flash attention
// with GQA, on Hopper's tensor cores, for sm_90a: bf16 q, k, v, o, dO at
// every head size of the registry, D in {16, 64, 80, 128, 256}, f32 lse (the
// forward's: csrc/flash_tc.cu's at D 64/128/256, csrc/flash_tf32x3.cu's at
// D 16/80, both natural-log units of the scaled scores).
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
// written once: the tensor cores (989 TFLOP/s bf16). The design at D 16,
// 64, 80 and 128 (`flash_bwd_wgmma_kernel`):
//
//   * a pre-pass (`flash_bwd_prep_kernel`) writes, per query row padded to
//     a multiple of 64, delta = rowsum(dO * O) in f32 and lse * log2(e)
//     (+inf on the padding, so that a padded row's P is 0), and zeroes the
//     f32 scratch dq_acc (B, Hq, T, D).
//   * one block per (b, kv head, 128-key tile), key tiles issued
//     first-to-last (the long columns of a causal pass start first). It
//     loops over the G query heads of its group and, for each, over the
//     64-query tiles that meet [k_lo, k_hi + W - 1] n [0, T): dK and dV are
//     summed over the group in registers and each of their rows is written
//     once.
//   * three warpgroups, as in flash_tc.cu. The producer (24 registers after
//     setmaxnreg) has one thread issue TMA loads: K and V once, then Q, dO
//     (3-D tensor maps: rows past T within a head read as zeros) and the
//     tile's lse and delta (bulk copies) into a 2-stage ring with full and
//     empty mbarriers. Two consumer warpgroups (240 registers) own 64 keys
//     each. Rows are staged as whole 64-column chunks of 128 bytes: at D
//     80 two chunks (128 columns), at D 16 one; the tensor maps keep the
//     true D, so TMA fills the columns past D with zeros (and counts them
//     in the barrier's bytes).
//   * products on wgmma, operands in shared memory with the 128-byte
//     swizzle: S^T = K Q^T and dP^T = V dO^T (m64n64k16, both K-major,
//     D / 16 k-steps: the fifth at D 80 starts the second chunk);
//     P^T and dS^T formed in registers (ex2; tiles that cross the diagonal,
//     the window's lower edge or T select a masked P to exactly 0);
//     dV += P^T dO and dK += dS^T Q with P^T, dS^T as register A operands
//     (the accumulator layout is the A layout) and dO, Q MN-major
//     (m64nDk16: N = 80 reads 16 columns of the second, zero-filled chunk;
//     no product runs on the padding).
//   * dQ in the same pass, 5 products a pair: dS^T goes to shared memory as
//     bf16 (double-buffered, swizzled), and dQ_tile = dS K runs as a wgmma
//     with both operands MN-major (dS read transposed). At D 128 each
//     warpgroup takes 64 of dQ's columns over all 128 keys (a named barrier
//     joins the two halves of dS^T); below D 128 each takes its own 64 keys
//     and all D columns (m64nDk16). Each warpgroup writes its f32 partial
//     into a staging tile in shared memory (boxes of 32 columns, 128-byte
//     swizzle: three at D 80) and one thread adds it into dq_acc with TMA
//     reductions (cp.reduce.async.bulk.tensor .add.f32, rows past T and
//     columns past D dropped by the tensor map). Measured on the H100 at
//     qwen3-0.6b's training shape, that took the kernel from 1.79 to 1.63
//     ms against per-thread float2 reductions (red.global.add) of the same
//     bytes (tools/flash_bwd_times.py, both in one call). A last kernel
//     (`flash_bwd_dq_cast_kernel`) writes dq = bf16(scale * dq_acc). The
//     order of those f32 sums varies from run to run, so dq may differ in
//     its last bits between two calls on the same inputs; dk and dv do not.
//   * P and dS enter the tensor cores as one bf16 each (relative error
//     2^-9 per element, summed over many keys with random signs); sums are
//     f32 and each output is rounded to bf16 once: the card check's
//     tolerance (each of dq, dk, dv within 2^-6 * max |plain| and rel L2
//     2^-7 of the f32 plain version) holds them. A row whose forward
//     normaliser was 0 (W = 0 only) has lse = +inf, so its P is 0; at W = 0
//     no tile is visited and dq, dk, dv are 0.
//
// At D 256 a 64 x 256 f32 accumulator fills a consumer warpgroup's share
// of the registers, so dK and dV cannot both sit in one warpgroup:
// `flash_bwd_wgmma_split_kernel` takes 64-key tiles and gives dV to one
// warpgroup and dK to the other (its note below). The same pre-pass, ring,
// products and rounding; its dQ partials (64 x 128 f32 a warpgroup) have
// no room for a staging tile beside its 218 KB of tiles, so they go to
// dq_acc by per-thread float2 reductions (red.global.add).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "flash_hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int ROW_PAD = 64;  // lse * log2(e) and delta rows: a multiple of it

__device__ __forceinline__ bool live(int qp, int kp, int T, int W) {
  return kp <= qp && kp > qp - W && qp < T;
}

// Per row (b*Hq + h, t) of the padded (B*Hq, Tp) vectors: delta =
// rowsum(dO * O) and lse2 = lse * log2(e) for t < T, 0 and +inf on the
// padding; and the row of dq_acc zeroed. 8 threads a row.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ lse2,
                      float* __restrict__ delta, float* __restrict__ dq_acc,
                      long long rows_p, int T, int Tp) {
  const long long row = (long long)blockIdx.x * 32 + threadIdx.x / 8;
  const int sub = threadIdx.x % 8;
  const long long bh = row / Tp;
  const int t = (int)(row - bh * Tp);
  const bool valid = row < rows_p && t < T;
  const long long src = bh * T + t;
  float acc = 0.f;
  if (valid) {
    const uint4* po = reinterpret_cast<const uint4*>(o + src * D);
    const uint4* pd = reinterpret_cast<const uint4*>(dout + src * D);
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
    float4* const pq = reinterpret_cast<float4*>(dq_acc + src * D);
#pragma unroll
    for (int c = sub; c < D / 4; c += 8) pq[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (sub == 0 && row < rows_p) {
    delta[row] = valid ? acc : 0.f;
    lse2[row] = valid ? lse[src] * LOG2E : INFINITY;
  }
}

// dq = bf16(scale * dq_acc), 8 values a thread.
__global__ void __launch_bounds__(256)
flash_bwd_dq_cast_kernel(const float* __restrict__ dq_acc,
                         __nv_bfloat16* __restrict__ dq, long long n8,
                         float scale) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n8) return;
  const float4 a = reinterpret_cast<const float4*>(dq_acc)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(dq_acc)[2 * i + 1];
  uint4 r;
  r.x = pack_bf16(a.x * scale, a.y * scale);
  r.y = pack_bf16(a.z * scale, a.w * scale);
  r.z = pack_bf16(b.x * scale, b.y * scale);
  r.w = pack_bf16(b.z * scale, b.w * scale);
  reinterpret_cast<uint4*>(dq)[i] = r;
}

// ---------------------------------------------------------------------------
// The wgmma design (D 16, 64, 80 and 128).
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 384;  // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;

template <int D>
struct BwdTile {
  static constexpr int BK = 128;               // keys per block
  static constexpr int BQ = 64;                // queries per streamed tile
  // A row is staged as whole 64-column (128-byte) swizzle chunks: D 16 and
  // 80 at the next multiple of 64, TMA filling the columns past D with
  // zeros. The products run at the true D.
  static constexpr int NCH = (D + CHUNK - 1) / CHUNK;
  static constexpr int DP = NCH * CHUNK;       // staged columns
  static constexpr int STAGES = 2;
  static constexpr int KV_BYTES = BK * DP * 2; // K or V
  static constexpr int Q_BYTES = BQ * DP * 2;  // one Q or dO tile
  static constexpr int DS_BYTES = BK * BQ * 2; // dS^T, 128 keys x 64 queries
  static constexpr int VEC = BQ * 4;           // 64 f32 (lse2 or delta)
  // dQ_tile = dS K: at D 128 each warpgroup takes D/2 = 64 columns (one
  // whole chunk of K) over all BK keys; below, all D columns over its own
  // 64 keys. DQ_N is the product's N.
  static constexpr bool DQ_COLS = D >= 128;
  static constexpr int DQ_KEYS = DQ_COLS ? BK : BK / 2;
  static constexpr int DQ_N = DQ_COLS ? 64 : D;
  // A warpgroup's f32 dQ_tile is staged as boxes of 64 rows x 32 columns
  // (128-byte rows); the reduction's tensor map drops the columns >= D of
  // the last box.
  static constexpr int DQ_BOXES = (DQ_N + 31) / 32;
  static constexpr int DQ_BOX_BYTES = BQ * 32 * 4;
  static constexpr int DQS_BYTES = DQ_BOXES * DQ_BOX_BYTES;
  // 1 KB to align the tiles to the swizzle's 1024-byte period, then K, V,
  // STAGES x (Q, dO), two dS^T buffers, a dQ_tile staging tile per
  // warpgroup, STAGES x (lse2, delta), and 1 + 2 * STAGES mbarriers: 210 KB
  // at D 80.
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + STAGES * 2 * Q_BYTES
                              + 2 * DS_BYTES + 2 * DQS_BYTES
                              + STAGES * 2 * VEC + 8 * (1 + 2 * STAGES);
};

// The ring's barriers at `bars`: K and V's, then per stage "full" (one
// arrival and the stage's bytes) and "empty" (every consumer thread).
template <int STAGES>
__device__ __forceinline__ void init_ring(uint32_t bars) {
  mbar_init(bars, 1);
  for (int st = 0; st < STAGES; ++st) {
    mbar_init(bars + 8u * (1 + st), 1);
    mbar_init(bars + 8u * (1 + STAGES + st), CONSUMERS);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer's one thread: K and V of the block's key tile (V right
// after K) once, then for iteration `it` (query head bh0 + it / n_qt,
// query tile qt_lo + it % n_qt) that tile's Q, dO, lse2 and delta into
// stage it % STAGES, once the consumers have freed it.
template <class C>
__device__ __forceinline__ void produce(
    const CUtensorMap* tm_q, const CUtensorMap* tm_k, const CUtensorMap* tm_v,
    const CUtensorMap* tm_do, const float* lse2, const float* delta,
    uint32_t s_k, uint32_t s_stage, uint32_t s_vec, uint32_t bars, int bkv,
    int bh0, int k_lo, int qt_lo, int n_qt, int n_it, int Tp) {
  constexpr int STAGES = C::STAGES;
  mbar_expect_tx(bars, 2 * C::KV_BYTES);
#pragma unroll
  for (int c = 0; c < C::NCH; ++c) {
    tma_load(s_k + c * C::BK * ROW_BYTES, tm_k, c * CHUNK, k_lo, bkv, bars);
    tma_load(s_k + C::KV_BYTES + c * C::BK * ROW_BYTES, tm_v, c * CHUNK,
             k_lo, bkv, bars);
  }
  for (int it = 0; it < n_it; ++it) {
    const int st = it % STAGES, use = it / STAGES;
    const uint32_t full = bars + 8u * (1 + st);
    if (use > 0) mbar_wait(bars + 8u * (1 + STAGES + st), (use - 1) & 1);
    const int bh = bh0 + it / n_qt;
    const int q0 = (qt_lo + it % n_qt) * C::BQ;
    const uint32_t sq = s_stage + st * 2 * C::Q_BYTES;
    const uint32_t sv = s_vec + st * 2 * C::VEC;
    mbar_expect_tx(full, 2 * C::Q_BYTES + 2 * C::VEC);
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) {
      tma_load(sq + c * C::BQ * ROW_BYTES, tm_q, c * CHUNK, q0, bh, full);
      tma_load(sq + C::Q_BYTES + c * C::BQ * ROW_BYTES, tm_do, c * CHUNK,
               q0, bh, full);
    }
    const long long row = (long long)bh * Tp + q0;
    bulk_load(sv, lse2 + row, C::VEC, full);
    bulk_load(sv + C::VEC, delta + row, C::VEC, full);
  }
}

// D(64 x 16) (+)= A(64 x 16) * B(16 x 16), both MN-major in shared memory
// (128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n16_mn(float (&d)[8], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64) (+)= A(64 x 16) * B(16 x 64), both MN-major in shared memory
// (128-byte swizzle): A read transposed from a (K, M) tile, B from a (K, N)
// tile; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 80) (+)= A(64 x 16) * B(16 x 80), both MN-major in shared memory
// (128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n80_mn(float (&d)[40], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 128) (+)= A(64 x 16) * B(16 x 128), both MN-major in shared memory
// (128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128_mn(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[N / 2], uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (N == 16) wgmma_ss_n16_mn(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64_mn(d, da, db, scale_d);
  else if constexpr (N == 80) wgmma_ss_n80_mn(d, da, db, scale_d);
  else wgmma_ss_n128_mn(d, da, db, scale_d);
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_dq,
                       const float* __restrict__ lse2,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, int Hq, int Hkv, int T,
                       int Tp, int W, float sl2, float scale) {
  using C = BwdTile<D>;
  constexpr int BK = C::BK, BQ = C::BQ, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_k = (raw + 1023u) & ~1023u;
  const uint32_t s_v = s_k + C::KV_BYTES;
  const uint32_t s_stage = s_v + C::KV_BYTES;            // [STAGES][Q, dO]
  const uint32_t s_ds = s_stage + STAGES * 2 * C::Q_BYTES;  // [2][dS^T]
  const uint32_t s_dqs = s_ds + 2 * C::DS_BYTES;  // [2][dQ_tile staging]
  const uint32_t s_vec = s_dqs + 2 * C::DQS_BYTES;  // [STAGES][lse2, delta]
  const uint32_t bars = s_vec + STAGES * 2 * C::VEC;
  const uint32_t bar_kv = bars;
  auto bar_full = [&](int st) { return bars + 8u * (1 + st); };
  auto bar_empty = [&](int st) { return bars + 8u * (1 + STAGES + st); };
  auto s_q = [&](int st) { return s_stage + st * 2 * C::Q_BYTES; };
  auto s_lse = [&](int st) { return s_vec + st * 2 * C::VEC; };

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv, kvh = bkv % Hkv;
  const int G = Hq / Hkv;
  const int k_lo = blockIdx.y * BK;
  const int qt_lo = k_lo / BQ;  // the first query tile that meets the keys
  const int qt_hi = min(k_lo + BK - 1 + W - 1, T - 1) / BQ;
  const int n_qt = W > 0 ? qt_hi - qt_lo + 1 : 0;
  const int n_it = G * n_qt;

  if (threadIdx.x == 0) init_ring<STAGES>(bars);
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0)
      produce<C>(&tm_q, &tm_k, &tm_v, &tm_do, lse2, delta, s_k, s_stage,
                 s_vec, bars, bkv, b * Hq + kvh * G, k_lo, qt_lo, n_qt, n_it,
                 Tp);
  } else {
    // ---- consumers: warpgroup w owns keys [k_lo + 64 w, k_lo + 64 w + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int kw0 = k_lo + 64 * w;
    // This thread's rows r0 and r0 + 8 of a 64-row accumulator, and its
    // columns c0 + 8 j and c0 + 8 j + 1.
    const int r0 = (tid / 32) * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
    const uint32_t s_kw = s_k + 64 * w * ROW_BYTES;
    const uint32_t s_vw = s_v + 64 * w * ROW_BYTES;

    float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % STAGES, ph = (it / STAGES) & 1;
      const int bh = b * Hq + kvh * G + it / n_qt;
      const int q0 = (qt_lo + it % n_qt) * BQ;
      const uint32_t sq = s_q(st), sdo = sq + C::Q_BYTES;

      // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 queries, over k = D.
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      mbar_wait(bar_full(st), ph);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes
        wgmma_ss_n64(s, smem_desc(s_kw + (kk / 4) * BK * ROW_BYTES + off, 16,
                                  1024),
                     smem_desc(sq + (kk / 4) * BQ * ROW_BYTES + off, 16, 1024),
                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n64(dp, smem_desc(s_vw + (kk / 4) * BK * ROW_BYTES + off, 16,
                                   1024),
                     smem_desc(sdo + (kk / 4) * BQ * ROW_BYTES + off, 16,
                               1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // P^T and dS^T in registers; a masked P is exactly 0.
      const float* lse_v =
          reinterpret_cast<const float*>(smem_raw + (s_lse(st) - raw));
      const float* dlt_v = lse_v + BQ;
      const bool edge =
          kw0 + 63 > q0 || kw0 <= q0 + BQ - 1 - W || q0 + BQ > T;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_v + 8 * j + c0);
        const float2 dl = *reinterpret_cast<const float2*>(dlt_v + 8 * j + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + c0 + (e & 1);
          const int r = r0 + 8 * (e >> 1);
          float p = ex2(fmaf(s[4 * j + e], sl2, -((e & 1) ? l2.y : l2.x)));
          if (edge && !live(q0 + c, kw0 + r, T, W)) p = 0.f;
          s[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
        }
      }
      // A operands: k-step kk takes query columns [16 kk, 16 kk + 16).
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }

      // dS^T (128 keys x 64 queries, bf16) into shared memory, 128-byte
      // swizzle: the 16-byte unit j of row r sits at unit j ^ (r % 8).
      const uint32_t sds = s_ds + (it & 1) * C::DS_BYTES;
      {
        uint8_t* const p = smem_raw + (sds - raw);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 64 * w + r0 + 8 * hh;
            *reinterpret_cast<uint32_t*>(
                p + r * ROW_BYTES + ((j ^ (r & 7)) << 4) + 2 * c0) =
                da[j / 2][2 * (j % 2) + hh];
          }
      }

      // dV += P^T dO and dK += dS^T Q; dO and Q MN-major, k-step kk is 16
      // query rows.
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t row = kk * 16 * ROW_BYTES;
        wgmma_rs<D>(acc_dv, pa[kk],
                    smem_desc(sdo + row, BQ * ROW_BYTES, 1024));
        wgmma_rs<D>(acc_dk, da[kk], smem_desc(sq + row, BQ * ROW_BYTES, 1024));
      }
      wgmma_commit();

      // dS^T visible to the tensor cores (async proxy) and to the other
      // threads that read it, then dQ_tile = dS K. The barrier also tells
      // this warpgroup that the last tile's reduction has read its staging.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (tid == 0) bulk_wait_read();
      if constexpr (C::DQ_COLS)
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
      else
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
      float dq[C::DQ_N / 2];
#pragma unroll
      for (int i = 0; i < C::DQ_N / 2; ++i) dq[i] = 0.f;
      fence_regs(dq);
      wgmma_fence();
      const int key_lo = C::DQ_COLS ? 0 : 64 * w;
      const uint32_t s_kcol = s_k + (C::DQ_COLS ? w * BK * ROW_BYTES : 0);
#pragma unroll
      for (int kk = 0; kk < C::DQ_KEYS / 16; ++kk) {
        const uint32_t row = (key_lo + 16 * kk) * ROW_BYTES;
        wgmma_ss_mn<C::DQ_N>(dq, smem_desc(sds + row, BK * ROW_BYTES, 1024),
                             smem_desc(s_kcol + row, BK * ROW_BYTES, 1024),
                             kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      fence_regs(pa);
      fence_regs(da);
      fence_regs(dq);
      mbar_arrive(bar_empty(st));

      // dq_acc += dQ_tile: the tile into this warpgroup's staging (boxes
      // of 64 rows x 32 f32 columns, 128-byte swizzle), then one thread
      // adds it into dq_acc by TMA reductions (rows past T and columns past
      // D dropped).
      {
        const uint32_t stage = s_dqs + w * C::DQS_BYTES;
        uint8_t* const p = smem_raw + (stage - raw);
#pragma unroll
        for (int j = 0; j < C::DQ_N / 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = r0 + 8 * hh;
            const int off = (8 * (j % 4) + c0) * 4;  // byte in the box row
            *reinterpret_cast<float2*>(
                p + (j / 4) * C::DQ_BOX_BYTES + r * ROW_BYTES
                + (((off >> 4) ^ (r & 7)) << 4) + (off & 15)) =
                make_float2(dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]);
          }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
        if (tid == 0) {
          const int col = C::DQ_COLS ? 64 * w : 0;
#pragma unroll
          for (int x = 0; x < C::DQ_BOXES; ++x)
            tma_reduce_add(stage + x * C::DQ_BOX_BYTES, &tm_dq, col + 32 * x,
                           q0, bh);
          bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait();

    // dK (times scale) and dV, rounded to bf16 once; rows past T are not
    // written. The accumulators are D wide: no column past D is written.
    const long long kv_off = (long long)bkv * T;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = kw0 + r0 + 8 * hh;
      if (key < T) {
        __nv_bfloat16* const pk = dk + (kv_off + key) * D + c0;
        __nv_bfloat16* const pv = dv + (kv_off + key) * D + c0;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(pk + 8 * j) =
              pack_bf16(acc_dk[4 * j + 2 * hh] * scale,
                        acc_dk[4 * j + 2 * hh + 1] * scale);
          *reinterpret_cast<uint32_t*>(pv + 8 * j) =
              pack_bf16(acc_dv[4 * j + 2 * hh], acc_dv[4 * j + 2 * hh + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// D 256: the two warpgroups split the outputs.
// ---------------------------------------------------------------------------

struct SplitTile {
  static constexpr int D = 256;
  static constexpr int BK = 64;                // keys per block
  static constexpr int BQ = 64;                // queries per streamed tile
  static constexpr int NCH = D / CHUNK;
  static constexpr int STAGES = 2;
  static constexpr int KV_BYTES = BK * D * 2;  // K or V
  static constexpr int Q_BYTES = BQ * D * 2;   // one Q or dO tile
  static constexpr int DS_BYTES = BK * BQ * 2; // dS^T, bf16
  static constexpr int P_BYTES = BK * BQ * 4;  // P^T, f32, fragment-major
  static constexpr int VEC = BQ * 4;
  // 1 KB of alignment, K, V, STAGES x (Q, dO), dS^T, P^T, STAGES x (lse2,
  // delta), 1 + 2 * STAGES mbarriers: 218 KB.
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + STAGES * 2 * Q_BYTES
                              + DS_BYTES + P_BYTES + STAGES * 2 * VEC
                              + 8 * (1 + 2 * STAGES);
};

// B5-bwd at D 256: one block per (b, kv head, 64-key tile), the same
// producer and ring as `flash_bwd_wgmma_kernel`. A 64 x 256 f32 accumulator
// is a consumer warpgroup's whole register file share, so warpgroup 0 owns
// dV and warpgroup 1 dK of the block's 64 keys. Warpgroup 0 forms S^T and
// P^T and hands P^T to warpgroup 1 through shared memory in f32 (each
// thread's accumulator fragment at the same place, so the hand-over adds
// no rounding); warpgroup 1 forms dP^T and dS^T and writes dS^T as bf16;
// each then takes 128 of dQ's columns over the 64 keys. Two named barriers
// an iteration order the hand-overs.
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_wgmma_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse2,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv,
                             float* __restrict__ dq_acc, int Hq, int Hkv,
                             int T, int Tp, int W, float sl2, float scale) {
  using C = SplitTile;
  constexpr int D = C::D, BK = C::BK, BQ = C::BQ;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_k = (raw + 1023u) & ~1023u;
  const uint32_t s_v = s_k + C::KV_BYTES;
  const uint32_t s_stage = s_v + C::KV_BYTES;               // [STAGES][Q, dO]
  const uint32_t s_ds = s_stage + STAGES * 2 * C::Q_BYTES;  // dS^T
  const uint32_t s_p = s_ds + C::DS_BYTES;                  // P^T
  const uint32_t s_vec = s_p + C::P_BYTES;  // [STAGES][lse2, delta]
  const uint32_t bars = s_vec + STAGES * 2 * C::VEC;
  const uint32_t bar_kv = bars;
  auto bar_full = [&](int st) { return bars + 8u * (1 + st); };
  auto bar_empty = [&](int st) { return bars + 8u * (1 + STAGES + st); };
  auto s_q = [&](int st) { return s_stage + st * 2 * C::Q_BYTES; };
  auto s_lse = [&](int st) { return s_vec + st * 2 * C::VEC; };

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv, kvh = bkv % Hkv;
  const int G = Hq / Hkv;
  const int k_lo = blockIdx.y * BK;
  const int qt_lo = k_lo / BQ;
  const int qt_hi = min(k_lo + BK - 1 + W - 1, T - 1) / BQ;
  const int n_qt = W > 0 ? qt_hi - qt_lo + 1 : 0;
  const int n_it = G * n_qt;

  if (threadIdx.x == 0) init_ring<STAGES>(bars);
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0)
      produce<C>(&tm_q, &tm_k, &tm_v, &tm_do, lse2, delta, s_k, s_stage,
                 s_vec, bars, bkv, b * Hq + kvh * G, k_lo, qt_lo, n_qt, n_it,
                 Tp);
  } else {
    // ---- consumers: warpgroup 0 owns dV, warpgroup 1 dK ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r0 = (tid / 32) * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
    float* const p_f = reinterpret_cast<float*>(smem_raw + (s_p - raw));

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % STAGES, ph = (it / STAGES) & 1;
      const int bh = b * Hq + kvh * G + it / n_qt;
      const int q0 = (qt_lo + it % n_qt) * BQ;
      const uint32_t sq = s_q(st), sdo = sq + C::Q_BYTES;
      const float* lse_v =
          reinterpret_cast<const float*>(smem_raw + (s_lse(st) - raw));

      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1).
      float x[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = 0.f;
      mbar_wait(bar_full(st), ph);
      fence_regs(x);
      wgmma_fence();
      {
        const uint32_t sa = w == 0 ? s_k : s_v, sb = w == 0 ? sq : sdo;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n64(x, smem_desc(sa + (kk / 4) * BK * ROW_BYTES + off, 16,
                                    1024),
                       smem_desc(sb + (kk / 4) * BQ * ROW_BYTES + off, 16,
                                 1024),
                       kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(x);

      uint32_t a[4][4];
      if (w == 0) {
        // P^T, masked pairs exactly 0; to warpgroup 1 in f32.
        const bool edge =
            k_lo + BK - 1 > q0 || k_lo <= q0 + BQ - 1 - W || q0 + BQ > T;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(lse_v + 8 * j + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + c0 + (e & 1);
            const int r = r0 + 8 * (e >> 1);
            float p = ex2(fmaf(x[4 * j + e], sl2, -((e & 1) ? l2.y : l2.x)));
            if (edge && !live(q0 + c, k_lo + r, T, W)) p = 0.f;
            x[4 * j + e] = p;
            p_f[(4 * j + e) * 128 + tid] = p;
          }
        }
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
      } else {
        // dS^T = P^T (dP^T - delta), to shared memory as bf16 (128-byte
        // swizzle) for both warpgroups' dQ.
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        const float* dlt_v = lse_v + BQ;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 dl =
              *reinterpret_cast<const float2*>(dlt_v + 8 * j + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[4 * j + e] = p_f[(4 * j + e) * 128 + tid]
                           * (x[4 * j + e] - ((e & 1) ? dl.y : dl.x));
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
      if (w == 1) {
        uint8_t* const p = smem_raw + (s_ds - raw);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = r0 + 8 * hh;
            *reinterpret_cast<uint32_t*>(
                p + r * ROW_BYTES + ((j ^ (r & 7)) << 4) + 2 * c0) =
                a[j / 2][2 * (j % 2) + hh];
          }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }

      // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1); dO and Q
      // MN-major.
      fence_regs(acc);
      fence_regs(a);
      wgmma_fence();
      {
        const uint32_t sb = w == 0 ? sdo : sq;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_n256(acc, a[kk], smem_desc(sb + kk * 16 * ROW_BYTES,
                                              BQ * ROW_BYTES, 1024));
      }
      wgmma_commit();
      asm volatile("bar.sync 2, 256;\n" ::: "memory");  // dS^T written
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(a);

      // dQ_tile[:, 128 w .. 128 w + 128) = dS K over the 64 keys.
      float dq[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) dq[i] = 0.f;
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t row = 16 * kk * ROW_BYTES;
        wgmma_ss_n128_mn(dq, smem_desc(s_ds + row, BK * ROW_BYTES, 1024),
                         smem_desc(s_k + 2 * w * BK * ROW_BYTES + row,
                                   BK * ROW_BYTES, 1024),
                         kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
      mbar_arrive(bar_empty(st));

      float* const dqa =
          dq_acc + ((long long)bh * T + q0) * D + 128 * w + c0;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
        if (q0 + r < T) {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            atomicAdd(reinterpret_cast<float2*>(dqa + (long long)r * D + 8 * j),
                      make_float2(dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]));
        }
      }
    }

    // dV (warpgroup 0) or dK times scale (warpgroup 1), rounded to bf16
    // once; rows past T are not written.
    const float mul = w == 0 ? 1.f : scale;
    __nv_bfloat16* const out = (w == 0 ? dv : dk) + (long long)bkv * T * D;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k_lo + r0 + 8 * hh;
      if (key < T) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(out + (long long)key * D + 8 * j + c0) =
              pack_bf16(acc[4 * j + 2 * hh] * mul,
                        acc[4 * j + 2 * hh + 1] * mul);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* lse, const void* dout, void* dq, void* dk,
                   void* dv, void* rowvec, void* dq_acc, int B, int Hq,
                   int Hkv, int T, int W, cudaStream_t stream) {
  typedef __nv_bfloat16 bf;
  using C = std::conditional_t<(D > 128), SplitTile, BwdTile<D>>;
  constexpr int BK = C::BK, BQ = C::BQ, SMEM = C::SMEM;
  const int Tp = (T + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  const long long rows_p = (long long)B * Hq * Tp;
  const long long prep_blocks = (rows_p + 31) / 32;
  const int nk = (T + BK - 1) / BK;
  if (dq_acc == nullptr || nk > 65535 || prep_blocks > 2147483647LL)
    return cudaErrorInvalidValue;
  float* const lse2 = (float*)rowvec;
  float* const delta = lse2 + rows_p;
  const float sl2 = (float)(1.4426950408889634 / sqrt((double)D));
  const float scale = (float)(1.0 / sqrt((double)D));
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  if (!make_map(&tm_q, q, D, T, B * Hq, BQ) ||
      !make_map(&tm_do, dout, D, T, B * Hq, BQ) ||
      !make_map(&tm_k, k, D, T, B * Hkv, BK) ||
      !make_map(&tm_v, v, D, T, B * Hkv, BK) ||
      !make_map_f32(&tm_dq, dq_acc, D, T, B * Hq, BQ))
    return cudaErrorInvalidValue;
  const dim3 grid(B * Hkv, nk);
  cudaError_t e;
  if constexpr (D > 128)
    e = cudaFuncSetAttribute(flash_bwd_wgmma_split_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  else
    e = cudaFuncSetAttribute(flash_bwd_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (e != cudaSuccess) return e;

  flash_bwd_prep_kernel<D><<<(unsigned)prep_blocks, 256, 0, stream>>>(
      (const bf*)o, (const bf*)dout, (const float*)lse, lse2, delta,
      (float*)dq_acc, rows_p, T, Tp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if constexpr (D > 128)
    flash_bwd_wgmma_split_kernel<<<grid, WG_THREADS, SMEM, stream>>>(
        tm_q, tm_k, tm_v, tm_do, lse2, delta, (bf*)dk, (bf*)dv,
        (float*)dq_acc, Hq, Hkv, T, Tp, W, sl2, scale);
  else
    flash_bwd_wgmma_kernel<D><<<grid, WG_THREADS, SMEM, stream>>>(
        tm_q, tm_k, tm_v, tm_do, tm_dq, lse2, delta, (bf*)dk, (bf*)dv, Hq,
        Hkv, T, Tp, W, sl2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n8 = (long long)B * Hq * T * D / 8;
  flash_bwd_dq_cast_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, stream>>>(
      (const float*)dq_acc, (bf*)dq, n8, scale);
  return cudaGetLastError();
}

}  // namespace

// Launches B5-bwd on `stream`: bf16 q, o, dout, dq (B, Hq, T, D); k, v, dk,
// dv (B, Hkv, T, D); f32 lse (B, Hq, T) in natural-log units of the scaled
// scores (as flash_tc.cu and flash_tf32x3.cu write it); f32 scratch `rowvec` (2, B*Hq, Tp),
// Tp = T rounded up to a multiple of 64 (lse * log2(e) and delta), and f32
// scratch `dq_acc` (B, Hq, T, D); all contiguous with 16-byte aligned
// bases, D in {16, 64, 80, 128, 256}; W is the window (T for full causal, 0
// for none). Three kernels: the pre-pass, the wgmma kernel
// (`flash_bwd_wgmma_kernel` at D 16, 64, 80 and 128,
// `flash_bwd_wgmma_split_kernel` at D 256) and the dq cast. Returns the CUDA error code of the launches
// (0 = success). Allocates nothing and does not synchronise.
extern "C" int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* rowvec, void* dq_acc, int B, int Hq, int Hkv, int T, int D, int W,
    void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || (long long)B * Hkv > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return (int)launch<16>(q, k, v, o, lse, dout, dq, dk, dv, rowvec,
                             dq_acc, B, Hq, Hkv, T, W, s);
    case 64:
      return (int)launch<64>(q, k, v, o, lse, dout, dq, dk, dv, rowvec,
                             dq_acc, B, Hq, Hkv, T, W, s);
    case 80:
      return (int)launch<80>(q, k, v, o, lse, dout, dq, dk, dv, rowvec,
                             dq_acc, B, Hq, Hkv, T, W, s);
    case 128:
      return (int)launch<128>(q, k, v, o, lse, dout, dq, dk, dv, rowvec,
                              dq_acc, B, Hq, Hkv, T, W, s);
    case 256:
      return (int)launch<256>(q, k, v, o, lse, dout, dq, dk, dv, rowvec,
                              dq_acc, B, Hq, Hkv, T, W, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
