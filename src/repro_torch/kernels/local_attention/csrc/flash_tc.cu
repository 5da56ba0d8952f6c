// Banded (causal sliding-window) flash attention with GQA on Hopper's tensor
// cores, for sm_90a: bf16 q, k, v at D in {64, 128, 256}.
//
// Replaces, for these inputs, the TPU kernel `_flash_kernel` (wrapper
// `flash_attention_pallas`) of src/repro/kernels/local_attention/
// local_attention.py. The FMA kernel of csrc/local_attention.cu keeps the
// f32 inputs and the other head sizes. Same function: the mask is
// (k_pos <= q_pos) & (k_pos > q_pos - W), masked probabilities are 0, a row
// whose normaliser stayed 0 divides by 1, q head h reads kv head
// h / (Hq / Hkv), W = T is full causal.
//
// What bounds it on an H100: 4*D FLOP per live (query, key) pair, far above
// the bytes of q, k, v and o, so the tensor cores (989 TFLOP/s bf16). The
// design:
//
//   * one block per (batch * q head, 128-row query tile), query tiles
//     issued last-first across all heads (blockIdx.y is the tile counted
//     from the end, blockIdx.x the head), so the long rows of a causal pass
//     start first. The block visits exactly the key tiles that meet
//     [q_lo - W + 1, q_hi], from the diagonal down.
//   * three warpgroups. The producer (warpgroup 0, 24 registers after
//     setmaxnreg) has one thread issue TMA loads: q once, then K and V
//     tiles into a 2-stage ring, each on its own mbarrier (V may land
//     while the scores are computed); the consumers free a stage through
//     an "empty" mbarrier. Two consumer warpgroups (240 registers) own 64
//     query rows each.
//   * shared memory holds bf16 tiles in 64-column (128-byte) chunks with
//     the 128-byte swizzle that TMA writes and wgmma reads: Q 128 x D, and
//     per stage K and V BK x D (BK = 128, or 64 at D = 256): 160 KB at
//     D = 128. A 3-D tensor map (D, T, B*H) per input makes TMA zero-fill
//     rows past T within a head instead of reading the next head's rows;
//     o is written with plain stores of rows < T only.
//   * S = Q K^T: wgmma m64nBKk16, both operands K-major from shared memory,
//     f32 accumulation. 1/sqrt(D) and log2(e) are applied in f32 to the
//     accumulator inside the exponent (exp2); the plain version scales q
//     after the upcast: a few f32 ulps apart.
//   * online softmax in registers on the accumulator fragment: a row lives
//     in the 4 threads of a quad, joined by two xor shuffles. Only tiles
//     that cross the diagonal or the window's lower edge are masked
//     (masked scores -inf, a fully masked row so far keeps its running
//     max at -inf and is shifted by 0 so that every p is 0).
//   * P V, exact split: each f32 p becomes p_hi = bf16(p) and p_lo =
//     bf16(p - p_hi) in registers (the accumulator layout is the A-operand
//     layout of the next product), and O += p_hi V + p_lo V by two wgmma
//     m64nDk16 with A from registers and V MN-major (transposed B) from
//     shared memory. p_hi + p_lo is p within 2^-18 p, and bf16 x bf16
//     products are exact in f32, so the result stays within one bf16 ulp
//     of the f32 plain version. One bf16 P would err by up to 2^-9 of
//     sum(p|v|)/l: many ulps at the output's magnitude. The split costs
//     6*D FLOP per live pair instead of 4*D; the bound counts 4*D.
//   * the normaliser l is summed from the f32 p; O / l in f32, rounded to
//     bf16 and written once.
//   * optionally (a second instantiation, launched when the caller passes a
//     non-null `lse`, i.e. under autograd) the per-row log-sum-exp of the
//     scaled scores in natural-log units, lse = (m + log2 l) ln 2 with m
//     the running max in log2 units, so that P = exp(s * scale - lse) for
//     the backward (csrc/flash_tc_bwd.cu); a row with l = 0 (only at
//     W = 0) gets +inf, for which every P of the backward is exactly 0.
//     Without it the kernel is the prefill's, unchanged.
//
// Later work (ROADMAP): overlap of one warpgroup's softmax with its own
// next QK^T (two score buffers), a persistent grid, and a single-bf16-P
// variant under a looser tolerance.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "flash_hopper.cuh"

namespace {

constexpr int THREADS = 384;        // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;

template <int D>
struct TcTile {
  static constexpr int BQ = 128;                // query rows per block
  static constexpr int BK = D > 128 ? 64 : 128;  // keys per tile
  static constexpr int NCH = D / CHUNK;         // chunks per row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;   // one K or V stage
  static constexpr int STAGES = 2;
  // 1 KB to align the tiles to the swizzle's 1024-byte period, then Q,
  // K[STAGES], V[STAGES] and 7 mbarriers.
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 64;
};

// The exact split of two f32 probabilities into bf16 (hi, lo) pairs.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int Hq, int Hkv, int Tlen, int W, float sl2) {
  using C = TcTile<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NCH = C::NCH;
  constexpr int Q_BYTES = C::Q_BYTES, KV_BYTES = C::KV_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023u) & ~1023u;
  const uint32_t s_k = s_q + Q_BYTES;                 // [STAGES][KV_BYTES]
  const uint32_t s_v = s_k + C::STAGES * KV_BYTES;
  const uint32_t bars = s_v + C::STAGES * KV_BYTES;
  const uint32_t bar_q = bars;
  auto bar_k = [&](int st) { return bars + 8u * (1 + st); };
  auto bar_v = [&](int st) { return bars + 8u * (3 + st); };
  auto bar_free = [&](int st) { return bars + 8u * (5 + st); };

  const int nq = (Tlen + BQ - 1) / BQ;
  const int q_lo = (nq - 1 - (int)blockIdx.y) * BQ;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int q_hi = min(q_lo + BQ, Tlen) - 1;
  const int kt_lo = max(q_lo - W + 1, 0) / BK;
  const int kt_hi = q_hi / BK;
  const int n_tiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(bar_k(st), 1);
      mbar_init(bar_v(st), 1);
      mbar_init(bar_free(st), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        tma_load(s_q + c * BQ * ROW_BYTES, &tm_q, c * CHUNK, q_lo, bh, bar_q);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1, use = it >> 1;
        if (use > 0) mbar_wait(bar_free(st), (use - 1) & 1);
        const int k_lo = (kt_hi - it) * BK;
        mbar_expect_tx(bar_k(st), KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(s_k + st * KV_BYTES + c * BK * ROW_BYTES, &tm_k,
                   c * CHUNK, k_lo, bkv, bar_k(st));
        mbar_expect_tx(bar_v(st), KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(s_v + st * KV_BYTES + c * BK * ROW_BYTES, &tm_v,
                   c * CHUNK, k_lo, bkv, bar_v(st));
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows [64 cw, 64 cw + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row_a = q_lo + cw * 64 + warp * 16 + lane / 4;  // and row_a + 8
    const int row_b = row_a + 8;
    const int col0 = 2 * (lane % 4);
    const uint32_t s_qw = s_q + cw * 64 * ROW_BYTES;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY;  // running max, scaled by sl2
    float l_a = 0.f, l_b = 0.f;              // this thread's share of l

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it & 1, ph = (it >> 1) & 1;
      const int k_lo = (kt_hi - it) * BK;
      const uint32_t s_kt = s_k + st * KV_BYTES, s_vt = s_v + st * KV_BYTES;

      // S = Q K^T (unscaled), 64 x BK per warpgroup.
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      mbar_wait(bar_k(st), ph);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes
        wgmma_ss<BK>(s,
                     smem_desc(s_qw + (kk / 4) * BQ * ROW_BYTES + off, 16,
                               1024),
                     smem_desc(s_kt + (kk / 4) * BK * ROW_BYTES + off, 16,
                               1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // Mask the tiles that cross the diagonal or the window's lower edge.
      if (k_lo + BK - 1 > q_lo || k_lo <= q_hi - W) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k_lo + 8 * j + col0 + e;
            if (!(kp <= row_a && kp > row_a - W)) s[4 * j + e] = -INFINITY;
            if (!(kp <= row_b && kp > row_b - W)) s[4 * j + 2 + e] = -INFINITY;
          }
      }

      // Online softmax on rows a and b.
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a) * sl2);
      const float mn_b = fmaxf(m_b, quad_max(mx_b) * sl2);
      // A row with no live key yet shifts by 0: every p and alpha is 0.
      const float sh_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float sh_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float alpha_a = ex2(m_a - sh_a), alpha_b = ex2(m_b - sh_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], sl2, -sh_a));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl2, -sh_a));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl2, -sh_b));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl2, -sh_b));
        sum_a += s[4 * j] + s[4 * j + 1];
        sum_b += s[4 * j + 2] + s[4 * j + 3];
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha_a;
        acc[4 * j + 1] *= alpha_a;
        acc[4 * j + 2] *= alpha_b;
        acc[4 * j + 3] *= alpha_b;
      }

      // P as the A operand of the next product, split into bf16 hi + lo:
      // k-step kk takes score columns [16 kk, 16 kk + 16).
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], p_hi[kk][r],
                 p_lo[kk][r]);

      // O += P_hi V + P_lo V; V's k-step kk is 16 key rows of 128 bytes.
      mbar_wait(bar_v(st), ph);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv =
            smem_desc(s_vt + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024);
        wgmma_rs<D>(acc, p_hi[kk], dv);
        wgmma_rs<D>(acc, p_lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      mbar_arrive(bar_free(st));
    }

    // O / l, rounded to bf16; rows past T are not written.
    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    const float den_a = l_a == 0.f ? 1.f : l_a;
    const float den_b = l_b == 0.f ? 1.f : l_b;
    __nv_bfloat16* out = o + (long long)bh * Tlen * D + col0;
    if (row_a < Tlen) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + (long long)row_a * D + 8 * j) =
            pack_bf16(acc[4 * j] / den_a, acc[4 * j + 1] / den_a);
    }
    if (row_b < Tlen) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + (long long)row_b * D + 8 * j) =
            pack_bf16(acc[4 * j + 2] / den_b, acc[4 * j + 3] / den_b);
    }
    if constexpr (LSE) {
      if (lane % 4 == 0) {
        constexpr float LN2 = 0.6931471805599453f;
        float* out_lse = lse + (long long)bh * Tlen;
        if (row_a < Tlen)
          out_lse[row_a] = l_a == 0.f ? INFINITY : (m_a + log2f(l_a)) * LN2;
        if (row_b < Tlen)
          out_lse[row_b] = l_b == 0.f ? INFINITY : (m_b + log2f(l_b)) * LN2;
      }
    }
  }
}


template <int D, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Hq, int Hkv, int T, int W,
                   cudaStream_t stream) {
  using C = TcTile<D>;
  const int nq = (T + C::BQ - 1) / C::BQ;
  if (nq > 65535) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, D, T, B * Hq, C::BQ) ||
      !make_map(&tm_k, k, D, T, B * Hkv, C::BK) ||
      !make_map(&tm_v, v, D, T, B * Hkv, C::BK))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<D, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (e != cudaSuccess) return e;
  const float sl2 = (float)(1.4426950408889634 / sqrt((double)D));
  const dim3 grid(B * Hq, nq);
  flash_tc_kernel<D, LSE><<<grid, THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, (__nv_bfloat16*)o, lse, Hq, Hkv, T, W, sl2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int Hq, int Hkv, int T, int W,
                     cudaStream_t s) {
  return lse == nullptr ? launch<D, false>(q, k, v, o, lse, B, Hq, Hkv, T, W, s)
                        : launch<D, true>(q, k, v, o, lse, B, Hq, Hkv, T, W, s);
}

}  // namespace

// Launches the tensor-core banded flash attention on `stream`: bf16 q
// (B, Hq, T, D), k and v (B, Hkv, T, D), o like q, all contiguous with
// 16-byte aligned bases, D in {64, 128, 256}; W is the window (T for full
// causal). `lse`, if not null, is f32 (B, Hq, T) and receives each row's
// log-sum-exp of the scaled scores (natural log). Returns the CUDA error
// code of the launch (0 = success). Allocates nothing and does not
// synchronise.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int B, int Hq, int Hkv, int T, int D,
                                         int W, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  switch (D) {
    case 64: return (int)launch_d<64>(q, k, v, o, l, B, Hq, Hkv, T, W, s);
    case 128: return (int)launch_d<128>(q, k, v, o, l, B, Hq, Hkv, T, W, s);
    case 256: return (int)launch_d<256>(q, k, v, o, l, B, Hq, Hkv, T, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
