// Banded (causal sliding-window) flash attention with GQA at f32 accuracy
// on Hopper's tensor cores: each f32 operand split into tf32 hi + lo, for
// sm_90a.
//
// Replaces the TPU kernel `_flash_kernel` (wrapper `flash_attention_pallas`)
// of src/repro/kernels/local_attention/local_attention.py for f32 inputs at
// every head size (bf16 inputs at every head size take the wgmma kernel,
// flash_tc.cu). It computes the same function as the FMA kernel
// (local_attention.cu) and keeps its rules:
//
//   * q head h reads kv head h / (Hq / Hkv); q is scaled by 1/sqrt(D) after
//     the upcast; the mask is (k_pos <= q_pos) & (k_pos > q_pos - W);
//     masked scores are -1e30 and masked probabilities 0; a row whose
//     normaliser stayed 0 divides by 1. Rows and keys past T read as zero
//     and are never written.
//   * one block of 4 warps owns 64 query rows of one (batch * q head); each
//     warp owns 16 rows and runs both products as `mma.sync` m16n8k8 with
//     tf32 operands and f32 accumulators. Every operand x is split when it
//     is loaded into a fragment: hi = x rounded to tf32 (to nearest, ties
//     away: the cvt.rna rule, done with an integer add and mask), lo =
//     (x - hi) rounded the same way, and a product is the three passes
//     lo*hi + hi*lo + hi*hi. The dropped lo*lo term and lo's own
//     rounding are below 2^-21 of |x||y|, so the products keep f32 accuracy
//     (one tf32 pass would keep 2^-11 and miss the f32 check by far).
//   * the key loop visits exactly the key tiles of 32 (16 at D = 256) that
//     meet the block's band [q_lo - W + 1, q_hi]; a warp skips the tiles
//     that are dead for all of its 16 rows, and masks only tiles that
//     cross its diagonal or its window's edge. Key and value tiles are
//     copied by cp.async into one stage; three blocks an SM overlap one's
//     copy with the others' products, which measured faster than a double
//     buffer at two.
//   * no shared-memory round trip for P: the m16n8 accumulator fragment of
//     S holds (row g, keys 2t, 2t+1) and (row g + 8, the same keys). Read
//     as the A fragment of P.V with the tile's k index t standing for key
//     2t and t + 4 for key 2t + 1, it is exactly P; V's B fragment takes
//     rows 2t and 2t + 1 to match. The same pairing of d = 2t, 2t + 1 makes
//     Q's and K's fragments 8-byte loads. Row strides of 8 (Q, K) and 4
//     (V) words modulo 32 keep the fragment loads free of bank conflicts.
//   * the running max and the online softmax stay in registers in f32
//     (exp as exp2 of an exponent formed by one fused multiply-add); each
//     thread keeps its share of a row's normaliser and the four threads of
//     a row join it once at the end.
//
// What bounds it on an H100: 4*D FLOP per live (query, key) pair on the
// tensor cores (TF32 dense peak 494.7 TFLOP/s), far above the bytes of q,
// k, v and o; the split issues 3x that. That peak is wgmma's; the tf32
// mma.sync used here runs at a fraction of it, and the splits (five
// integer / float operations per operand) and the softmax are issued
// beside the products (PERF.md). Split
// planes of K and V in shared memory, made once per block for 8 warps,
// were tried and were no faster: the products, not the splits, set the
// pace.
//
// Under autograd the launch also writes each row's log-sum-exp of the
// scaled scores (a nullable pointer; the serving launch passes none), which
// the backward (flash_tf32x3_bwd.cu) reads. The split, the mma and the row
// staging are shared with it (flash_tf32x3.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "flash_tf32x3.cuh"

using namespace tf32x3;

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int BK = D > 128 ? 16 : 32;  // keys per tile
  static constexpr int NT = BK / 8;             // key n-tiles of S
  static constexpr int KD = D / 8;              // QK^T k-steps, PV n-tiles
  // Row strides in floats: 8 (mod 32) for Q and K, read as 8-byte pairs
  // (row g, d 2t): 4 (mod 32) for V, read as words (row 2t, d g).
  static constexpr int QS = D + ((8 - D) % 32 + 32) % 32;
  static constexpr int VS = D + ((4 - D) % 32 + 32) % 32;
  static constexpr int SMEM_FLOATS = BQ * QS + BK * QS + BK * VS;
  // Three blocks an SM at D <= 128 (69 KB of shared memory, <= 170
  // registers): one block's tile copy overlaps the others' products.
  static constexpr int MIN_BLOCKS = D > 128 ? 1 : 3;
};

// d += a * b, a split, b's two f32 values (b0, b1) split here: three
// tensor-core passes, the small terms first.
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], float b0,
                                          float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(d, al, bh0, bh1);
  mma(d, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Key and value rows [lo, lo + BK) into shared memory by cp.async
// (completes at cp_wait); rows past T are zero.
template <int D>
__device__ __forceinline__ void stage_kv(const float* __restrict__ k,
                                         const float* __restrict__ v, int lo,
                                         int Tlen, float* Kd, float* Vd) {
  using C = Cfg<D>;
  constexpr int CH = D / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < C::BK * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool ok = lo + r < Tlen;
    const long long off = (long long)(ok ? lo + r : 0) * D + c * 4;
    cp_async16(Kd + r * C::QS + c * 4, k + off, ok);
    cp_async16(Vd + r * C::VS + c * 4, v + off, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, Cfg<D>::MIN_BLOCKS)
flash_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int Hq, int Hkv, int Tlen,
                    int W, float scale) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, NT = C::NT, KD = C::KD;
  constexpr int QS = C::QS, VS = C::VS;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // [BQ][QS]
  float* Ks = Qs + BQ * QS;      // [BK][QS]
  float* Vs = Ks + BK * QS;      // [BK][VS]

  const int nq = (Tlen + BQ - 1) / BQ;
  const int q_lo = (nq - 1 - (int)blockIdx.x) * BQ;  // long rows first
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const long long q_off = (long long)bh * Tlen * D;
  const long long kv_off =
      ((long long)b * Hkv + h / (Hq / Hkv)) * (long long)Tlen * D;
  const float* kp = k + kv_off;
  const float* vp = v + kv_off;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = q_lo + warp * 16;  // the warp's first query row
  const int ra = r0 + g, rb = ra + 8;

  const int q_hi = min(q_lo + BQ, Tlen) - 1;
  const int kt_lo = max(q_lo - W + 1, 0) / BK;
  const int kt_hi = q_hi / BK;

  stage_rows<D, BQ, QS>(q + q_off, q_lo, Tlen, scale, Qs);
  if (kt_lo <= kt_hi) stage_kv<D>(kp, vp, kt_lo * BK, Tlen, Ks, Vs);
  cp_commit();

  float acc[KD][4];
#pragma unroll
  for (int c = 0; c < KD; ++c)
    acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  const float* Qa = Qs + (warp * 16 + g) * QS + 2 * tq;
  const float* Qb = Qa + 8 * QS;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    if (kt > kt_lo) {
      stage_kv<D>(kp, vp, kt * BK, Tlen, Ks, Vs);
      cp_commit();
    }
    cp_wait();
    __syncthreads();  // tile kt (and q) visible to every warp

    const int k_lo = kt * BK;
    const bool dead = r0 >= Tlen || k_lo > r0 + 15 || k_lo + BK - 1 <= r0 - W;
    if (!dead) {
      // ---- S = (q / sqrt(D)) K^T, three passes per k-step ----
      const float* Kb = Ks + g * QS + 2 * tq;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const float2 xa = *reinterpret_cast<const float2*>(Qa + 8 * kk);
        const float2 xb = *reinterpret_cast<const float2*>(Qb + 8 * kk);
        uint32_t ah[4], al[4];
        split(xa.x, ah[0], al[0]);  // (row g,     k t)     = d 8kk + 2t
        split(xb.x, ah[1], al[1]);  // (row g + 8, k t)
        split(xa.y, ah[2], al[2]);  // (row g,     k t + 4) = d 8kk + 2t + 1
        split(xb.y, ah[3], al[3]);  // (row g + 8, k t + 4)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // (k t, key 8j + g) and (k t + 4, key 8j + g)
          const float2 y =
              *reinterpret_cast<const float2*>(Kb + 8 * j * QS + 8 * kk);
          mma_split(s[j], ah, al, y.x, y.y);
        }
      }

      // ---- mask (edge tiles only) and online softmax ----
      const bool full = k_lo + BK - 1 <= r0 && k_lo > r0 + 15 - W;
      unsigned live = 0xffffffffu;  // bit 4j + e: element s[j][e]
      if (!full) {
        live = 0;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k_lo + 8 * j + 2 * tq + (e & 1);
            const int row = e < 2 ? ra : rb;
            if (key <= row && key > row - W) live |= 1u << (4 * j + e);
            else s[j][e] = NEG_INF;
          }
      }
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      // exp(x) as exp2(x log2 e), the exponent in one fused multiply-add.
      const float al_a = exp2f((m_a - mn_a) * LOG2E),
                  al_b = exp2f((m_b - mn_b) * LOG2E);
      const float ml_a = mn_a * LOG2E, ml_b = mn_b * LOG2E;
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ml = e < 2 ? ml_a : ml_b;
          const float p = (live >> (4 * j + e)) & 1u
                              ? exp2f(fmaf(s[j][e], LOG2E, -ml))
                              : 0.f;
          s[j][e] = p;
          if (e < 2) sum_a += p; else sum_b += p;
        }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int c = 0; c < KD; ++c) {
        acc[c][0] *= al_a; acc[c][1] *= al_a;
        acc[c][2] *= al_b; acc[c][3] *= al_b;
      }

      // ---- acc += P V: S's fragment is P's A fragment (key 2t <-> k t) ----
      const float* Vb = Vs + 2 * tq * VS + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t ph[4], pl[4];
        split(s[j][0], ph[0], pl[0]);  // (row g,     k t)     = key 8j + 2t
        split(s[j][2], ph[1], pl[1]);  // (row g + 8, k t)
        split(s[j][1], ph[2], pl[2]);  // (row g,     k t + 4) = key 8j + 2t + 1
        split(s[j][3], ph[3], pl[3]);  // (row g + 8, k t + 4)
        const float* vr = Vb + 8 * j * VS;
#pragma unroll
        for (int c = 0; c < KD; ++c)  // (k t, d 8c + g), (k t + 4, d 8c + g)
          mma_split(acc[c], ph, pl, vr[8 * c], vr[VS + 8 * c]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // ---- normalise and write rows < T ----
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float den_a = l_a == 0.f ? 1.f : l_a;
  const float den_b = l_b == 0.f ? 1.f : l_b;
  // Under autograd: each row's log-sum-exp of the scaled scores, m + log l
  // (natural log), +inf where no key is live (l = 0).
  if (lse && tq == 0) {
    if (ra < Tlen)
      lse[(long long)bh * Tlen + ra] = l_a == 0.f ? INFINITY
                                                  : m_a + logf(l_a);
    if (rb < Tlen)
      lse[(long long)bh * Tlen + rb] = l_b == 0.f ? INFINITY
                                                  : m_b + logf(l_b);
  }
  float* out = o + q_off + 2 * tq;
#pragma unroll
  for (int c = 0; c < KD; ++c) {
    if (ra < Tlen)
      store2(out + (long long)ra * D + 8 * c, acc[c][0] / den_a,
             acc[c][1] / den_a);
    if (rb < Tlen)
      store2(out + (long long)rb * D + 8 * c, acc[c][2] / den_b,
             acc[c][3] / den_b);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Hq, int Hkv, int Tlen, int W,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  const int smem = C::SMEM_FLOATS * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_tf32x3_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tlen + BQ - 1) / BQ, B * Hq);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_tf32x3_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, Hq,
      Hkv, Tlen, W, scale);
  return cudaGetLastError();
}

}  // namespace

// Launches the split-TF32 banded flash attention on `stream`: f32 q (B, Hq,
// T, D), k and v (B, Hkv, T, D), o like q, all contiguous on 16-byte
// boundaries, D in 16, 64, 80, 128, 256. W is the window (T for full
// causal). lse: null (serving), or (B, Hq, T) f32 that receives each row's
// log-sum-exp (training: the backward, flash_tf32x3_bwd.cu, reads it).
// Returns the CUDA error code of the launch (0 = success). Allocates
// nothing and does not synchronise.
extern "C" int flash_attention_tf32x3_launch(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse, int B, int Hq,
                                             int Hkv, int T, int D, int W,
                                             void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  switch (D) {
    case 16: return (int)launch<16>(q, k, v, o, l, B, Hq, Hkv, T, W, s);
    case 64: return (int)launch<64>(q, k, v, o, l, B, Hq, Hkv, T, W, s);
    case 80: return (int)launch<80>(q, k, v, o, l, B, Hq, Hkv, T, W, s);
    case 128: return (int)launch<128>(q, k, v, o, l, B, Hq, Hkv, T, W, s);
    case 256: return (int)launch<256>(q, k, v, o, l, B, Hq, Hkv, T, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
