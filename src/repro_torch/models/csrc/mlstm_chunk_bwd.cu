// Backward of the chunkwise mLSTM (B7-bwd) as three passes that mirror
// the forward's (mlstm_chunk.cu), for sm_90a, with the products of passes
// 1 and 3 on the tensor cores at f32 accuracy.
//
// Replaces no kernel of the JAX package: the reference differentiates the
// chunk `lax.scan` of `mlstm_chunkwise` (src/repro/models/xlstm.py:117,
// scan at :168) with `jax.grad`. It is the backward of B7, behind
// `MLSTMChunkScan` in xlstm.py, whose note derives it: every max output
// (M_r, M_c) is held constant — no output depends on the value a
// stabiliser picks — and the gauge part g of a final-state gradient goes
// back through the chunks' M_c. Per (b, head, chunk) of L steps, with the
// forward's notation (b, w, M_r, sigma_r = exp(m - M_r), P, dot_r, den_r,
// alpha = exp(m - M_c), a_s = exp(w_s - M_c)):
//
//   dh~_r = dh_r / den_r, d den_r = -<dh~_r, h_r>: to dot_r (times
//   sign(dot_r)) where |dot_r| won den_r, else to b_r as <dh_r, h_r>;
//   dC_in = alpha dC_out + sum_r sigma_r q_r dh~_r^T (n likewise with
//   ddot_r q_r); dm_in = alpha X_c + sum_r sigma_r dsigma_r [+ g_c where m
//   wins M_c], X_c = <dC_out, C_in> + <dn_out, n_in>;
//   dP = dh~ v^T + ddot_r, dS = dP .* exp(w_s - M_r) (s <= r);
//   dv = P^T dh~ + a_s dC_out^T k_s;  dk = dS^T q + a_s (dC_out v_s + dn_out);
//   dq = dS k + sigma_r (C_in dh~_r + ddot_r n_in);
//   dw_s = sum_r dP P + a_s <k_s, dC_out v_s + dn_out> [+ g_c at argmax G
//   where G wins]; di = dw; df = reverse cumsum over the chunk of -dw
//   (plus the floor branch's <dh_r, h_r>, plus the next chunk's dm_in on
//   the last row, through b_last).
//
//   1. outputs side (`mlstm_bwd_outputs_kernel`), one block per (b, head,
//      chunk): from dh, h, the forward's dot_r and the recomputed gate
//      scan, the chunk's own gradient of its incoming state — dC_own =
//      (sigma / den . q)^T dh (M = D rows, N = D, K = L) and dn_own into
//      `dwork` (laid out like the forward's scratch, zero past column D),
//      and dm_own = sum_r sigma_r dsigma_r into `dscal`, as <C_in, dC_own>
//      + <n_in, dn_own> (the same sum without a product q C_in);
//   2. reverse inter-chunk scan (`mlstm_bwd_scan_kernel`), one thread per
//      four elements of (C, n) of a (b, head), serial over chunks from the
//      last: dC_in(c) = alpha_c dC_out(c) + dC_own(c), leaving dC_out(c) in
//      dwork and the gauge gradient g_c in dscal; the cross-chunk scalar
//      X_c is off the chain: each warp adds its partial with one float
//      atomic (an order that varies from call to call);
//   3. inputs side (`mlstm_bwd_inputs_kernel`), one block per (b, head,
//      chunk), in four products and the gate scan:
//        S = q k^T and dP = dh v^T (64 x 64, K = D, together); P / den_r,
//        dS and the column sums of dP P to shared memory;
//        dk: v dC_out^T (K = D) + dn_out, da_s = <that, k_s>, times a_s,
//        then + dS^T q (K = L);
//        dv: k dC_out (K = D), times a_s, then + (P / den)^T dh (K = L);
//        dq: dh C_in^T (K = D), sigma_r (that / den_r + ddot_r n_in), then
//        + dS k (K = L);
//      then the gate gradients by a warp scan. The block of chunk 0 writes
//      the initial m's gradient.
//
// Products: three bf16 pieces on `mma.sync` m16n8k16, f32 accumulators.
// Every f32 operand x is cut into pieces as it is loaded from shared
// memory into a fragment: x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x -
// x1 - x2), the remainders exact, x1 + x2 + x3 == x; a product is the six
// piece products a_i b_j with i + j <= 2, each exact in f32, added to one
// accumulator, the small terms first. The dropped terms are below 2^-23
// |x||y|, so each product keeps f32 accuracy (the f32 attention backward's
// recipe, csrc/flash_tf32x3_bwd.cu). A bf16 m16n8k16 issues at the rate of a
// tf32 m16n8k8, so the six products of 16 rows of K cost what the split-TF32
// recipe's three passes (lo*hi + hi*lo + hi*hi) of 8 rows cost. That
// recipe was tried first, in its plain emulation: a tf32 hi + lo keeps 22
// bits of x, and at the extreme gates at D 192 its gradients strayed
// further from the f64 result than the CPU test allows
// (tests/test_torch_mlstm_bwd_split.py). wgmma was not taken: it reads
// operands from shared memory in fixed layouts (tf32 K-major only, bf16
// pieces at 6 bytes an element), and four of this backward's products are
// read transposed (P^T dh, dS^T q, v dC_out^T, dh C_in^T), which
// mma.sync's register fragments take from f32 tiles by indexing alone.
// Pass 3's products are 64-row tiles over the full DP = D rounded up to 64
// columns: 8 warps as 2 row halves x 4 column quarters, each holding 32 x
// DP / 4 in 2 x 2 NJ m16n8 accumulators (48 registers at D 192), so that
// a B fragment's pieces serve two row tiles; S and dP, 64 x 64, hold 32 x
// 16 each. Pass 1's dC_own (D x D, K = L) is 64 rows of d at a time, 8
// warps as 4 row quarters x 2 column halves.
//
// Shared memory. Pass 3 keeps nothing of q, k, v, dh or the states
// resident: every product streams both operands in slices of 16 rows of K
// through a three-stage cp.async ring (`ring`): a k-contiguous slice (64
// rows x 16, row stride 20) for q, k, v, dh read along their head
// dimension and for a state read transposed (DP rows x 16), an
// n-contiguous slice (16 x DP, row stride DP + 8) for a state or a chunk
// input read along its rows. With those strides a warp's fragment loads
// meet 32 banks. The state part (K = D) and the intra-chunk part (K = L)
// of dk, dv, dq run as one ring, the scaling between them applied when
// the first intra slice is due. P / den and dS stay in shared memory (64
// x 68 each, read direct and transposed: the transposed reads meet 2-way
// conflicts). At D 192 that is 61,440 + 34,816 + 4,360 bytes: two blocks
// an SM, 128 registers (a few spilled). S and dP's first slice is in
// flight while the block scans its gates and forms its rows' <dh, h>
// (four threads a row). The chunk's q and dh in pass 1 are resident (64 x
// (DP + 8) each, 104,704 bytes at D 192: two blocks an SM). At D 256 one
// block an SM. Slices past D (K = D) or past L (K = L) are not run; rows
// past L and columns past D are zero-filled by the copies. Without 16-byte
// alignment (D % 4 != 0, or strides or pointers off 16 bytes) the copies
// go one float at a time, synchronously, into the same layout, and the
// outputs are stored one float at a time (else a lane's column pair at
// once).
//
// What the card showed (H100, xlstm-125m's training shape; PERF.md §7,
// tools/bwd_parts.py): pass 3 moves about 1 MB a block from L2 into
// shared memory (q, k, v, dh for S and dP, again as the state products' A
// and the intra-chunk products' B, and the 147 KB states, dC_out twice),
// and that traffic sets its pace: without the products it keeps four
// fifths of its time. Tried and slower on the card: 32-row slices in two
// stages, a deeper ring at one block an SM, 4 row x 2 column warps.
//
// The stabilisers, the gauge term, the order of the gate-gradient scan
// and pass 2 are the first design's (which staged every operand
// through shared memory for the FMA units, 32 rows of K at a time, with
// no overlap of loads and products). da_s and the column sums of dP P are
// summed in a fixed order (per warp by shuffles, then over the warps), so
// pass 3 is deterministic; pass 2's X_c is not.
//
// What bounds it on an H100: bytes. Per chunk and (b, head) the products
// are pass 1's 2 L D^2 and pass 3's 6 L D^2 + 5 L (L + 1) D (S, dP and
// the three intra-chunk products over the causal triangle): at the TF32
// peak (494.7 TFLOP/s) they take a fifth of the time the bytes take at
// 3.35 TB/s (the chunks' rows, each read once, and the scratch: 3 x (D +
// 1) x DP x 4 bytes a chunk). The pieces issue 6 bf16 products for each,
// on mma.sync, which runs at a fraction of the tensor cores' peak, and
// the cuts into pieces are issued beside them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "mlstm_tiles.cuh"

namespace {

using namespace mt;

constexpr int KS = 16;         // rows of K per ring slice
constexpr int STAGES = 3;      // ring depth
constexpr int AKS = KS + 4;    // row stride of a k-contiguous slice
constexpr int PS = LMAX + 4;   // row stride of P / den and dS

template <int NJ>
struct Cfg {
  static constexpr int DP = 64 * NJ;
  static constexpr int RS = DP + 8;   // row stride of an n-contiguous tile
  static constexpr int NT = 4 * NJ;   // pass 1's m16n8 tiles a warp: DP / 2
  static constexpr int NT3 = 2 * NJ;  // pass 3's per row tile: DP / 4
  static constexpr int BK = DP * AKS, BN = KS * RS;
  static constexpr int AB = LMAX * AKS + (BK > BN ? BK : BN);
  // Floats of one ring stage: S and dP's four k-contiguous slices, or one
  // k-contiguous A slice and the larger B slice.
  static constexpr int STAGE = 4 * LMAX * AKS > AB ? 4 * LMAX * AKS : AB;
  static constexpr int MINB = NJ <= 3 ? 2 : 1;   // blocks an SM
};

__device__ __forceinline__ float sgn(float x) {
  return (float)((x > 0.0f) - (x < 0.0f));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Two floats as a bf16x2 word, lo in the low half, each rounded to
// nearest even.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// The three bf16 pieces of a pair (x, y), as bf16x2 words: p[0] = bf16(x,
// y), p[1] = bf16 of what p[0] left, p[2] = bf16 of what p[1] left. The
// remainders are exact in f32, and p[0] + p[1] + p[2] == (x, y) down to
// |x| of about 2^-103.
__device__ __forceinline__ void pieces(float x, float y, uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = bf16x2(x, y);
    x -= __uint_as_float(p[i] << 16);
    y -= __uint_as_float(p[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i][j] += A(rows m0 + 16 i .. + 15, k0 .. k0 + 15) B(k0 .. k0 + 15,
// columns n0 + 8 j .. + 7) for i < MT, j < NT: fa(k, m) and fb(k, n) read
// the operands' f32 elements; each is cut into its three bf16 pieces, and
// the six piece products a_i b_j with i + j <= 2 go to the accumulator,
// the small terms first; a B fragment's pieces serve MT row tiles. Lane
// (g, t) = (lane / 4, lane % 4) holds A rows g and g + 8 and B column g at
// the fragment's k positions 2t, 2t + 1, 2t + 8, 2t + 9, which stand for
// k = t, t + 4, t + 8, t + 12 in both operands (a sum over k is a sum in
// any order), so that the loads of a fragment meet 32 banks in the tiles'
// layouts (row strides of 20 or 68 floats where k runs along a row, 8 mod
// 32 where it runs down a column). The accumulator: (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
template <int MT, int NT, class FA, class FB>
__device__ __forceinline__ void mma_k16(float (&acc)[MT][NT][4], FA fa,
                                        FB fb, int k0, int m0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t a[MT][3][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int r = 0; r < 4; ++r) {   // (row, k pair): (g, t), (g + 8, t),
      // (g, t + 8), (g + 8, t + 8)
      const int m = m0 + 16 * mi + g + 8 * (r & 1);
      const int k = k0 + t + 8 * (r >> 1);
      uint32_t p[3];
      pieces(fa(k, m), fa(k + 4, m), p);
#pragma unroll
      for (int i = 0; i < 3; ++i) a[mi][i][r] = p[i];
    }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + 8 * j + g;
    uint32_t b0[3], b1[3];
    pieces(fb(k0 + t, n), fb(k0 + t + 4, n), b0);
    pieces(fb(k0 + t + 8, n), fb(k0 + t + 12, n), b1);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      mma(acc[mi][j], a[mi][2], b0[0], b1[0]);
      mma(acc[mi][j], a[mi][0], b0[2], b1[2]);
      mma(acc[mi][j], a[mi][1], b0[1], b1[1]);
      mma(acc[mi][j], a[mi][1], b0[0], b1[0]);
      mma(acc[mi][j], a[mi][0], b0[1], b1[1]);
      mma(acc[mi][j], a[mi][0], b0[0], b1[0]);
    }
  }
}

// Four floats at src to shared dst, n of them real (the rest zero): one
// cp.async (completing at the ring's wait) under `vec`, where n is 0 or 4,
// else plain loads and stores.
__device__ __forceinline__ void copy4(float* dst, const float* src, int n,
                                      bool vec) {
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst)),
                 "l"(src), "r"(n > 0 ? 16 : 0)
                 : "memory");
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[u] = u < n ? src[u] : 0.0f;
  }
}

// Rows [r0, r0 + ROWS) by columns [c0, c0 + W) of a row-major source (row
// r at src + r ld) into dst with row stride S: rows from nrows on and
// columns from ncols on read as zero.
template <int ROWS, int W>
__device__ __forceinline__ void load_tile(float* dst, int S,
                                          const float* src, int64_t ld,
                                          int r0, int nrows, int c0,
                                          int ncols, bool vec) {
  constexpr int CH = W / 4;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH, c = 4 * (idx % CH);
    const int n = r0 + r < nrows ? min(4, max(0, ncols - c0 - c)) : 0;
    copy4(dst + r * S + c, n > 0 ? src + (r0 + r) * ld + c0 + c : src, n,
          vec);
  }
}

// The first STAGES - 1 slices of a ring, put in their stages by load(i,
// stage) and committed: a ring's start, which a kernel may issue early.
template <int STAGE, class Load>
__device__ __forceinline__ void ring_start(int n, float* buf, Load load) {
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) load(i, buf + i * STAGE);
    cp_async_commit();
  }
}

// compute(i, stage) for the slices i < n in order, each slice's operands
// put in its stage by load(i, stage) STAGES - 1 slices ahead; `started`:
// the caller ran `ring_start` already.
template <int STAGE, class Load, class Compute>
__device__ __forceinline__ void ring(int n, float* buf, Load load,
                                     Compute compute, bool started = false) {
  if (!started) ring_start<STAGE>(n, buf, load);
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // slice i is in; every warp is done with slice i - 1
    const int nx = i + STAGES - 1;
    if (nx < n) load(nx, buf + (nx % STAGES) * STAGE);
    cp_async_commit();
    compute(i, buf + (i % STAGES) * STAGE);
  }
  cp_async_wait<0>();
  __syncthreads();
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
}

// ---- pass 1: outputs side ---------------------------------------------

template <int NJ>
__global__ void __launch_bounds__(THREADS, Cfg<NJ>::MINB)
mlstm_bwd_outputs_kernel(const float* __restrict__ q,
                         const float* __restrict__ dh,
                         const float* __restrict__ h,
                         const float* __restrict__ dot,
                         const float* __restrict__ ig,
                         const float* __restrict__ fg,
                         const float* __restrict__ work,
                         const float* __restrict__ scal,
                         float* __restrict__ dwork,
                         float* __restrict__ dscal, int H, int T, int D,
                         int L, Strides st, bool vec) {
  using C = Cfg<NJ>;
  constexpr int DP = C::DP, RS = C::RS, NT = C::NT;
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                 // [LMAX][RS]: the chunk's q
  float* sd = sq + LMAX * RS;       // [LMAX][RS]: its dh
  float* iv = sd + LMAX * RS;       // [LMAX] each below
  float* fv = iv + LMAX;
  float* dotv = fv + LMAX;
  float* flo = dotv + LMAX;
  float* sig = flo + LMAX;
  float* sr = sig + LMAX;           // sigma_r / den_r
  float* ddot = sr + LMAX;
  float* part = ddot + LMAX;        // [WARPS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int hd = bh % H, b = bh / H, t0 = c * L;
  const int64_t off = b * st.qs_b + hd * st.qs_h + t0 * st.qs_t;
  const int64_t HD = (int64_t)H * D;
  const int64_t hrow = ((int64_t)b * T + t0) * HD + (int64_t)hd * D;
  const float* slot = work + ((int64_t)bh * nc + c) * (D + 1) * DP;
  float* dslot = dwork + ((int64_t)bh * nc + c) * (D + 1) * DP;
  const float m_in = scal[((int64_t)bh * nc + c) * 4 + 2];

  load_tile<LMAX, DP>(sq, RS, q + off, st.qs_t, 0, L, 0, D, vec);
  load_tile<LMAX, DP>(sd, RS, dh + hrow, HD, 0, L, 0, D, vec);
  cp_async_commit();
  for (int s = tid; s < LMAX; s += THREADS) {
    const bool ok = s < L;
    const int64_t g = b * st.gs_b + hd * st.gs_h + (t0 + s) * st.gs_t;
    iv[s] = ok ? ig[g] : 0.0f;
    fv[s] = ok ? fg[g] : 0.0f;
    dotv[s] = ok ? dot[(int64_t)bh * T + t0 + s] : 0.0f;
    sig[s] = sr[s] = ddot[s] = 0.0f;
  }
  __syncthreads();
  if (warp == 0) {
    const GateScan r = gate_scan(iv, fv, L, lane);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = 2 * lane + u;
      if (s < L) {
        const float M = fmaxf(m_in, u ? r.g1 : r.g0);
        sig[s] = expf(m_in - M);
        flo[s] = expf(-((u ? r.b1 : r.b0) + M));
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // Per row (four threads a row): <dh_r, h_r> -> ddot_r, and sigma_r /
  // den_r.
  {
    const int r = tid >> 2, p = tid & 3;
    float hh = 0.0f;
    if (r < L) {
      const float* b = h + hrow + r * HD;
      if (vec) {
        for (int d = 4 * p; d < D; d += 16) {
          const float4 x = *reinterpret_cast<const float4*>(sd + r * RS + d);
          const float4 y = *reinterpret_cast<const float4*>(b + d);
          hh += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
        }
      } else {
        for (int d = p; d < D; d += 4) hh += sd[r * RS + d] * b[d];
      }
    }
    hh += __shfl_xor_sync(FULL, hh, 1);
    hh += __shfl_xor_sync(FULL, hh, 2);
    if (p == 0 && r < L) {
      const float ad = fabsf(dotv[r]);
      const float den = fmaxf(ad, flo[r]);
      const float rden = 1.0f / den;
      sr[r] = sig[r] * rden;
      ddot[r] = ad >= flo[r] ? -hh * rden * sgn(dotv[r]) : 0.0f;
    }
  }
  __syncthreads();

  // dm_own = sum_r sigma_r dsigma_r, dsigma_r = <dh~_r, q_r C_in> +
  // ddot_r (n_in . q_r), is <C_in, dC_own> + <n_in, dn_own>: a dot of the
  // chunk state with its gradient in place of a product q C_in (K = D).
  float xm = 0.0f;
  // dn_own = sum_r sigma_r ddot_r q_r: row D.
  for (int d = tid; d < DP; d += THREADS) {
    float s = 0.0f;
    if (d < D) {
      for (int r = 0; r < L; ++r) s += sig[r] * ddot[r] * sq[r * RS + d];
      xm += s * slot[(int64_t)D * DP + d];
    }
    dslot[(int64_t)D * DP + d] = s;
  }
  // dC_own = (sigma / den . q)^T dh, 64 rows of d at a time.
  const int g = lane >> 2, t = lane & 3, wm = warp & 3, wn = warp >> 2;
  const int n0 = wn * (DP / 2);
  const int L16 = (L + 15) & ~15;
  for (int rb = 0; rb < D; rb += 64) {
    float acc[1][NT][4];
    zero_acc(acc);
    const int m0 = rb + 16 * wm;
    for (int k0 = 0; k0 < L16; k0 += 16)
      mma_k16(
          acc, [&](int k, int m) { return sq[k * RS + m] * sr[k]; },
          [&](int k, int n) { return sd[k * RS + n]; }, k0, m0, n0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int d = m0 + g + 8 * hf;
        if (d < D) {
          const int64_t at = (int64_t)d * DP + n0 + 8 * j + 2 * t;
          const float a0 = acc[0][j][2 * hf], a1 = acc[0][j][2 * hf + 1];
          *reinterpret_cast<float2*>(dslot + at) = make_float2(a0, a1);
          const float2 w2 = *reinterpret_cast<const float2*>(slot + at);
          xm += a0 * w2.x + a1 * w2.y;
        }
      }
  }
  xm = warp_sum(xm);
  if (lane == 0) part[warp] = xm;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += part[w];
    float* ds = dscal + ((int64_t)bh * nc + c) * 4;
    ds[0] = s;
    ds[1] = 0.0f;   // X_c: pass 2 adds into it
    ds[2] = 0.0f;
    ds[3] = 0.0f;
  }
}

// ---- pass 2: the reverse inter-chunk scan ------------------------------

__global__ void __launch_bounds__(THREADS)
mlstm_bwd_scan_kernel(float* __restrict__ dwork, float* __restrict__ dscal,
                      const float* __restrict__ work,
                      const float* __restrict__ scal,
                      const float* __restrict__ dC1,
                      const float* __restrict__ dn1,
                      const float* __restrict__ gauge,
                      float* __restrict__ dC0, float* __restrict__ dn0,
                      int nc, int D, int DP) {
  const int bh = blockIdx.y, lane = threadIdx.x & 31;
  const int x = blockIdx.x * THREADS + threadIdx.x;   // float4 of a slot
  const int row = 4 * x / DP, col = 4 * x % DP;
  const bool live = row <= D;
  const int64_t slot4 = (int64_t)(D + 1) * DP / 4;
  float4* dbase = reinterpret_cast<float4*>(dwork) + (int64_t)bh * nc * slot4
                  + x;
  const float4* wbase =
      reinterpret_cast<const float4*>(work) + (int64_t)bh * nc * slot4 + x;
  const float4* sc = reinterpret_cast<const float4*>(scal) + (int64_t)bh * nc;

  float cv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cc = col + j;
    cv[j] = !live || cc >= D ? 0.0f
            : row < D ? (dC1 ? dC1[((int64_t)bh * D + row) * D + cc] : 0.0f)
                      : (dn1 ? dn1[(int64_t)bh * D + cc] : 0.0f);
  }
  float g = gauge ? gauge[bh] : 0.0f;
  constexpr int U = 4;   // chunks whose loads are issued together
  for (int c1 = nc - 1; c1 >= 0; c1 -= U) {
    float4 own[U], wv[U], s4[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c1 - u;
      if (c >= 0) {
        s4[u] = sc[c];
        if (live) {
          own[u] = dbase[c * slot4];
          wv[u] = wbase[c * slot4];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c1 - u;
      if (c < 0) break;
      const float G = s4[u].y, m = s4[u].z;
      const float alpha = expf(m - fmaxf(m, G));
      float part = 0.0f;
      if (live) {
        dbase[c * slot4] = make_float4(cv[0], cv[1], cv[2], cv[3]);
        part = cv[0] * wv[u].x + cv[1] * wv[u].y + cv[2] * wv[u].z +
               cv[3] * wv[u].w;
        cv[0] = alpha * cv[0] + own[u].x;
        cv[1] = alpha * cv[1] + own[u].y;
        cv[2] = alpha * cv[2] + own[u].z;
        cv[3] = alpha * cv[3] + own[u].w;
      }
      part = warp_sum(part);
      float* ds = dscal + ((int64_t)bh * nc + c) * 4;
      if (lane == 0 && part != 0.0f) atomicAdd(ds + 1, part);
      if (x == 0) ds[2] = g;
      g = m >= G ? g : 0.0f;
    }
  }
  if (live)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = col + j;
      if (cc >= D) break;
      if (row < D)
        dC0[((int64_t)bh * D + row) * D + cc] = cv[j];
      else
        dn0[(int64_t)bh * D + cc] = cv[j];
    }
}

// ---- pass 3: inputs side ----------------------------------------------

template <int NJ>
__global__ void __launch_bounds__(THREADS, Cfg<NJ>::MINB)
mlstm_bwd_inputs_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ ig,
    const float* __restrict__ fg, const float* __restrict__ dh,
    const float* __restrict__ h, const float* __restrict__ dot,
    const float* __restrict__ work, const float* __restrict__ scal,
    const float* __restrict__ dwork, const float* __restrict__ dscal,
    const float* __restrict__ dm1, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dig,
    float* __restrict__ dfg, float* __restrict__ dm0, int H, int T, int D,
    int L, Strides st, bool vec) {
  using C = Cfg<NJ>;
  constexpr int DP = C::DP, RS = C::RS, NT = C::NT3, STAGE = C::STAGE;
  constexpr int MT = 2;              // row tiles a warp
  constexpr int BOFF = LMAX * AKS;   // a stage's B slice, after its A slice
  extern __shared__ __align__(16) float smem[];
  float* buf = smem;                   // [STAGES][STAGE]: the ring
  float* Pt = buf + STAGES * STAGE;    // [LMAX][PS]: P[r][s] / den_r
  float* dSm = Pt + LMAX * PS;         // [LMAX][PS]: dS[r][s]
  float* csp = dSm + LMAX * PS;        // [2][LMAX]: sum_r dP P by row half
  float* dap = csp + 2 * LMAX;         // [4][LMAX]: da_s by column quarter
  float* iv = dap + 4 * LMAX;          // [LMAX] each below
  float* fv = iv + LMAX;
  float* dotv = fv + LMAX;
  float* wvec = dotv + LMAX;
  float* Mvec = wvec + LMAX;
  float* sig = Mvec + LMAX;
  float* flo = sig + LMAX;
  float* av = flo + LMAX;
  float* rden = av + LMAX;
  float* ddot = rden + LMAX;
  float* dbden = ddot + LMAX;
  float* misc = dbden + LMAX;          // dm_out, the argmax of G

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int hd = bh % H, b = bh / H, t0 = c * L;
  const int64_t off = b * st.qs_b + hd * st.qs_h + t0 * st.qs_t;
  const int64_t HD = (int64_t)H * D;
  const int64_t hrow = ((int64_t)b * T + t0) * HD + (int64_t)hd * D;
  const int64_t base = (int64_t)bh * nc + c;
  const float* slot = work + base * (D + 1) * DP;
  const float* dslot = dwork + base * (D + 1) * DP;
  const float4 s4 = reinterpret_cast<const float4*>(scal)[base];
  const float G = s4.y, m_in = s4.z;
  const float Mc = fmaxf(m_in, G);
  const bool mwin = m_in >= G;
  const float g_c = dscal[base * 4 + 2];
  const float* qb = q + off;
  const float* kb = k + off;
  const float* vb = v + off;
  const float* dhb = dh + hrow;
  const int nsd = (D + KS - 1) / KS;   // slices over K = D
  const int nsl = (L + KS - 1) / KS;   // slices over K = L
  // S and dP's slices: q, k, dh, v, 64 rows x KS columns each. The first
  // is on its way while the gates and the rows' sums are formed.
  auto sdp_load = [&](int i, float* s) {
    const int c0 = i * KS;
    load_tile<LMAX, KS>(s, AKS, qb, st.qs_t, 0, L, c0, D, vec);
    load_tile<LMAX, KS>(s + LMAX * AKS, AKS, kb, st.qs_t, 0, L, c0, D, vec);
    load_tile<LMAX, KS>(s + 2 * LMAX * AKS, AKS, dhb, HD, 0, L, c0, D, vec);
    load_tile<LMAX, KS>(s + 3 * LMAX * AKS, AKS, vb, st.qs_t, 0, L, c0, D,
                        vec);
  };
  ring_start<STAGE>(nsd, buf, sdp_load);

  for (int s = tid; s < LMAX; s += THREADS) {
    const bool ok = s < L;
    const int64_t gi = b * st.gs_b + hd * st.gs_h + (t0 + s) * st.gs_t;
    iv[s] = ok ? ig[gi] : 0.0f;
    fv[s] = ok ? fg[gi] : 0.0f;
    dotv[s] = ok ? dot[(int64_t)bh * T + t0 + s] : 0.0f;
    sig[s] = av[s] = rden[s] = ddot[s] = dbden[s] = 0.0f;
  }
  __syncthreads();
  if (warp == 0) {
    const GateScan r = gate_scan(iv, fv, L, lane);
    int arg = LMAX;   // the first s with w_s = G
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = 2 * lane + u;
      if (s < L) {
        const float ws = u ? r.w1 : r.w0;
        const float M = fmaxf(m_in, u ? r.g1 : r.g0);
        wvec[s] = ws;
        Mvec[s] = M;
        sig[s] = expf(m_in - M);
        flo[s] = expf(-((u ? r.b1 : r.b0) + M));
        av[s] = expf(ws - Mc);
        if (ws == G && arg == LMAX) arg = s;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      arg = min(arg, __shfl_xor_sync(FULL, arg, o));
    if (lane == 0) {
      // The gradient at this chunk's end m: the next chunk's dm_in.
      float dmo;
      if (c == nc - 1) {
        dmo = dm1 ? dm1[bh] : 0.0f;
      } else {
        const float4 n4 = reinterpret_cast<const float4*>(scal)[base + 1];
        const float* nd = dscal + (base + 1) * 4;
        dmo = expf(n4.z - fmaxf(n4.z, n4.y)) * nd[1] + nd[0] +
              (n4.z >= n4.y ? nd[2] : 0.0f);
      }
      misc[0] = dmo;
      misc[1] = __int_as_float(arg);
      if (c == 0) {
        const float* od = dscal + base * 4;
        dm0[bh] = expf(m_in - Mc) * od[1] + od[0] + (mwin ? g_c : 0.0f);
      }
    }
  }
  __syncthreads();
  {   // Per row, four threads a row, 16 bytes at a time under `vec`.
    const int r = tid >> 2, p = tid & 3;
    float hh = 0.0f;
    if (r < L) {
      const float* a = dh + hrow + r * HD;
      const float* b = h + hrow + r * HD;
      if (vec) {
        for (int d = 4 * p; d < D; d += 16) {
          const float4 x = *reinterpret_cast<const float4*>(a + d);
          const float4 y = *reinterpret_cast<const float4*>(b + d);
          hh += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
        }
      } else {
        for (int d = p; d < D; d += 4) hh += a[d] * b[d];
      }
    }
    hh += __shfl_xor_sync(FULL, hh, 1);
    hh += __shfl_xor_sync(FULL, hh, 2);
    if (p == 0 && r < L) {
      const float ad = fabsf(dotv[r]);
      const float den = fmaxf(ad, flo[r]);
      const bool on = ad >= flo[r];
      rden[r] = 1.0f / den;
      ddot[r] = on ? -hh / den * sgn(dotv[r]) : 0.0f;
      dbden[r] = on ? 0.0f : hh;
    }
  }
  __syncthreads();

  // Warps as 2 row halves (32 rows) x 4 column quarters: DP / 4 columns of
  // the full-width products (MT x NT m16n8 tiles), 16 of S and dP.
  const int g = lane >> 2, t = lane & 3, wm = warp & 1, wn = warp >> 1;
  const int m0 = 32 * wm, n0 = wn * (DP / 4);
  // Operand readers of a stage: its k-contiguous A slice; its B slice,
  // k-contiguous (a state read transposed, rows d) or n-contiguous.
  auto a_k = [](const float* s) {
    return [s](int kk, int m) { return s[m * AKS + kk]; };
  };
  auto b_k = [](const float* s) {
    return [s](int kk, int n) { return s[BOFF + n * AKS + kk]; };
  };
  auto b_n = [](const float* s) {
    return [s](int kk, int n) { return s[BOFF + kk * RS + n]; };
  };

  // S = q k^T and dP = dh v^T (K = D); P / den, dS, the sums of dP P.
  {
    float aS[MT][2][4], aP[MT][2][4];
    zero_acc(aS);
    zero_acc(aP);
    ring<STAGE>(
        nsd, buf, sdp_load,
        [&](int, float* s) {
          const float* s2 = s + 2 * LMAX * AKS;
#pragma unroll
          for (int kk = 0; kk < KS; kk += 16) {
            mma_k16(aS, a_k(s), b_k(s), kk, m0, 16 * wn);
            mma_k16(aP, a_k(s2), b_k(s2), kk, m0, 16 * wn);
          }
        },
        true);
    float cpart[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m0 + 16 * mi + g + 8 * (e >> 1);
          const int s = 16 * wn + 8 * j + 2 * t + (e & 1);
          float pt = 0.0f, dS = 0.0f;
          if (r < L && s <= r) {
            const float Dw = expf(wvec[s] - Mvec[r]);
            const float dPv = fmaf(rden[r], aP[mi][j][e], ddot[r]);
            const float P = Dw * aS[mi][j][e];
            pt = P * rden[r];
            dS = dPv * Dw;
            cpart[j][e & 1] += dPv * P;
          }
          Pt[r * PS + s] = pt;
          dSm[r * PS + s] = dS;
        }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = cpart[j][e];
        x += __shfl_xor_sync(FULL, x, 4);
        x += __shfl_xor_sync(FULL, x, 8);
        x += __shfl_xor_sync(FULL, x, 16);
        if (g == 0) csp[wm * LMAX + 16 * wn + 8 * j + 2 * t + e] = x;
      }
  }

  float acc[MT][NT][4];
  // Element (i, j, e) of the accumulators: row m0 + 16 i + g + 8 (e / 2),
  // column n0 + 8 j + 2 t + e % 2. Rows < L, columns < D go to dq, dk or
  // dv: each lane's column pair as one 8-byte store under `vec`.
  auto store = [&](float* out) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = m0 + 16 * i + g + 8 * hf, col = n0 + 8 * j + 2 * t;
          float* o = out + off + r * st.qs_t + col;
          if (r >= L || col >= D) continue;
          if (vec)
            *reinterpret_cast<float2*>(o) =
                make_float2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
          else {
            o[0] = acc[i][j][2 * hf];
            if (col + 1 < D) o[1] = acc[i][j][2 * hf + 1];
          }
        }
  };
  // The state product (K = D) of a ring's first nsd slices, A a
  // k-contiguous slice of a chunk input, B a slice of a state: rows of K
  // (n-contiguous, `rows_k`) or rows of N read transposed.
  auto state_slice = [&](int i, float* s, const float* a, int64_t lda,
                         const float* state, bool rows_k) {
    const int c0 = i * KS;
    load_tile<LMAX, KS>(s, AKS, a, lda, 0, L, c0, D, vec);
    if (rows_k)
      load_tile<KS, DP>(s + BOFF, RS, state, DP, c0, D, 0, DP, true);
    else
      load_tile<DP, KS>(s + BOFF, AKS, state, DP, 0, D, c0, DP, true);
  };
  // An intra-chunk slice (K = L): B = rows [KS j, KS j + KS) of a chunk
  // input.
  auto intra_slice = [&](int j, float* s, const float* src, int64_t ld) {
    load_tile<KS, DP>(s + BOFF, RS, src, ld, j * KS, L, 0, D, vec);
  };

  // dk = a_s (dC_out v_s + dn_out) + dS^T q; da_s = <k_s, dC_out v_s +
  // dn_out>.
  zero_acc(acc);
  ring<STAGE>(
      nsd + nsl, buf,
      [&](int i, float* s) {
        if (i < nsd) state_slice(i, s, vb, st.qs_t, dslot, false);
        else intra_slice(i - nsd, s, qb, st.qs_t);
      },
      [&](int i, float* s) {
        if (i == nsd) {
          float dap_r[MT][2] = {};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int col = n0 + 8 * j + 2 * t;
            const float2 dn =
                *reinterpret_cast<const float2*>(dslot + D * DP + col);
#pragma unroll
            for (int mi = 0; mi < MT; ++mi)
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int r = m0 + 16 * mi + g + 8 * hf;
                const float* kr = kb + r * st.qs_t + col;
                float2 kv = make_float2(0.0f, 0.0f);
                if (r < L && col < D) {
                  if (vec) kv = *reinterpret_cast<const float2*>(kr);
                  else kv = make_float2(kr[0], col + 1 < D ? kr[1] : 0.0f);
                }
                const float u0 = acc[mi][j][2 * hf] + dn.x;
                const float u1 = acc[mi][j][2 * hf + 1] + dn.y;
                dap_r[mi][hf] += u0 * kv.x + u1 * kv.y;
                const float a = r < L ? av[r] : 0.0f;
                acc[mi][j][2 * hf] = u0 * a;
                acc[mi][j][2 * hf + 1] = u1 * a;
              }
          }
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              float x = dap_r[mi][hf];
              x += __shfl_xor_sync(FULL, x, 1);
              x += __shfl_xor_sync(FULL, x, 2);
              if (t == 0) dap[wn * LMAX + m0 + 16 * mi + g + 8 * hf] = x;
            }
        }
        if (i < nsd) {
#pragma unroll
          for (int kk = 0; kk < KS; kk += 16)
            mma_k16(acc, a_k(s), b_k(s), kk, m0, n0);
        } else {
          const float* p = dSm + (i - nsd) * KS * PS;
#pragma unroll
          for (int kk = 0; kk < KS; kk += 16)
            mma_k16(
                acc, [p](int k_, int m) { return p[k_ * PS + m]; }, b_n(s),
                kk, m0, n0);
        }
      });
  store(dk);

  // dv = a_s (k_s dC_out) + (P / den)^T dh.
  zero_acc(acc);
  ring<STAGE>(
      nsd + nsl, buf,
      [&](int i, float* s) {
        if (i < nsd) state_slice(i, s, kb, st.qs_t, dslot, true);
        else intra_slice(i - nsd, s, dhb, HD);
      },
      [&](int i, float* s) {
        if (i == nsd)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = m0 + 16 * mi + g + 8 * (e >> 1);
                acc[mi][j][e] *= r < L ? av[r] : 0.0f;
              }
        if (i < nsd) {
#pragma unroll
          for (int kk = 0; kk < KS; kk += 16)
            mma_k16(acc, a_k(s), b_n(s), kk, m0, n0);
        } else {
          const float* p = Pt + (i - nsd) * KS * PS;
#pragma unroll
          for (int kk = 0; kk < KS; kk += 16)
            mma_k16(
                acc, [p](int k_, int m) { return p[k_ * PS + m]; }, b_n(s),
                kk, m0, n0);
        }
      });
  store(dv);

  // dq = sigma_r (C_in dh~_r + ddot_r n_in) + dS k.
  zero_acc(acc);
  ring<STAGE>(
      nsd + nsl, buf,
      [&](int i, float* s) {
        if (i < nsd) state_slice(i, s, dhb, HD, slot, false);
        else intra_slice(i - nsd, s, kb, st.qs_t);
      },
      [&](int i, float* s) {
        if (i == nsd)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float2 n = *reinterpret_cast<const float2*>(
                slot + D * DP + n0 + 8 * j + 2 * t);
#pragma unroll
            for (int mi = 0; mi < MT; ++mi)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = m0 + 16 * mi + g + 8 * (e >> 1);
                acc[mi][j][e] =
                    r < L ? sig[r] * fmaf(rden[r], acc[mi][j][e],
                                          ddot[r] * (e & 1 ? n.y : n.x))
                          : 0.0f;
              }
          }
        if (i < nsd) {
#pragma unroll
          for (int kk = 0; kk < KS; kk += 16)
            mma_k16(acc, a_k(s), b_k(s), kk, m0, n0);
        } else {
          const int k0 = (i - nsd) * KS;
#pragma unroll
          for (int kk = 0; kk < KS; kk += 16)
            mma_k16(
                acc, [&](int k_, int m) { return dSm[m * PS + k0 + k_]; },
                b_n(s), kk, m0, n0);
        }
      });
  store(dq);

  // Gate gradients: di = dw; df = reverse cumsum of db.
  if (warp == 0) {
    const float dmo = misc[0];
    const int arg = __float_as_int(misc[1]);
    float dw[2], db[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = 2 * lane + u;
      dw[u] = db[u] = 0.0f;
      if (s < L) {
        const float cs = csp[s] + csp[LMAX + s];
        const float da = dap[s] + dap[LMAX + s] + dap[2 * LMAX + s] +
                         dap[3 * LMAX + s];
        dw[u] = cs + av[s] * da + (!mwin && s == arg ? g_c : 0.0f);
        db[u] = dbden[s] - dw[u] + (s == L - 1 ? dmo : 0.0f);
      }
    }
    float x = db[0] + db[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    const float total = __shfl_sync(FULL, x, 31);
    float excl = __shfl_up_sync(FULL, x, 1);
    if (lane == 0) excl = 0.0f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = 2 * lane + u;
      if (s < L) {
        const int64_t gi = b * st.gs_b + hd * st.gs_h + (t0 + s) * st.gs_t;
        dig[gi] = dw[u];
        dfg[gi] = total - excl - (u ? db[0] : 0.0f);
      }
    }
  }
}

size_t outputs_smem(int NJ) {
  const int RS = 64 * NJ + 8;
  return (size_t)(2 * LMAX * RS + 7 * LMAX + WARPS) * 4;
}

template <int NJ>
constexpr size_t inputs_smem() {
  return (size_t)(STAGES * Cfg<NJ>::STAGE + 2 * LMAX * PS + 17 * LMAX + 2) *
         4;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Whether the chunk inputs' rows may be copied 16 bytes at a time.
bool rows_vec(int D, int qs_b, int qs_h, int qs_t,
              std::initializer_list<const void*> ptrs) {
  if (D % 4 || qs_b % 4 || qs_h % 4 || qs_t % 4) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

}  // namespace

// Pass 1. q: f32 with element (b, h, t, d) at b*qs_b + h*qs_h + t*qs_t + d;
// it, ft: f32 at b*gs_b + h*gs_h + t*gs_t; dh, h (B, T, H*D) f32; dot (B,
// H, T) f32; work / scal as the forward's pass 2 left them. dwork (like
// work) and dscal (B, H, T/L, 4) f32 out, every element written.
extern "C" int mlstm_bwd_outputs_launch(
    const void* q, const void* dh, const void* h, const void* dot,
    const void* it, const void* ft, const void* work, const void* scal,
    void* dwork, void* dscal, int B, int H, int T, int D, int L, int qs_b,
    int qs_h, int qs_t, int gs_b, int gs_h, int gs_t, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (!shape_ok(B, H, T, D, L)) return (int)cudaErrorInvalidValue;
  const int NJ = (D + 63) / 64;
  const Strides st{qs_b, qs_h, qs_t, gs_b, gs_h, gs_t};
  const bool vec = rows_vec(D, qs_b, qs_h, qs_t, {q, dh});
  const dim3 grid(T / L, B * H);
  const size_t bytes = outputs_smem(NJ);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  auto run = [&](auto kernel) {
    err = set_smem(kernel, bytes);
    if (err == cudaSuccess)
      kernel<<<grid, THREADS, bytes, s>>>(
          (const float*)q, (const float*)dh, (const float*)h,
          (const float*)dot, (const float*)it, (const float*)ft,
          (const float*)work, (const float*)scal, (float*)dwork,
          (float*)dscal, H, T, D, L, st, vec);
  };
  switch (NJ) {
    case 1: run(mlstm_bwd_outputs_kernel<1>); break;
    case 2: run(mlstm_bwd_outputs_kernel<2>); break;
    case 3: run(mlstm_bwd_outputs_kernel<3>); break;
    default: run(mlstm_bwd_outputs_kernel<4>); break;
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Pass 2. dwork / dscal as pass 1 left them, rewritten in place; work /
// scal the forward's; dC1 (B,H,D,D), dn1 (B,H,D), gauge (B,H): the final
// state's gradient and its gauge part, each may be null (zero). dC0, dn0
// out.
extern "C" int mlstm_bwd_scan_launch(void* dwork, void* dscal,
                                     const void* work, const void* scal,
                                     const void* dC1, const void* dn1,
                                     const void* gauge, void* dC0, void* dn0,
                                     int B, int H, int nc, int D,
                                     void* stream) {
  if (B <= 0 || nc <= 0) return 0;
  if (D <= 0 || D > 256 || H <= 0 || (int64_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const int DP = (D + 63) / 64 * 64;
  const int n4 = (D + 1) * DP / 4;
  const dim3 grid((n4 + THREADS - 1) / THREADS, B * H);
  mlstm_bwd_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)dwork, (float*)dscal, (const float*)work, (const float*)scal,
      (const float*)dC1, (const float*)dn1, (const float*)gauge,
      (float*)dC0, (float*)dn0, nc, D, DP);
  return (int)cudaGetLastError();
}

// Pass 3. q, k, v (q's strides), it, ft as pass 1; dh, h, dot, work,
// scal as pass 1; dwork / dscal as pass 2 left them; dm1 (B, H) or null.
// dq, dk, dv with q's strides, dit, dft with it's, dm0 (B, H) out.
extern "C" int mlstm_bwd_inputs_launch(
    const void* q, const void* k, const void* v, const void* it,
    const void* ft, const void* dh, const void* h, const void* dot,
    const void* work, const void* scal, const void* dwork,
    const void* dscal, const void* dm1, void* dq, void* dk, void* dv,
    void* dit, void* dft, void* dm0, int B, int H, int T, int D, int L,
    int qs_b, int qs_h, int qs_t, int gs_b, int gs_h, int gs_t,
    void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (!shape_ok(B, H, T, D, L)) return (int)cudaErrorInvalidValue;
  const int NJ = (D + 63) / 64;
  const Strides st{qs_b, qs_h, qs_t, gs_b, gs_h, gs_t};
  const bool vec = rows_vec(D, qs_b, qs_h, qs_t, {q, k, v, dh, dq, dk, dv});
  const dim3 grid(T / L, B * H);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  auto run = [&](auto kernel, size_t bytes) {
    err = set_smem(kernel, bytes);
    if (err == cudaSuccess)
      kernel<<<grid, THREADS, bytes, s>>>(
          (const float*)q, (const float*)k, (const float*)v,
          (const float*)it, (const float*)ft, (const float*)dh,
          (const float*)h, (const float*)dot, (const float*)work,
          (const float*)scal, (const float*)dwork, (const float*)dscal,
          (const float*)dm1, (float*)dq, (float*)dk, (float*)dv,
          (float*)dit, (float*)dft, (float*)dm0, H, T, D, L, st, vec);
  };
  switch (NJ) {
    case 1: run(mlstm_bwd_inputs_kernel<1>, inputs_smem<1>()); break;
    case 2: run(mlstm_bwd_inputs_kernel<2>, inputs_smem<2>()); break;
    case 3: run(mlstm_bwd_inputs_kernel<3>, inputs_smem<3>()); break;
    default: run(mlstm_bwd_inputs_kernel<4>, inputs_smem<4>()); break;
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
