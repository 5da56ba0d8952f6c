// Backward of the chunkwise mLSTM (B7-bwd) as three passes that mirror
// the forward's (mlstm_chunk.cu), for sm_90a.
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
//      scan, the chunk's own gradient of its incoming state — dC_own,
//      dn_own into `dwork` (laid out like the forward's scratch) and
//      dm_own = sum_r sigma_r dsigma_r into `dscal`, as <C_in, dC_own> +
//      <n_in, dn_own> (the same sum without a product q C_in);
//   2. reverse inter-chunk scan (`mlstm_bwd_scan_kernel`), one thread per
//      four elements of (C, n) of a (b, head), serial over chunks from the
//      last: dC_in(c) = alpha_c dC_out(c) + dC_own(c), leaving dC_out(c) in
//      dwork and the gauge gradient g_c in dscal; the cross-chunk scalar
//      X_c is off the chain: each warp adds its partial with one float
//      atomic (an order that varies from call to call);
//   3. inputs side (`mlstm_bwd_inputs_kernel`), one block per (b, head,
//      chunk): S and dP (K = D), then dv, dk, dq each as one 64-row tile
//      of 64 NJ columns, a state product (K = D) and an intra-chunk
//      product (K = L); then the gate gradients by a warp scan. The block
//      of chunk 0 writes the initial m's gradient.
//
// Every product is `gemm_staged`: 256 threads over a 64-row tile, each
// holding 4 rows x 4 NJ columns on the FMA units (mlstm_tiles.cuh's
// `tile_mma`), both operands staged through shared memory 32 rows of K at
// a time from device memory (mostly L2: a chunk's q, k, v, dh are 48 KB
// each at D 192), threads walking the operand's contiguous dimension. All
// f32, like the forward. This is the simple design: no cp.async ring, no
// tensor cores, operands re-read for each product.
//
// What bounds it on an H100: operations, on the FMA units. Per chunk and
// (b, head): pass 1 2 L D^2 (dC_own); pass 3 6 L D^2 (k dC_out, v
// dC_out^T, dh~ C_in^T) + 10 L^2 D (S, dP, P^T dh~, dS^T q, dS k); the
// scratch adds 3 x (D + 1) x DP x 4 bytes of traffic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mlstm_tiles.cuh"

namespace {

using namespace mt;

constexpr int KS = 32;   // rows of K per staged slice

__device__ __forceinline__ float sgn(float x) {
  return (float)((x > 0.0f) - (x < 0.0f));
}

// acc[i][4 j + jj] += sum_{kk < K} A(kk, r0 + i) B(kk, c0 + 64 j + jj):
// both operands staged through shared memory KS rows of K at a time, sA
// [KS][LP], sB [KS][64 NJ + 4]. fa(kk, row) and fb(kk, col) read them (0
// outside); A_KK / B_KK: that operand is contiguous along kk in memory,
// so the threads walk kk first.
template <int NJ, bool A_KK, bool B_KK, class FA, class FB>
__device__ __forceinline__ void gemm_staged(float (&acc)[4][4 * NJ], int K,
                                            FA fa, FB fb, float* sA,
                                            float* sB, int r0, int c0) {
  constexpr int NC = 64 * NJ, LB = NC + 4;
  const int tid = threadIdx.x;
  for (int k0 = 0; k0 < K; k0 += KS) {
    const int ks = min(KS, K - k0);
    __syncthreads();   // the previous slice (or product) is read
    for (int idx = tid; idx < KS * 64; idx += THREADS) {
      const int kk = A_KK ? idx % KS : idx / 64;
      const int row = A_KK ? idx / KS : idx % 64;
      sA[kk * LP + row] = kk < ks ? fa(k0 + kk, row) : 0.0f;
    }
    for (int idx = tid; idx < KS * NC; idx += THREADS) {
      const int kk = B_KK ? idx % KS : idx / NC;
      const int col = B_KK ? idx / KS : idx % NC;
      sB[kk * LB + col] = kk < ks ? fb(k0 + kk, col) : 0.0f;
    }
    __syncthreads();
    tile_mma<NJ>(acc, sA, LP, sB, LB, 0, ks, r0, c0);
  }
}

// Sum over the 16 threads (tc) that share a row.
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

size_t staging_floats(int NJ) { return KS * LP + KS * (64 * NJ + 4); }

// ---- pass 1: outputs side ---------------------------------------------

template <int NJ>
__global__ void __launch_bounds__(THREADS)
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
                         int L, Strides st) {
  constexpr int DP = 64 * NJ;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;
  float* sB = sA + KS * LP;
  float* iv = sB + KS * (DP + 4);   // [LMAX] each below
  float* fv = iv + LMAX;
  float* dotv = fv + LMAX;
  float* flo = dotv + LMAX;
  float* sig = flo + LMAX;
  float* rden = sig + LMAX;
  float* ddot = rden + LMAX;
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

  for (int s = tid; s < L; s += THREADS) {
    const int64_t g = b * st.gs_b + hd * st.gs_h + (t0 + s) * st.gs_t;
    iv[s] = ig[g];
    fv[s] = fg[g];
    dotv[s] = dot[(int64_t)bh * T + t0 + s];
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
  __syncthreads();
  // Per row: <dh_r, h_r> -> ddot_r.
  for (int r = warp; r < L; r += WARPS) {
    float hh = 0.0f;
    for (int d = lane; d < D; d += 32)
      hh += dh[hrow + r * HD + d] * h[hrow + r * HD + d];
    hh = warp_sum(hh);
    if (lane == 0) {
      const float ad = fabsf(dotv[r]);
      const float den = fmaxf(ad, flo[r]);
      rden[r] = 1.0f / den;
      ddot[r] = ad >= flo[r] ? -hh / den * sgn(dotv[r]) : 0.0f;
    }
  }
  __syncthreads();

  const int tr = 2 * warp + (lane >> 4), tc = lane & 15;
  const int r0 = 4 * tr;
  float acc[4][4 * NJ];
  // dm_own = sum_r sigma_r dsigma_r, dsigma_r = <dh~_r, q_r C_in> +
  // ddot_r (n_in . q_r), is <C_in, dC_own> + <n_in, dn_own>: a dot of the
  // chunk state with its gradient in place of a product q C_in (K = D).
  float xm = 0.0f;
  // dC_own = sum_r sigma_r q_r dh~_r^T, 64 rows at a time.
  for (int rb = 0; rb < D; rb += 64) {
    zero<NJ>(acc);
    gemm_staged<NJ, false, false>(
        acc, L,
        [&](int kk, int row) {
          return rb + row < D ? sig[kk] * q[off + kk * st.qs_t + rb + row]
                              : 0.0f;
        },
        [&](int kk, int col) {
          return col < D ? dh[hrow + kk * HD + col] * rden[kk] : 0.0f;
        },
        sA, sB, r0, 4 * tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = rb + r0 + i;
      if (d < D)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int64_t at = (int64_t)d * DP + 4 * tc + 64 * j;
          *reinterpret_cast<float4*>(dslot + at) =
              make_float4(acc[i][4 * j], acc[i][4 * j + 1],
                          acc[i][4 * j + 2], acc[i][4 * j + 3]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (4 * tc + 64 * j + jj < D)
              xm += acc[i][4 * j + jj] * slot[at + jj];
        }
    }
  }
  // dn_own = sum_r sigma_r ddot_r q_r: row D.
  for (int d = tid; d < DP; d += THREADS) {
    float s = 0.0f;
    if (d < D) {
      for (int r = 0; r < L; ++r)
        s += sig[r] * ddot[r] * q[off + r * st.qs_t + d];
      xm += s * slot[(int64_t)D * DP + d];
    }
    dslot[(int64_t)D * DP + d] = s;
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
__global__ void __launch_bounds__(THREADS)
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
    int L, Strides st) {
  constexpr int DP = 64 * NJ;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;
  float* sB = sA + KS * LP;
  float* Pm = sB + KS * (DP + 4);   // [LMAX][LP]: P[r][s]
  float* dSm = Pm + LMAX * LP;      // [LMAX][LP]: dS[r][s]
  float* Tm = dSm + LMAX * LP;      // [LMAX][LP]: dP[r][s] P[r][s]
  float* iv = Tm + LMAX * LP;       // [LMAX] each below
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
  float* da = dbden + LMAX;
  float* cs = da + LMAX;
  float* misc = cs + LMAX;          // dm_out, the argmax of G

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

  for (int s = tid; s < L; s += THREADS) {
    const int64_t gi = b * st.gs_b + hd * st.gs_h + (t0 + s) * st.gs_t;
    iv[s] = ig[gi];
    fv[s] = fg[gi];
    dotv[s] = dot[(int64_t)bh * T + t0 + s];
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
  for (int r = warp; r < L; r += WARPS) {
    float hh = 0.0f;
    for (int d = lane; d < D; d += 32)
      hh += dh[hrow + r * HD + d] * h[hrow + r * HD + d];
    hh = warp_sum(hh);
    if (lane == 0) {
      const float ad = fabsf(dotv[r]);
      const float den = fmaxf(ad, flo[r]);
      const bool on = ad >= flo[r];
      rden[r] = 1.0f / den;
      ddot[r] = on ? -hh / den * sgn(dotv[r]) : 0.0f;
      dbden[r] = on ? 0.0f : hh;
    }
  }
  __syncthreads();

  const int tr = 2 * warp + (lane >> 4), tc = lane & 15;
  const int r0 = 4 * tr;
  // S = q k^T and dP = dh~ v^T + ddot_r, masked; P, dS, dP P.
  {
    float aS[4][4], aP[4][4];
    zero<1>(aS);
    zero<1>(aP);
    gemm_staged<1, true, true>(
        aS, D,
        [&](int kk, int row) {
          return row < L ? q[off + row * st.qs_t + kk] : 0.0f;
        },
        [&](int kk, int col) {
          return col < L ? k[off + col * st.qs_t + kk] : 0.0f;
        },
        sA, sB, r0, 4 * tc);
    gemm_staged<1, true, true>(
        aP, D,
        [&](int kk, int row) {
          return row < L ? dh[hrow + row * HD + kk] * rden[row] : 0.0f;
        },
        [&](int kk, int col) {
          return col < L ? v[off + col * st.qs_t + kk] : 0.0f;
        },
        sA, sB, r0, 4 * tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int s = 4 * tc + jj;
        float P = 0.0f, dS = 0.0f, t = 0.0f;
        if (r < L && s <= r) {
          const float Dw = expf(wvec[s] - Mvec[r]);
          const float dPv = aP[i][jj] + ddot[r];
          P = Dw * aS[i][jj];
          dS = dPv * Dw;
          t = dPv * P;
        }
        Pm[r * LP + s] = P;
        dSm[r * LP + s] = dS;
        Tm[r * LP + s] = t;
      }
    }
  }
  __syncthreads();
  if (tid < LMAX) {
    float s = 0.0f;
    for (int r = 0; r < L; ++r) s += Tm[r * LP + tid];
    cs[tid] = s;
  }

  float acc[4][4 * NJ];
  auto store = [&](float* out) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i;
      if (r >= L) break;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = 4 * tc + 64 * j + jj;
          if (col < D) out[off + r * st.qs_t + col] = acc[i][4 * j + jj];
        }
    }
  };
  auto dht = [&](int r, int col) {
    return col < D ? dh[hrow + r * HD + col] * rden[r] : 0.0f;
  };
  // dv = a_s (k_s dC_out) + P^T dh~.
  zero<NJ>(acc);
  gemm_staged<NJ, true, false>(
      acc, D,
      [&](int kk, int row) {
        return row < L ? k[off + row * st.qs_t + kk] : 0.0f;
      },
      [&](int kk, int col) { return dslot[(int64_t)kk * DP + col]; }, sA,
      sB, r0, 4 * tc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] *= av[r0 + i];
  gemm_staged<NJ, false, false>(
      acc, L, [&](int kk, int row) { return Pm[kk * LP + row]; }, dht, sA,
      sB, r0, 4 * tc);
  store(dv);
  // dk = a_s (dC_out v_s + dn_out) + dS^T q; da_s = <k_s, dC_out v_s +
  // dn_out>.
  zero<NJ>(acc);
  gemm_staged<NJ, true, true>(
      acc, D,
      [&](int kk, int row) {
        return row < L ? v[off + row * st.qs_t + kk] : 0.0f;
      },
      [&](int kk, int col) {
        return col < D ? dslot[(int64_t)col * DP + kk] : 0.0f;
      },
      sA, sB, r0, 4 * tc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + i;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = 4 * tc + 64 * j + jj;
        if (col < D && r < L) {
          acc[i][4 * j + jj] += dslot[(int64_t)D * DP + col];
          s += acc[i][4 * j + jj] * k[off + r * st.qs_t + col];
        }
        acc[i][4 * j + jj] *= r < L ? av[r] : 0.0f;
      }
    s = row_sum16(s);
    if (tc == 0 && r < L) da[r] = s;
  }
  gemm_staged<NJ, false, false>(
      acc, L, [&](int kk, int row) { return dSm[kk * LP + row]; },
      [&](int kk, int col) {
        return col < D ? q[off + kk * st.qs_t + col] : 0.0f;
      },
      sA, sB, r0, 4 * tc);
  store(dk);
  // dq = sigma_r (C_in dh~_r + ddot_r n_in) + dS k.
  zero<NJ>(acc);
  gemm_staged<NJ, true, true>(
      acc, D, [&](int kk, int row) { return row < L ? dht(row, kk) : 0.0f; },
      [&](int kk, int col) {
        return col < D ? slot[(int64_t)col * DP + kk] : 0.0f;
      },
      sA, sB, r0, 4 * tc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + i;
    const float sg = r < L ? sig[r] : 0.0f, dd = r < L ? ddot[r] : 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = 4 * tc + 64 * j + jj;
        const float n = col < D ? slot[(int64_t)D * DP + col] : 0.0f;
        acc[i][4 * j + jj] = sg * (acc[i][4 * j + jj] + dd * n);
      }
  }
  gemm_staged<NJ, false, false>(
      acc, L, [&](int kk, int row) { return dSm[row * LP + kk]; },
      [&](int kk, int col) {
        return col < D ? k[off + kk * st.qs_t + col] : 0.0f;
      },
      sA, sB, r0, 4 * tc);
  store(dq);
  __syncthreads();   // da, cs, misc
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
        dw[u] = cs[s] + av[s] * da[s] + (!mwin && s == arg ? g_c : 0.0f);
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
  return (staging_floats(NJ) + 7 * LMAX + WARPS) * 4;
}

size_t inputs_smem(int NJ) {
  return (staging_floats(NJ) + 3 * LMAX * LP + 14 * LMAX) * 4;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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
          (float*)dscal, H, T, D, L, st);
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
  const dim3 grid(T / L, B * H);
  const size_t bytes = inputs_smem(NJ);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  auto run = [&](auto kernel) {
    err = set_smem(kernel, bytes);
    if (err == cudaSuccess)
      kernel<<<grid, THREADS, bytes, s>>>(
          (const float*)q, (const float*)k, (const float*)v,
          (const float*)it, (const float*)ft, (const float*)dh,
          (const float*)h, (const float*)dot, (const float*)work,
          (const float*)scal, (const float*)dwork, (const float*)dscal,
          (const float*)dm1, (float*)dq, (float*)dk, (float*)dv,
          (float*)dit, (float*)dft, (float*)dm0, H, T, D, L, st);
  };
  switch (NJ) {
    case 1: run(mlstm_bwd_inputs_kernel<1>); break;
    case 2: run(mlstm_bwd_inputs_kernel<2>); break;
    case 3: run(mlstm_bwd_inputs_kernel<3>); break;
    default: run(mlstm_bwd_inputs_kernel<4>); break;
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
