// Chunkwise mLSTM (B7) as three chunk-parallel passes, for sm_90a.
//
// Replaces the chunk loop of `mlstm_chunkwise` in src/repro/models/xlstm.py
// (a `lax.scan` of `chunk_step` over chunks, `cummax` inside). Per (b,
// head) a carried state C (D x D), n (D), m; per chunk of L steps, with
// b = cumsum(f~), w = i~ - b, g = cummax(w), M_r = max(m, g_r):
//
//   P[r,s]  = (s <= r) exp(w_s - M_r) (q_r . k_s)
//   h~_r    = exp(m - M_r) (q_r C) + sum_s P[r,s] v_s
//   dot_r   = exp(m - M_r) (n . q_r) + sum_s P[r,s]
//   h_r     = h~_r / max(|dot_r|, exp(-(b_r + M_r)))
//   C' = exp(m - M_c) C + sum_s exp(w_s - M_c) k_s v_s^T,  n' likewise,
//   m' = b_last + M_c,  M_c = max(m, G),  G = max_s w_s.
//
// The recurrence carries only (C, n, m), and a chunk's own inputs enter it
// through G, b_last and sum_s exp(w_s - G) k_s v_s^T alone. So only a
// cheap elementwise scan stays serial:
//
//   1. chunk states (`mlstm_chunk_states_kernel`), one block per (b, head,
//      chunk): dC = sum_s exp(w_s - G) k_s v_s^T, dn = sum_s exp(w_s - G)
//      k_s, b_last and G, into a scratch the wrapper allocates;
//   2. inter-chunk scan (`mlstm_state_scan_kernel`), one thread per four
//      elements of (C, n) of a (b, head), serial over chunks: the scalar m
//      recurrence in the reference's float operations (M_c = max(m, G),
//      exp(m - M_c), m' = b_last + M_c), then C = exp(m - M_c) C +
//      exp(G - M_c) dC in place, so that the scratch ends holding each
//      chunk's incoming (C, n, m); the final state goes to C1, n1, m1;
//   3. chunk outputs (`mlstm_chunk_outputs_kernel`), one block per (b,
//      head, chunk): the formulas above from the chunk's q, k, v, gates and
//      its incoming state.
//
// The one reassociation of the reference's state update is exp(w_s - M_c)
// = exp(w_s - G) exp(G - M_c) (both factors <= 1); dot_r reassociates
// (sum_s Dw[r,s] k_s) . q_r as sum_s Dw[r,s] (k_s . q_r), reusing P, as
// the first design did. All f32.
//
// Layout. The scratch holds per (b, head, chunk) D + 1 rows of DP floats
// (DP = D rounded up to 64): rows 0..D-1 are dC then the incoming C, row D
// is dn then the incoming n, zero past column D; and four scalars (b_last,
// G, incoming m, unused). At xlstm-125m's 1 x 4 heads x 512 chunks x D 192
// that is 303.6 MB, written once by pass 1, read and written once by pass
// 2 and read once by pass 3.
//
// Products. Every product is one shape, a 64-row tile times up to 256
// columns over a K loop, run by 256 threads each holding 4 rows x 4 NJ
// columns (NJ = DP / 64) on the FMA units, operands as float4 from shared
// memory: pass 1's (a k)^T v per 64 rows of dC; pass 3's q k^T (64 x 64,
// K = D), q C (K = D, C streamed through shared memory 32 rows at a time
// by cp.async, double-buffered) and P v (K = the rows a warp owns, so the
// masked upper triangle is skipped). q and k are kept transposed (D x 68:
// the stride keeps float4 alignment). The gate scans (cumsum, cummax over
// L <= 64) run in warp 0, two steps a lane, by shuffles.
//
// For training, `mlstm_chunk_outputs_launch` given a `dot` also writes
// each row's dot_r (B, H, T), from which B7-bwd (mlstm_chunk_bwd.cu)
// recomputes the denominator and the branch that won it; with a null
// `dot` it is the serving paths' launch as before. The tile helpers are shared
// with B7-bwd through mlstm_tiles.cuh.
//
// What bounds it on an H100: operations, on the FMA units (the split-TF32
// tensor-core form of flash_tf32x3.cu is not used; see PERF.md). Per
// chunk and (b, head): 2 L D^2 FLOP in pass 1, 2 L^2 D + L^2 D + 2 L D^2
// in pass 3; the scratch adds 4 x (D + 1) x DP x 4 bytes of traffic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mlstm_tiles.cuh"

namespace {

using namespace mt;

constexpr int CROWS = 32;      // rows of C per cp.async slice in pass 3

// ---- pass 1: chunk states --------------------------------------------

template <int NJ>
__global__ void __launch_bounds__(THREADS)
mlstm_chunk_states_kernel(const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ ig,
                          const float* __restrict__ fg,
                          float* __restrict__ work, float* __restrict__ scal,
                          int H, int T, int D, int L, Strides st) {
  constexpr int DP = 64 * NJ;
  extern __shared__ __align__(16) float smem[];
  float* ak = smem;                    // [LMAX][DP]: exp(w_s - G) k_s
  float* vs = ak + LMAX * DP;          // [LMAX][DP]
  float* av = vs + LMAX * DP;          // [LMAX]: exp(w_s - G)
  float* iv = av + LMAX;
  float* fv = iv + LMAX;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int h = bh % H, b = bh / H, t0 = c * L;
  const float* kb = k + b * st.qs_b + h * st.qs_h + t0 * st.qs_t;
  const float* vb = v + b * st.qs_b + h * st.qs_h + t0 * st.qs_t;

  for (int idx = tid; idx < LMAX * DP; idx += THREADS) {
    const int s = idx / DP, d = idx % DP;
    const bool ok = s < L && d < D;
    ak[idx] = ok ? kb[s * st.qs_t + d] : 0.0f;
    vs[idx] = ok ? vb[s * st.qs_t + d] : 0.0f;
  }
  for (int s = tid; s < L; s += THREADS) {
    const int64_t g = b * st.gs_b + h * st.gs_h + (t0 + s) * st.gs_t;
    iv[s] = ig[g];
    fv[s] = fg[g];
  }
  __syncthreads();
  if (warp == 0) {
    const GateScan r = gate_scan(iv, fv, L, lane);
    float G = fmaxf(r.w0, r.w1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      G = fmaxf(G, __shfl_xor_sync(FULL, G, off));
    if (2 * lane < L) av[2 * lane] = expf(r.w0 - G);
    if (2 * lane + 1 < L) av[2 * lane + 1] = expf(r.w1 - G);
    const float b_last = __shfl_sync(FULL, (L - 1) % 2 ? r.b1 : r.b0,
                                     (L - 1) / 2);
    if (lane == 0) {
      float* sc = scal + ((int64_t)bh * nc + c) * 4;
      sc[0] = b_last;
      sc[1] = G;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < L * DP; idx += THREADS) ak[idx] *= av[idx / DP];
  __syncthreads();

  float* slot = work + ((int64_t)bh * nc + c) * (D + 1) * DP;
  // dn = sum_s a_s k_s: row D.
  for (int d = tid; d < DP; d += THREADS) {
    float acc = 0.0f;
    for (int s = 0; s < L; ++s) acc += ak[s * DP + d];
    slot[(int64_t)D * DP + d] = acc;
  }
  // dC, 64 rows at a time.
  const int tr = 2 * warp + (lane >> 4), tc = lane & 15;
  for (int rb = 0; rb < D; rb += 64) {
    float acc[4][4 * NJ];
    zero<NJ>(acc);
    tile_mma<NJ>(acc, ak, DP, vs, DP, 0, L, rb + 4 * tr, 4 * tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = rb + 4 * tr + i;
      if (d < D)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          *reinterpret_cast<float4*>(slot + (int64_t)d * DP + 4 * tc +
                                     64 * j) =
              make_float4(acc[i][4 * j], acc[i][4 * j + 1],
                          acc[i][4 * j + 2], acc[i][4 * j + 3]);
    }
  }
}

// ---- pass 2: the inter-chunk scan -------------------------------------

__global__ void __launch_bounds__(THREADS)
mlstm_state_scan_kernel(float* __restrict__ work, float* __restrict__ scal,
                        const float* __restrict__ C0,
                        const float* __restrict__ n0,
                        const float* __restrict__ m0, float* __restrict__ C1,
                        float* __restrict__ n1, float* __restrict__ m1,
                        int nc, int D, int DP) {
  const int bh = blockIdx.y;
  const int x = blockIdx.x * THREADS + threadIdx.x;   // float4 of a slot
  const int row = 4 * x / DP, col = 4 * x % DP;
  const bool live = row <= D;
  const int64_t slot = (int64_t)(D + 1) * DP;
  float4* base = reinterpret_cast<float4*>(work + (int64_t)bh * nc * slot) + x;
  // (b_last, G) of each chunk; the incoming m goes to the other half.
  const float2* sc =
      reinterpret_cast<const float2*>(scal) + 2 * (int64_t)bh * nc;

  float cv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cc = col + j;
    cv[j] = !live || cc >= D ? 0.0f
            : row < D ? C0[((int64_t)bh * D + row) * D + cc]
                      : n0[(int64_t)bh * D + cc];
  }
  float m = m0[bh];
  const bool writes_m = x == 0;
  constexpr int U = 4;   // chunks whose loads are issued together
  for (int c0 = 0; c0 < nc; c0 += U) {
    float4 dv[U];
    float2 s2[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u < nc) {
        s2[u] = sc[2 * (c0 + u)];
        if (live) dv[u] = base[(int64_t)(c0 + u) * (slot / 4)];
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u >= nc) break;
      const float G = s2[u].y;
      const float M = fmaxf(m, G);
      const float alpha = expf(m - M), beta = expf(G - M);
      if (live) {
        base[(int64_t)(c0 + u) * (slot / 4)] =
            make_float4(cv[0], cv[1], cv[2], cv[3]);
        cv[0] = alpha * cv[0] + beta * dv[u].x;
        cv[1] = alpha * cv[1] + beta * dv[u].y;
        cv[2] = alpha * cv[2] + beta * dv[u].z;
        cv[3] = alpha * cv[3] + beta * dv[u].w;
      }
      if (writes_m) scal[((int64_t)bh * nc + c0 + u) * 4 + 2] = m;
      m = s2[u].x + M;
    }
  }
  if (live)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = col + j;
      if (cc >= D) break;
      if (row < D)
        C1[((int64_t)bh * D + row) * D + cc] = cv[j];
      else
        n1[(int64_t)bh * D + cc] = cv[j];
    }
  if (writes_m) m1[bh] = m;
}

// ---- pass 3: chunk outputs --------------------------------------------

template <int NJ, bool DOT>
__global__ void __launch_bounds__(THREADS)
mlstm_chunk_outputs_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ ig,
                           const float* __restrict__ fg,
                           const float* __restrict__ work,
                           const float* __restrict__ scal,
                           float* __restrict__ hout,
                           float* __restrict__ dot_out, int H, int T, int D,
                           int L, Strides st) {
  constexpr int DP = 64 * NJ;
  extern __shared__ __align__(16) float smem[];
  const int ktile = D * LP > 2 * CROWS * DP ? D * LP : 2 * CROWS * DP;
  float* qT = smem;                    // [D][LP]
  float* kT = qT + D * LP;             // [D][LP], then C slices [2][CROWS][DP]
  float* vs = kT + ktile;              // [LMAX][DP]
  float* PT = vs + LMAX * DP;          // [LMAX][LP]: P transposed
  float* nv = PT + LMAX * LP;          // [DP]: incoming n
  float* iv = nv + DP;                 // [LMAX] each below
  float* fv = iv + LMAX;
  float* bvec = fv + LMAX;
  float* wvec = bvec + LMAX;
  float* Mvec = wvec + LMAX;
  float* scale = Mvec + LMAX;
  float* qn = scale + LMAX;
  float* rowsum = qn + LMAX;
  float* Cs = kT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int h = bh % H, b = bh / H, t0 = c * L;
  const int64_t off = b * st.qs_b + h * st.qs_h + t0 * st.qs_t;
  const float* slot = work + ((int64_t)bh * nc + c) * (D + 1) * DP;
  const float m_in = scal[((int64_t)bh * nc + c) * 4 + 2];

  for (int idx = tid; idx < LMAX * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const bool ok = r < L;
    qT[d * LP + r] = ok ? q[off + r * st.qs_t + d] : 0.0f;
    kT[d * LP + r] = ok ? k[off + r * st.qs_t + d] : 0.0f;
  }
  for (int idx = tid; idx < LMAX * DP; idx += THREADS) {
    const int s = idx / DP, d = idx % DP;
    vs[idx] = s < L && d < D ? v[off + s * st.qs_t + d] : 0.0f;
  }
  for (int d = tid; d < DP; d += THREADS) nv[d] = slot[(int64_t)D * DP + d];
  for (int s = tid; s < L; s += THREADS) {
    const int64_t g = b * st.gs_b + h * st.gs_h + (t0 + s) * st.gs_t;
    iv[s] = ig[g];
    fv[s] = fg[g];
  }
  __syncthreads();

  // Gate scans in warp 0; n . q_r in the other warps.
  if (warp == 0) {
    const GateScan r = gate_scan(iv, fv, L, lane);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = 2 * lane + u;
      if (s < L) {
        const float bs = u ? r.b1 : r.b0, ws = u ? r.w1 : r.w0;
        const float M = fmaxf(m_in, u ? r.g1 : r.g0);
        bvec[s] = bs;
        wvec[s] = ws;
        Mvec[s] = M;
        scale[s] = expf(m_in - M);
      }
    }
  } else {
    for (int r = warp - 1; r < L; r += WARPS - 1) {
      float acc = 0.0f;
      for (int d = lane; d < D; d += 32) acc += nv[d] * qT[d * LP + r];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
      if (lane == 0) qn[r] = acc;
    }
  }
  __syncthreads();

  const int tr = 2 * warp + (lane >> 4), tc = lane & 15;
  const int r0 = 4 * tr;
  // P = mask * exp(w_s - M_r) * (q_r . k_s), stored transposed; row sums.
  {
    float acc[4][4];
    zero<1>(acc);
    tile_mma<1>(acc, qT, LP, kT, LP, 0, D, r0, 4 * tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i;
      float rs = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int s = 4 * tc + jj;
        float p = 0.0f;
        if (r < L && s <= r) p = expf(wvec[s] - Mvec[r]) * acc[i][jj];
        PT[s * LP + r] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(FULL, rs, o);
      if (tc == 0 && r < L) rowsum[r] = rs;
    }
  }
  __syncthreads();   // kT is free: C slices go there

  // q C_in, C streamed CROWS rows at a time (double-buffered cp.async).
  float acc[4][4 * NJ];
  zero<NJ>(acc);
  const int nsl = (D + CROWS - 1) / CROWS;
  auto load_slice = [&](int sl) {
    float* dst = Cs + (sl & 1) * CROWS * DP;
    const int rows = min(CROWS, D - sl * CROWS);
    for (int idx = tid; idx < rows * DP / 4; idx += THREADS)
      cp_async16(dst + 4 * idx, slot + (int64_t)sl * CROWS * DP + 4 * idx);
    cp_async_commit();
  };
  load_slice(0);
  for (int sl = 0; sl < nsl; ++sl) {
    if (sl + 1 < nsl) {
      load_slice(sl + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int d0 = sl * CROWS;
    tile_mma<NJ>(acc, qT + d0 * LP, LP, Cs + (sl & 1) * CROWS * DP, DP, 0,
                 min(CROWS, D - d0), r0, 4 * tc);
    __syncthreads();
  }
  // h~ = scale_r (q C) + P v; P v over the rows s <= r this warp owns.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sc = scale[r0 + i];   // rows past L are never stored
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] *= sc;
  }
  tile_mma<NJ>(acc, PT, LP, vs, DP, 0, min(L, 8 * warp + 8), r0, 4 * tc);

  const int64_t HD = (int64_t)H * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + i;
    if (r >= L) break;
    const float dot = scale[r] * qn[r] + rowsum[r];
    const float den = fmaxf(fabsf(dot), expf(-(bvec[r] + Mvec[r])));
    if (DOT && tc == 0) dot_out[(int64_t)bh * T + t0 + r] = dot;
    float* out = hout + ((int64_t)b * T + t0 + r) * HD + (int64_t)h * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = 4 * tc + 64 * j + jj;
        if (col < D) out[col] = acc[i][4 * j + jj] / den;
      }
  }
}

size_t states_smem(int DP) { return (2 * (size_t)LMAX * DP + 3 * LMAX) * 4; }

size_t outputs_smem(int D, int DP) {
  const size_t ktile = (size_t)D * LP > (size_t)2 * CROWS * DP
                           ? (size_t)D * LP : (size_t)2 * CROWS * DP;
  return ((size_t)D * LP + ktile + (size_t)LMAX * DP + LMAX * LP + DP +
          9 * LMAX) * 4;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}


}  // namespace

// Pass 1. k, v: f32 with element (b, h, t, d) at b*qs_b + h*qs_h + t*qs_t
// + d; it, ft: f32 at b*gs_b + h*gs_h + t*gs_t. work (B, H, T/L, D+1, DP)
// f32 and scal (B, H, T/L, 4) f32 out (DP = D rounded up to 64). T % L ==
// 0, L <= 64, D <= 256.
extern "C" int mlstm_chunk_states_launch(
    const void* k, const void* v, const void* it, const void* ft,
    void* work, void* scal, int B, int H, int T, int D, int L, int qs_b,
    int qs_h, int qs_t, int gs_b, int gs_h, int gs_t, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (!shape_ok(B, H, T, D, L)) return (int)cudaErrorInvalidValue;
  const int NJ = (D + 63) / 64;
  const Strides st{qs_b, qs_h, qs_t, gs_b, gs_h, gs_t};
  const dim3 grid(T / L, B * H);
  const size_t bytes = states_smem(64 * NJ);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  auto run = [&](auto kernel) {
    err = set_smem(kernel, bytes);
    if (err == cudaSuccess)
      kernel<<<grid, THREADS, bytes, s>>>(
          (const float*)k, (const float*)v, (const float*)it,
          (const float*)ft, (float*)work, (float*)scal, H, T, D, L, st);
  };
  switch (NJ) {
    case 1: run(mlstm_chunk_states_kernel<1>); break;
    case 2: run(mlstm_chunk_states_kernel<2>); break;
    case 3: run(mlstm_chunk_states_kernel<3>); break;
    default: run(mlstm_chunk_states_kernel<4>); break;
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Pass 2. work / scal as pass 1 left them, rewritten in place to each
// chunk's incoming (C, n) and m (scal[..., 2]); state C0 (B,H,D,D), n0
// (B,H,D), m0 (B,H) in, C1 / n1 / m1 out.
extern "C" int mlstm_state_scan_launch(void* work, void* scal, const void* C0,
                                       const void* n0, const void* m0,
                                       void* C1, void* n1, void* m1, int B,
                                       int H, int nc, int D, void* stream) {
  if (B <= 0 || nc <= 0) return 0;
  if (D <= 0 || D > 256 || H <= 0 || (int64_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const int DP = (D + 63) / 64 * 64;
  const int n4 = (D + 1) * DP / 4;
  const dim3 grid((n4 + THREADS - 1) / THREADS, B * H);
  mlstm_state_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)work, (float*)scal, (const float*)C0, (const float*)n0,
      (const float*)m0, (float*)C1, (float*)n1, (float*)m1, nc, D, DP);
  return (int)cudaGetLastError();
}

namespace {

cudaError_t outputs(const void* q, const void* k, const void* v,
                    const void* it, const void* ft, const void* work,
                    const void* scal, void* h, void* dot, int B, int H,
                    int T, int D, int L, int qs_b, int qs_h, int qs_t,
                    int gs_b, int gs_h, int gs_t, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (!shape_ok(B, H, T, D, L)) return cudaErrorInvalidValue;
  const int NJ = (D + 63) / 64;
  const Strides st{qs_b, qs_h, qs_t, gs_b, gs_h, gs_t};
  const dim3 grid(T / L, B * H);
  const size_t bytes = outputs_smem(D, 64 * NJ);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  auto run = [&](auto kernel) {
    err = set_smem(kernel, bytes);
    if (err == cudaSuccess)
      kernel<<<grid, THREADS, bytes, s>>>(
          (const float*)q, (const float*)k, (const float*)v,
          (const float*)it, (const float*)ft, (const float*)work,
          (const float*)scal, (float*)h, (float*)dot, H, T, D, L, st);
  };
  // dot is a template parameter, so that the serving launch compiles to
  // the kernel it was before dot existed.
  auto pick = [&](auto with_dot) {
    constexpr bool D_ = decltype(with_dot)::value;
    switch (NJ) {
      case 1: run(mlstm_chunk_outputs_kernel<1, D_>); break;
      case 2: run(mlstm_chunk_outputs_kernel<2, D_>); break;
      case 3: run(mlstm_chunk_outputs_kernel<3, D_>); break;
      default: run(mlstm_chunk_outputs_kernel<4, D_>); break;
    }
  };
  if (dot)
    pick(std::true_type{});
  else
    pick(std::false_type{});
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Pass 3. q, k, v, it, ft as pass 1 (q with k's strides); work / scal as
// pass 2 left them; h (B, T, H*D) f32 out; dot: null, or each row's
// normaliser dot_r = n_r . q_r (B, H, T) f32 out, which B7-bwd reads.
extern "C" int mlstm_chunk_outputs_launch(
    const void* q, const void* k, const void* v, const void* it,
    const void* ft, const void* work, const void* scal, void* h, void* dot,
    int B, int H, int T, int D, int L, int qs_b, int qs_h, int qs_t,
    int gs_b, int gs_h, int gs_t, void* stream) {
  return (int)outputs(q, k, v, it, ft, work, scal, h, dot, B, H, T, D, L,
                      qs_b, qs_h, qs_t, gs_b, gs_h, gs_t, stream);
}
