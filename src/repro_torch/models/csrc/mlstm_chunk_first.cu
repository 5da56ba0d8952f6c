// Chunkwise mLSTM (B7), first design, for sm_90a.
//
// On no route since its redesign (mlstm_chunk.cu): built and held against
// the plain version and timed beside the new design by chip_smoke.py
// only.
//
// Replaces the chunk loop of `mlstm_chunkwise` in src/repro/models/xlstm.py
// (a `lax.scan` over chunks, `cummax` inside). Per (b, head) a carried
// state C (D x D), n (D), m; per chunk of L steps, with b = cumsum(f~),
// w = i~ - b, g = cummax(w), M_r = max(m, g_r):
//
//   P[r,s]  = (s <= r) exp(w_s - M_r) (q_r . k_s)
//   h~_r    = exp(m - M_r) (q_r C) + sum_s P[r,s] v_s
//   dot_r   = exp(m - M_r) (n . q_r) + sum_s P[r,s]
//   h_r     = h~_r / max(|dot_r|, exp(-(b_r + M_r)))
//   C' = exp(m - M_c) C + sum_s exp(w_s - M_c) k_s v_s^T,  n' likewise,
//   m' = b_last + M_c.
//
// (dot_r is the reference's n_r . q_r with the intra-chunk part
// reassociated: (sum_s Dw[r,s] k_s) . q_r = sum_s Dw[r,s] (k_s . q_r),
// which reuses P instead of a second L x L x D product.) All f32.
//
// Design. One block per (b, head, block of VB = 32 columns of v). It loops
// over the chunks and keeps its D x VB slice of C in shared memory for the
// whole sequence: at D = 192 the whole C (147 KB) and the q, k chunk tiles
// (48 KB each) would not fit one SM's 227 KB, so C's v dimension is split
// across blocks and each block recomputes the chunk's L x L weights P, the
// scan of the gates and n (cheap beside the v-block products). Shared
// memory: q and k tiles transposed (D x 65: a row stride of 65 floats keeps
// both the column writes and the row reads free of bank conflicts), the v
// tile, C's slice, P transposed, n and the per-row scalars: 157 KB at
// D = 192. The gate scans (cumsum, cummax over L <= 64) run in warp 0, two
// steps a lane, by shuffles.
//
// What bounds it on an H100: operations, and this first design is far from
// them. Per chunk and block: 2 L^2 D (P) + 2 L D VB (q C) + L^2 VB (P v) +
// 2 L D VB (C update) FLOP on the FMA units in f32, with every operand read
// from shared memory; xlstm-125m (B 1, 4 heads, D 192) fills 24 blocks, a
// fifth of the SMs. The least traffic (q, k, v, gates in, h out, f32) is
// 16 D + 8 bytes per (b, head, step).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VB = 32;
constexpr int LMAX = 64;
constexpr int LP = LMAX + 1;   // row stride of the transposed tiles
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  float* qT;      // D x LP
  float* kT;      // D x LP
  float* vs;      // LMAX x VB
  float* Cs;      // D x VB
  float* PT;      // LMAX x LP   (P transposed: PT[s][r])
  float* n;       // D
  float* iv;      // LMAX: i~ of the chunk
  float* fv;      // LMAX: f~
  float* bvec;    // cumsum(f~)
  float* wvec;    // i~ - b
  float* Mvec;    // max(m, cummax(w))
  float* scale;   // exp(m - M_r)
  float* decay;   // exp(w_s - M_c)
  float* qn;      // n . q_r
  float* rowsum;  // sum_s P[r,s]
};

__host__ __device__ inline size_t smem_floats(int D) {
  return (size_t)2 * D * LP + LMAX * VB + (size_t)D * VB + LMAX * LP + D +
         10 * LMAX;
}

__device__ inline Smem carve(float* base, int D) {
  Smem s;
  float* p = base;
  s.qT = p; p += (size_t)D * LP;
  s.kT = p; p += (size_t)D * LP;
  s.vs = p; p += LMAX * VB;
  s.Cs = p; p += (size_t)D * VB;
  s.PT = p; p += LMAX * LP;
  s.n = p; p += D;
  s.iv = p; p += LMAX;
  s.fv = p; p += LMAX;
  s.bvec = p; p += LMAX;
  s.wvec = p; p += LMAX;
  s.Mvec = p; p += LMAX;
  s.scale = p; p += LMAX;
  s.decay = p; p += LMAX;
  s.qn = p; p += LMAX;
  s.rowsum = p; p += LMAX;
  return s;
}

__global__ void __launch_bounds__(THREADS)
mlstm_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ ig,
                   const float* __restrict__ fg, const float* __restrict__ C0,
                   const float* __restrict__ n0, const float* __restrict__ m0,
                   float* __restrict__ hout, float* __restrict__ C1,
                   float* __restrict__ n1, float* __restrict__ m1, int H,
                   int T, int D, int L, int64_t qs_b, int64_t qs_h,
                   int64_t qs_t, int64_t gs_b, int64_t gs_h, int64_t gs_t) {
  extern __shared__ float smem_raw[];
  const Smem sm = carve(smem_raw, D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v0 = blockIdx.x * VB;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int nv = min(VB, D - v0);   // live columns of this block

  const float* qb = q + b * qs_b + h * qs_h;
  const float* kb = k + b * qs_b + h * qs_h;
  const float* vb = v + b * qs_b + h * qs_h;
  const float* ib = ig + b * gs_b + h * gs_h;
  const float* fb = fg + b * gs_b + h * gs_h;

  // Carried state: C's slice, n, m (m in a register of every thread).
  for (int idx = tid; idx < D * VB; idx += THREADS) {
    const int d = idx / VB, j = idx % VB;
    sm.Cs[idx] = j < nv ? C0[((int64_t)bh * D + d) * D + v0 + j] : 0.0f;
  }
  for (int d = tid; d < D; d += THREADS) sm.n[d] = n0[(int64_t)bh * D + d];
  float m = m0[bh];

  const int nc = T / L;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * L;
    // ---- 1. the chunk's tiles ----
    for (int idx = tid; idx < L * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const int64_t g = (int64_t)(t0 + r) * qs_t + d;
      sm.qT[d * LP + r] = qb[g];
      sm.kT[d * LP + r] = kb[g];
    }
    for (int idx = tid; idx < L * VB; idx += THREADS) {
      const int s = idx / VB, j = idx % VB;
      sm.vs[idx] = j < nv ? vb[(int64_t)(t0 + s) * qs_t + v0 + j] : 0.0f;
    }
    for (int r = tid; r < L; r += THREADS) {
      sm.iv[r] = ib[(int64_t)(t0 + r) * gs_t];
      sm.fv[r] = fb[(int64_t)(t0 + r) * gs_t];
    }
    __syncthreads();

    // ---- 2. warp 0: the gate scans; warps 1..: n . q_r ----
    if (warp == 0) {
      const int s0 = 2 * lane, s1 = 2 * lane + 1;
      const bool ok0 = s0 < L, ok1 = s1 < L;
      const float f0 = ok0 ? sm.fv[s0] : 0.0f, f1 = ok1 ? sm.fv[s1] : 0.0f;
      const float a0 = f0, a1 = f0 + f1;
      float x = a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(FULL, x, off);
        if (lane >= off) x += y;
      }
      float excl = __shfl_up_sync(FULL, x, 1);
      if (lane == 0) excl = 0.0f;
      const float b0 = excl + a0, b1 = excl + a1;
      const float w0 = ok0 ? sm.iv[s0] - b0 : -INFINITY;
      const float w1 = ok1 ? sm.iv[s1] - b1 : -INFINITY;
      const float mx1 = fmaxf(w0, w1);
      float mx = mx1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(FULL, mx, off);
        if (lane >= off) mx = fmaxf(mx, y);
      }
      float mexcl = __shfl_up_sync(FULL, mx, 1);
      if (lane == 0) mexcl = -INFINITY;
      const float g0 = fmaxf(mexcl, w0), g1 = fmaxf(mexcl, mx1);
      if (ok0) {
        sm.bvec[s0] = b0; sm.wvec[s0] = w0; sm.Mvec[s0] = fmaxf(m, g0);
      }
      if (ok1) {
        sm.bvec[s1] = b1; sm.wvec[s1] = w1; sm.Mvec[s1] = fmaxf(m, g1);
      }
      __syncwarp();
      const float Mc = sm.Mvec[L - 1];
      for (int r = lane; r < L; r += 32) {
        sm.scale[r] = expf(m - sm.Mvec[r]);
        sm.decay[r] = expf(sm.wvec[r] - Mc);
      }
    } else {
      for (int r = warp - 1; r < L; r += WARPS - 1) {
        float acc = 0.0f;
        for (int d = lane; d < D; d += 32) acc += sm.n[d] * sm.qT[d * LP + r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_xor_sync(FULL, acc, off);
        if (lane == 0) sm.qn[r] = acc;
      }
    }
    __syncthreads();

    // ---- 3. P = mask * exp(w_s - M_r) * (q_r . k_s), and its row sums ----
    {
      const int rt = tid >> 4, st = tid & 15;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sm.qT[d * LP + rt + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = sm.kT[d * LP + st + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += qv[i] * kv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rt + 16 * i;
        float rs = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = st + 16 * j;
          float p = 0.0f;
          if (r < L && s <= r) p = expf(sm.wvec[s] - sm.Mvec[r]) * acc[i][j];
          if (s < LMAX) sm.PT[s * LP + r] = p;
          rs += p;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          rs += __shfl_xor_sync(FULL, rs, off);
        if (st == 0 && r < L) sm.rowsum[r] = rs;
      }
    }
    __syncthreads();

    // ---- 4. h for this block's columns ----
    {
      const int j = lane;
      for (int r = warp; r < L; r += WARPS) {
        float inter = 0.0f;
        for (int d = 0; d < D; ++d)
          inter += sm.qT[d * LP + r] * sm.Cs[d * VB + j];
        float intra = 0.0f;
        for (int s = 0; s <= r; ++s) intra += sm.PT[s * LP + r] * sm.vs[s * VB + j];
        const float sc = sm.scale[r];
        const float ht = inter * sc + intra;
        const float dot = sc * sm.qn[r] + sm.rowsum[r];
        const float den = fmaxf(fabsf(dot), expf(-(sm.bvec[r] + sm.Mvec[r])));
        if (j < nv)
          hout[((int64_t)b * T + t0 + r) * H * D + (int64_t)h * D + v0 + j] =
              ht / den;
      }
    }
    __syncthreads();

    // ---- 5. the chunk-end state ----
    {
      const float Mc = sm.Mvec[L - 1];
      const float carry = expf(m - Mc);
      const int j = lane;
      for (int d0 = warp; d0 < D; d0 += WARPS * 8) {
        float acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
        for (int s = 0; s < L; ++s) {
          const float vd = sm.decay[s] * sm.vs[s * VB + j];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int d = d0 + WARPS * i;
            if (d < D) acc[i] += sm.kT[d * LP + s] * vd;
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int d = d0 + WARPS * i;
          if (d < D) sm.Cs[d * VB + j] = carry * sm.Cs[d * VB + j] + acc[i];
        }
      }
      for (int d = tid; d < D; d += THREADS) {
        float acc = 0.0f;
        for (int s = 0; s < L; ++s) acc += sm.decay[s] * sm.kT[d * LP + s];
        sm.n[d] = carry * sm.n[d] + acc;
      }
      m = sm.bvec[L - 1] + Mc;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < D * VB; idx += THREADS) {
    const int d = idx / VB, j = idx % VB;
    if (j < nv) C1[((int64_t)bh * D + d) * D + v0 + j] = sm.Cs[idx];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < D; d += THREADS) n1[(int64_t)bh * D + d] = sm.n[d];
    if (tid == 0) m1[bh] = m;
  }
}

}  // namespace

// q, k, v: f32 with element (b, h, t, d) at b*qs_b + h*qs_h + t*qs_t + d;
// it, ft: f32 at b*gs_b + h*gs_h + t*gs_t. State C (B,H,D,D), n (B,H,D),
// m (B,H) in, C1 / n1 / m1 out; h (B, T, H*D) out. T % L == 0, L <= 64.
extern "C" int mlstm_chunk_first_launch(
    const void* q, const void* k, const void* v, const void* it,
    const void* ft, const void* C0, const void* n0, const void* m0, void* h,
    void* C1, void* n1, void* m1, int B, int H, int T, int D, int L,
    int qs_b, int qs_h, int qs_t, int gs_b, int gs_h, int gs_t,
    void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (L <= 0 || L > LMAX || T % L != 0 || D <= 0 || D > 256 || H <= 0 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D + VB - 1) / VB, H, B);
  mlstm_chunk_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)it,
      (const float*)ft, (const float*)C0, (const float*)n0, (const float*)m0,
      (float*)h, (float*)C1, (float*)n1, (float*)m1, H, T, D, L, qs_b, qs_h,
      qs_t, gs_b, gs_h, gs_t);
  return (int)cudaGetLastError();
}
