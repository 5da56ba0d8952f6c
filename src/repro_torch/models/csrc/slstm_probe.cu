// Probe of the sLSTM kernels' per-step exchanges, for sm_90a.
//
// B8 (slstm.cu) spreads a head's recurrent weights over the blocks of a
// thread-block cluster, so every step each block must hand its units' new
// h to every other block before any can start the next step. This probe
// runs B8's grid shape (one cluster per (b, head), `Dh` units spread over
// its ranks, one thread per unit) over T steps that do nothing else, and
// so times the exchange alone:
//
//   variant 0: B8's first design — plain stores into every rank's h
//              buffer through distributed shared memory, then a full
//              cluster barrier (release / acquire across all ranks);
//   variant 1: one-way — `st.async` into every rank's buffer, completing
//              bytes on that rank's mbarrier; each block waits on its own
//              barrier's parity and re-arms it (double-buffered h);
//   variant 2: variant 1 plus the sLSTM cell update on each unit's
//              thread (tanh, sigmoid, log-sigmoid, two exps, a division),
//              its inputs taken from the received h so that it sits on
//              the chain.
//
// B8-bwd (slstm_bwd.cu) exchanges the other way: a reduce-scatter. Every
// block holds R's columns of its own units for every row d, so its
// threads form partial sums of dh_rec[d] and store each, with `st.async`,
// into a slot of the block that owns unit d; the owner waits for CL x
// (its units) x 4 bytes on its own mbarrier and sums the CL slots.
// Variants 3-7 run that step on B8-bwd's grid (256 threads a block), each
// step's sends depending on the previous step's sums through one block
// barrier, as in the kernel:
//
//   variant 3: the reduce-scatter alone: send, wait, slot sum, block
//              barrier (the backward's latency floor);
//   variant 4: variant 3 plus B8-bwd's first dot on the chain (thread d
//              holds row d of its block's 32 units x 4 gates of R in
//              registers and reads the owner's four values a unit, four
//              chains 32 deep);
//   variant 5: variant 4 plus B8-bwd's first cell on the chain (the
//              cell's backward in precise expf / log1pf / tanhf and
//              divisions on each unit's lane after the slot sum, from a
//              record that changes every step);
//   variant 6: variant 3 plus the dot of quads (B8-bwd's design: each
//              thread 4 rows x 8 units x 4 gates, each read serving four
//              rows, the quad's sums reduce-scattered by shuffles);
//   variant 7: variant 6 plus the linear update alone on the chain (the
//              coefficients formed elsewhere): B8-bwd's chain.
//
// Variants 4-5 split the first design's step, 6-7 this design's.
// Variants 4-7 need at most 32 units a block (cluster >= Dh / 32). The
// cluster size is a launch argument (2 .. 16; above 8 needs the
// non-portable attribute and may not launch). Launched only by
// chip_smoke.py (`slstm_exchange` line): the fastest of variants 0-1 is
// B8's latency floor per step, variant 3's fastest B8-bwd's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_exchange.cuh"

namespace {

// A plain store into distributed shared memory (no completion signal).
__device__ __forceinline__ void st_cluster(uint32_t remote, float v) {
  asm volatile("st.shared::cluster.b32 [%0], %1;"
               :: "r"(remote), "r"(__float_as_uint(v)) : "memory");
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return -(fmaxf(-x, 0.0f) + log1pf(expf(-fabsf(x))));
}

template <int VARIANT>
__global__ void __launch_bounds__(1024)
slstm_probe_kernel(float* __restrict__ out, int T, int Dh, int U) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);     // 2 mbarriers
  float* hbuf = reinterpret_cast<float*>(smem + 16);      // [2][Dh]
  const uint32_t rank = cx::cluster_rank();
  const uint32_t CL = cx::cluster_size();
  const int tid = threadIdx.x;
  const int e = (int)rank * U + tid;
  const bool live = tid < U && e < Dh;
  const uint32_t bar0 = cx::smem_addr(&bars[0]);
  const uint32_t h0 = cx::smem_addr(hbuf);
  const uint32_t bytes = (uint32_t)Dh * 4;

  for (int k = tid; k < 2 * Dh; k += blockDim.x) hbuf[k] = 0.01f * k;
  if (tid == 0) {
    cx::mbar_init(bar0, 1);
    cx::mbar_init(bar0 + 8, 1);
    cx::fence_mbar_init();
    cx::mbar_expect_tx(bar0 + 8, bytes);   // step 0's stores, into buffer 1
    cx::mbar_expect_tx(bar0, bytes);       // step 1's, into buffer 0
  }
  cx::cluster_sync();

  float h = 0.0f, c = 0.0f, n = 1.0f, m = 0.0f;
  uint32_t parity = 0;   // bit b: the phase parity to wait for on barrier b
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    if (VARIANT != 0 && t > 0) {
      cx::mbar_wait(bar0 + 8 * cur, (parity >> cur) & 1);
      parity ^= 1u << cur;
      if (tid == 0) cx::mbar_expect_tx(bar0 + 8 * cur, bytes);
    }
    const float x = live ? hbuf[cur * Dh + (e + 1) % Dh] : 0.0f;
    if (VARIANT == 2) {
      const float z = tanhf(x);
      const float o = 1.0f / (1.0f + expf(x));
      const float lsf = log_sigmoid(0.3f * x + 1.0f);
      const float pi = x - 0.5f;
      const float m_new = fmaxf(lsf + m, pi);
      const float ip = expf(pi - m_new);
      const float fp = expf(lsf + m - m_new);
      c = fp * c + ip * z;
      n = fp * n + ip;
      h = o * c / fmaxf(n, 1e-6f);
      m = m_new;
    } else {
      h = 0.5f * x + 1.0f;
    }
    if (VARIANT == 0) {
      if (live)
        for (uint32_t q = 0; q < CL; ++q)
          st_cluster(cx::map_rank(h0 + 4 * ((cur ^ 1) * Dh + e), q), h);
      cx::cluster_sync();
    } else if (live && t + 1 < T) {
      const uint32_t dst = h0 + 4 * ((cur ^ 1) * Dh + e);
      const uint32_t bar = bar0 + 8 * (cur ^ 1);
      for (uint32_t q = 0; q < CL; ++q)
        cx::st_async(cx::map_rank(dst, q), h, cx::map_rank(bar, q));
    }
  }
  if (live) out[(int64_t)blockIdx.y * Dh + e] = h;
}

constexpr int BWD_THREADS = 256;   // B8-bwd's block
constexpr int BWD_UNITS = 32;      // most units a block for variants 4-7

// The step's dot: none, thread = row over 32 units (four chains), or
// quads (4 rows x 8 units a thread).
enum Dot { NO_DOT, ROW, QUAD };
// What runs on each unit's lane after the slot sum.
enum Cell { NO_CELL, PRECISE, LINEAR };

// B8-bwd's first cell (slstm_bwd.cu's first design) from a unit's record
// and the received dh_rec, in precise math: the four deltas.
struct BwdCell {
  float pz, pi, pf, po, c, n, m, dh, dc, dn, g;

  __device__ __forceinline__ float4 step(float dhr) {
    const float ft = pf + 1.0f;
    const float sgf = 1.0f / (1.0f + expf(-ft));
    const float lsf = fminf(ft, 0.0f) - log1pf(expf(-fabsf(ft)));
    const float mn = fmaxf(lsf + m, pi);
    const float ip = expf(pi - mn), fp = expf(lsf + m - mn);
    const float z = tanhf(pz);
    const float o = 1.0f / (1.0f + expf(-po));
    const float cn = fp * c + ip * z, nn = fp * n + ip;
    const float rd = 1.0f / fmaxf(nn, 1e-6f);
    const float dht = dh + dhr;
    const float dO = dht * cn * rd;
    const float dcn = dc + dht * o * rd;
    const float dnn = dn - (nn >= 1e-6f ? dht * o * cn * rd * rd : 0.0f);
    const float dz = dcn * ip;
    float dpi = (dcn * z + dnn) * ip;
    float dlsf = (dcn * c + dnn * n) * fp;
    dc = dcn * fp;
    dn = dnn * fp;
    if (lsf + m >= pi) {
      dlsf += g;
    } else {
      dpi += g;
      g = 0.0f;
    }
    return make_float4(dz * (1.0f - z * z), dpi, dlsf * (1.0f - sgf),
                       dO * o * (1.0f - o));
  }

  // B8-bwd's chain: the linear update from coefficients formed elsewhere
  // (here this step's record, as numbers).
  __device__ __forceinline__ float4 linear(float dhr) {
    const float dht = dh + dhr;
    const float dcn = fmaf(dht, pz, dc);
    const float dnn = fmaf(-dht, pi, dn);
    const float dm = fmaf(dcn, c, fmaf(dnn, n, g));
    const float4 v = make_float4(dcn * pf, fmaf(dcn, po, fmaf(dnn, m, g)),
                                 dm * pf, dht * po);
    dc = dcn * m;
    dn = dnn * m;
    return v;
  }
};

template <int DOT, int CELL>
__global__ void __launch_bounds__(BWD_THREADS, 1)
slstm_bwd_probe_kernel(float* __restrict__ out, int T, int Dh, int U) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t rank = cx::cluster_rank(), CL = cx::cluster_size();
  float* slot = reinterpret_cast<float*>(smem + 16);        // [2][CL][U]
  float4* dl = reinterpret_cast<float4*>(
      smem + 16 + ((2 * CL * U * 4 + 15) / 16) * 16);        // [2][US]
  const uint32_t bar0 = cx::smem_addr(smem);
  const uint32_t slot0 = cx::smem_addr(slot);
  const int tid = threadIdx.x;
  // dl's stride: the dots read 32 units (40 slots for the quads' padding:
  // unit j at j + j / 8).
  const int US = max(U, BWD_UNITS + 8);
  const int nlive = min(U, Dh - (int)rank * U);
  const uint32_t bytes = CL * (uint32_t)nlive * 4;
  const bool owner = tid < nlive;
  const float scale = 0.5f / (float)CL;
  const float r = 1.0f / (16.0f * (float)CL * (float)nlive);
  // The row this thread sends: its own (rows) or its quad lane's.
  const int P = (Dh + 3) / 4, quad = tid >> 2, q4 = tid & 3;
  const int row = DOT == QUAD ? quad + q4 * P : tid;
  const bool sends = DOT == QUAD ? quad < P && row < Dh : tid < Dh;
  const int dst_rank = sends ? row / U : 0, dst_idx = row - dst_rank * U;

  // R's values, small enough that the recurrence stays bounded: a row's
  // 32 units x 4 gates, or a quad lane's 4 rows x 8 units x 4 gates.
  float R[DOT == NO_DOT ? 1 : BWD_UNITS][4];
#pragma unroll
  for (int j = 0; j < (DOT == NO_DOT ? 1 : BWD_UNITS); ++j)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      R[j][g] = (DOT == QUAD ? quad < P && q4 * 8 + (j & 7) < nlive
                             : tid < Dh && j < nlive)
                    ? ((tid + j + g) & 1 ? r : -r) : 0.0f;
  BwdCell cell{0.3f, -0.2f, 0.5f, 0.1f, 0.4f, 1.2f, -0.1f,
               0.01f * (tid & 31), 0.05f, -0.02f, 0.1f};
  for (int k = tid; k < 2 * US; k += BWD_THREADS)
    dl[k] = make_float4(0.01f * k, 0.0f, 0.0f, 0.0f);
  if (tid == 0) {
    cx::mbar_init(bar0, 1);
    cx::mbar_init(bar0 + 8, 1);
    cx::fence_mbar_init();
    cx::mbar_expect_tx(bar0, bytes);
    cx::mbar_expect_tx(bar0 + 8, bytes);
  }
  cx::cluster_sync();

  uint32_t parity = 0;
  float s = 0.0f;
  for (int t = 0; t <= T; ++t) {
    const int cur = t & 1;
    if (t > 0 && owner) {
      cx::mbar_wait(bar0 + 8 * cur, (parity >> cur) & 1);
      parity ^= 1u << cur;
      if (tid == 0) cx::mbar_expect_tx(bar0 + 8 * cur, bytes);
      s = 0.0f;
      for (uint32_t q = 0; q < CL; ++q) s += slot[(cur * CL + q) * U + tid];
      if (CELL != NO_CELL) {
        // A record that changes every step, as the kernel's does, so
        // that none of the cell's math is hoisted out of the loop.
        const float x = 0.01f * (float)(t & 31);
        cell.pz = 0.3f + x;
        cell.pi = x - 0.2f;
        cell.pf = 0.5f - x;
        cell.po = 0.1f + 0.5f * x;
        cell.c = 0.4f - x;
        cell.n = 1.2f + x;
        cell.m = 2.0f * x - 0.1f;
      }
      const float4 v = CELL == PRECISE  ? cell.step(s)
                       : CELL == LINEAR ? cell.linear(s)
                                        : make_float4(s, -0.5f * s,
                                                      0.25f * s, s);
      dl[cur * US + (DOT == QUAD ? tid + tid / 8 : tid)] = v;
    }
    if (t == T) break;   // the last step's partials: received, not sent
    __syncthreads();
    const float4* dc4 = dl + cur * US;
    float v = 0.25f;
    if (DOT == NO_DOT) {
      v = fmaf(dc4[dst_idx].x, scale, 0.25f);
    } else if (DOT == QUAD) {
      {
        float a[4][4] = {};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 x = dc4[q4 * 9 + j];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            a[rr][0] = fmaf(R[rr * 8 + j][0], x.x, a[rr][0]);
            a[rr][1] = fmaf(R[rr * 8 + j][1], x.y, a[rr][1]);
            a[rr][2] = fmaf(R[rr * 8 + j][2], x.z, a[rr][2]);
            a[rr][3] = fmaf(R[rr * 8 + j][3], x.w, a[rr][3]);
          }
        }
        float sr[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
          sr[rr] = (a[rr][0] + a[rr][1]) + (a[rr][2] + a[rr][3]);
        const bool b0 = q4 & 1, b1 = q4 & 2;
        float k0 = b0 ? sr[1] : sr[0], k1 = b0 ? sr[3] : sr[2];
        k0 += __shfl_xor_sync(0xffffffffu, b0 ? sr[0] : sr[1], 1);
        k1 += __shfl_xor_sync(0xffffffffu, b0 ? sr[2] : sr[3], 1);
        v = (b1 ? k1 : k0) + __shfl_xor_sync(0xffffffffu, b1 ? k0 : k1, 2) +
            0.25f;
      }
    } else if (sends) {
      float a[4] = {};
#pragma unroll
      for (int j = 0; j < BWD_UNITS; ++j) {
        const float4 x = dc4[j];
        a[0] = fmaf(R[j][0], x.x, a[0]);
        a[1] = fmaf(R[j][1], x.y, a[1]);
        a[2] = fmaf(R[j][2], x.z, a[2]);
        a[3] = fmaf(R[j][3], x.w, a[3]);
      }
      v = (a[0] + a[1]) + (a[2] + a[3]) + 0.25f;
    }
    if (sends) {
      const uint32_t dst =
          slot0 + 4 * (((cur ^ 1) * CL + rank) * U + dst_idx);
      cx::st_async(cx::map_rank(dst, dst_rank), v,
                   cx::map_rank(bar0 + 8 * (cur ^ 1), dst_rank));
    }
    // dl is double-buffered as in the kernel: the owners write buffer
    // cur again two steps on, after a block barrier that every reader of
    // this step's buffer has passed.
  }
  if (owner) out[(int64_t)blockIdx.y * Dh + (int)rank * U + tid] = s;
}

template <int DOT, int CELL>
int launch_bwd(int cluster, int BH, int Dh, int T, float* o, size_t smem,
               cudaStream_t s, int U) {
  return (int)cx::launch_clustered(slstm_bwd_probe_kernel<DOT, CELL>,
                                   cluster, BH, BWD_THREADS, smem, s, o, T,
                                   Dh, U);
}

}  // namespace

// out: (BH, Dh) f32, the last h (variants 0-2) or the last slot sum
// (variants 3-7) of each unit. Returns a cudaError_t code.
extern "C" int slstm_probe_launch(int variant, int cluster, int BH, int Dh,
                                  int T, void* out, void* stream) {
  if (cluster < 1 || cluster > 16 || BH <= 0 || Dh <= 0 || T <= 0 ||
      variant < 0 || variant > 7)
    return (int)cudaErrorInvalidValue;
  const int U = (Dh + cluster - 1) / cluster;
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
  if (variant >= 3) {
    if (Dh > BWD_THREADS || (variant >= 4 && U > BWD_UNITS))
      return (int)cudaErrorInvalidValue;
    const size_t smem = 16 + ((2 * (size_t)cluster * U * 4 + 15) / 16) * 16
                        + 2 * (size_t)max(U, BWD_UNITS + 8) * 16;
    switch (variant) {
      case 3: return launch_bwd<NO_DOT, NO_CELL>(cluster, BH, Dh, T, o, smem,
                                                 s, U);
      case 4: return launch_bwd<ROW, NO_CELL>(cluster, BH, Dh, T, o, smem, s,
                                              U);
      case 5: return launch_bwd<ROW, PRECISE>(cluster, BH, Dh, T, o, smem, s,
                                              U);
      case 6: return launch_bwd<QUAD, NO_CELL>(cluster, BH, Dh, T, o, smem, s,
                                               U);
      default: return launch_bwd<QUAD, LINEAR>(cluster, BH, Dh, T, o, smem,
                                               s, U);
    }
  }
  const int threads = (U + 31) / 32 * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = 16 + 2 * (size_t)Dh * sizeof(float);
  switch (variant) {
    case 0:
      return (int)cx::launch_clustered(slstm_probe_kernel<0>, cluster, BH,
                                       threads, smem, s, o, T, Dh, U);
    case 1:
      return (int)cx::launch_clustered(slstm_probe_kernel<1>, cluster, BH,
                                       threads, smem, s, o, T, Dh, U);
    default:
      return (int)cx::launch_clustered(slstm_probe_kernel<2>, cluster, BH,
                                       threads, smem, s, o, T, Dh, U);
  }
}
