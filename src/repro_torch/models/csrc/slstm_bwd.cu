// Backward of the sLSTM recurrence (B8-bwd), for sm_90a.
//
// Replaces no kernel of the JAX package: the reference differentiates the
// `lax.scan` of `slstm_step` (src/repro/models/xlstm.py:198, scan at :233)
// with `jax.grad`. It is the backward of B8 (slstm.cu), behind
// `SLSTMScan` in xlstm.py. Per (b, head), backwards in time, from the
// record B8's forward writes when asked (per step the pre-activations
// pz, pi, pf, po and the new c, n, m) and the output's gradient dh:
//
//   f~ = pf + 1, m' = max(log_sigmoid(f~) + m, pi)   (m: the step's input)
//   i' = exp(pi - m'), f' = exp(log_sigmoid(f~) + m - m')
//   z = tanh(pz), o = sigmoid(po), c' = f' c + i' z, n' = f' n + i'
//   dh_t = dh[t] + dh_rec;  do = dh_t c' / n';  dc' = dc + dh_t o / n'
//   dn' = dn - dh_t o c' / n'^2;  dz = dc' i';  di' = dc' z + dn'
//   dlsf = (dc' c + dn' n) f';  dpi = di' i';  dc = dc' f', dn = dn' f'
//   delta = (dz (1 - z^2), dpi, dlsf sigmoid(-f~), do o (1 - o))
//   dh_rec[d] (for step t - 1) = sum_g sum_e R_g[d, e] delta_g[e]
//
// with m' held constant: the output does not depend on the stabiliser's
// value (xlstm.py's note on B8-bwd), and the gauge part of a final-state
// gradient, g = dm1 - dc1 c1 - dn1 n1, flows back through the maxes:
// where log_sigmoid(f~) + m wins, dlsf += g and g carries on to the step
// before; where pi wins, dpi += g and g stops. delta is written per step
// (f32, B x T x 4 x H Dh); dR_g = sum_t h_{t-1} delta_g^T is one batched
// product after the kernel (xlstm.py).
//
// What bounds it on an H100: the chain of steps, as the forward. Per (b,
// head, step) 8 Dh^2 FLOP of the recurrent product and ~40 Dh of the cell;
// the bytes (the 7-row record, dh and delta, 12 floats per unit and step)
// are read and written once. A step's latency is the exchange of dh_rec
// plus the cell, so the design keeps that chain short.
//
// Design. The forward's cluster: CL = ceil(Dh / 32) blocks per (b, head)
// (`slstm_cluster` in xlstm.py passes it), block r owns units [r U, (r+1)
// U), U = ceil(Dh / CL), one unit per lane of warp 0. Where the forward
// all-gathers h, the backward reduce-scatters dh_rec: block r holds, in
// registers, R_g[d, e] for its own units e and every row d (thread d owns
// row d: 4 U <= 128 registers), forms the partial sum of dh_rec[d] over
// its own units, and stores it into the block that owns unit d, one slot
// per sender: slot[buffer][sender][d - owner U], with `st.async`, which
// completes 4 bytes on that block's mbarrier. `red.async` into distributed
// shared memory adds integers only, so no float add is in flight; the
// owner's warp 0 sums its CL slots. The same bytes a step as the forward's
// all-gather: Dh floats out of each block. Each step:
//
//   1. warp 0 waits for the CL partials of each of its units (the step's
//      buffer, one mbarrier per buffer, re-armed as soon as the wait
//      returns), sums them, and runs the cell's backward above, lane =
//      unit; writes delta and puts it in shared memory (two buffers);
//   2. one block barrier;
//   3. thread d forms its partial sum from the four delta of each unit
//      (float4 broadcast reads) and its registers, and stores it into the
//      owner's buffer of the next step.
//
// The one-way argument of slstm.cu carries over: a store into a block's
// buffer (t - 1) % 2 is sent from delta(t), which needs that block's own
// partial from delta(t + 1), which the block formed only after its warp 0
// had summed buffer (t + 1) % 2 and re-armed its barrier; so no store
// lands in a buffer still being read, and no byte of a barrier's next
// phase arrives before the phase it follows has completed. After step 0
// every block waits for the partials of step -1 (its dh0), so every store
// into a block lands before it exits. The delta buffer in shared memory is
// double-buffered for the same reason: warp 0 writes delta(t - 1) only
// after the partials of delta(t) from every block, its own threads'
// included, have arrived, and the block barrier of step t - 1 holds the
// other warps until they are done reading delta(t).
//
// warp 0's inputs of step t - 1 (the record, the state before it, dh) are
// loaded while step t's exchange is in flight, and pulled into L2
// `PREFETCH` steps ahead. The cell uses expf, log1pf and tanhf (not the
// forward's fast intrinsics): the exchange, not the cell, sets a step's
// time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_exchange.cuh"

namespace {

constexpr int THREADS = 256;    // one thread per row d: Dh <= 256
constexpr int MAX_UNITS = 32;   // units per block: one per lane of warp 0
constexpr int MAX_CL = 8;       // blocks per cluster: Dh <= 256
constexpr int SAVED = 7;        // rows of the forward's record per step
constexpr int PREFETCH = 16;    // steps ahead that inputs are pulled into L2

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// warp 0's inputs of one step: its record, the state before it, dh.
struct StepIn {
  float pz, pi, pf, po, c, n, m, dh;
};

__device__ __forceinline__ StepIn load_step(
    const float* __restrict__ saved, const float* __restrict__ dh,
    const float* __restrict__ c0, const float* __restrict__ n0,
    const float* __restrict__ m0, int64_t bt, int64_t D, int64_t col,
    int64_t sb, int t) {
  const float* rec = saved + bt * SAVED * D + col;
  StepIn in;
  in.pz = rec[0];
  in.pi = rec[D];
  in.pf = rec[2 * D];
  in.po = rec[3 * D];
  if (t > 0) {
    const float* prev = rec - SAVED * D;
    in.c = prev[4 * D];
    in.n = prev[5 * D];
    in.m = prev[6 * D];
  } else {
    in.c = c0[sb];
    in.n = n0[sb];
    in.m = m0[sb];
  }
  in.dh = dh[bt * D + col];
  return in;
}

template <typename TR>
__global__ void __launch_bounds__(THREADS, 1)
slstm_bwd_kernel(const TR* __restrict__ rz, const TR* __restrict__ ri,
                 const TR* __restrict__ rf, const TR* __restrict__ ro,
                 const float* __restrict__ c0, const float* __restrict__ n0,
                 const float* __restrict__ m0,
                 const float* __restrict__ saved,
                 const float* __restrict__ dh, const float* __restrict__ dh1,
                 const float* __restrict__ dc1,
                 const float* __restrict__ dn1,
                 const float* __restrict__ dm1, float* __restrict__ delta,
                 float* __restrict__ dh0, float* __restrict__ dc0,
                 float* __restrict__ dn0, float* __restrict__ dm0, int T,
                 int H, int Dh, int U) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* slot = reinterpret_cast<float*>(smem + 16);  // [2][MAX_CL][32]
  float4* dl = reinterpret_cast<float4*>(
      smem + 16 + 2 * MAX_CL * MAX_UNITS * 4);        // [2][32]
  const uint32_t bar0 = cx::smem_addr(smem);           // 2 mbarriers
  const uint32_t slot0 = cx::smem_addr(slot);
  const uint32_t rank = cx::cluster_rank(), CL = cx::cluster_size();
  const int nlive = min(U, Dh - (int)rank * U);        // this block's units
  const uint32_t bytes = CL * (uint32_t)nlive * 4;

  const int bh = blockIdx.y;
  const int head = bh % H, b = bh / H;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int64_t D = (int64_t)H * Dh;

  // Thread d: row d of this block's units' four R columns, zero past them.
  const int d = tid;
  const bool drow = d < Dh;
  float R[MAX_UNITS][4];
  {
    const TR* Rg[4] = {rz, ri, rf, ro};
    const int64_t row = ((int64_t)head * Dh + d) * Dh + (int64_t)rank * U;
#pragma unroll
    for (int j = 0; j < MAX_UNITS; ++j)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        R[j][g] = drow && j < nlive ? to_f32(Rg[g][row + j]) : 0.0f;
  }
  const int dst_rank = drow ? d / U : 0, dst_idx = d - dst_rank * U;
  for (int i = tid; i < 2 * MAX_UNITS; i += THREADS)
    dl[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tid == 0) {
    cx::mbar_init(bar0, 1);
    cx::mbar_init(bar0 + 8, 1);
    cx::fence_mbar_init();
    cx::mbar_expect_tx(bar0, bytes);
    cx::mbar_expect_tx(bar0 + 8, bytes);
  }

  const bool cell_lane = w == 0 && lane < nlive;
  const int e = (int)rank * U + lane;
  const int64_t col = (int64_t)head * Dh + e;
  const int64_t sb = (int64_t)bh * Dh + e;
  float dc = 0.0f, dn = 0.0f, g = 0.0f, dm = 0.0f, dhr = 0.0f;
  StepIn in{};
  if (cell_lane) {
    dc = dc1 ? dc1[sb] : 0.0f;
    dn = dn1 ? dn1[sb] : 0.0f;
    dhr = dh1 ? dh1[sb] : 0.0f;
    const float* last = saved + ((int64_t)b * T + T - 1) * SAVED * D + col;
    g = (dm1 ? dm1[sb] : 0.0f) - dc * last[4 * D] - dn * last[5 * D];
    in = load_step(saved, dh, c0, n0, m0, (int64_t)b * T + T - 1, D, col,
                   sb, T - 1);
  }
  cx::cluster_sync();   // every block running, every barrier armed

  uint32_t parity = 0;  // bit j: the phase parity to wait for on barrier j
  for (int t = T - 1; t >= 0; --t) {
    const int cur = t & 1, nxt = cur ^ 1;
    if (w == 0) {
      if (t < T - 1) {
        cx::mbar_wait(bar0 + 8 * cur, (parity >> cur) & 1);
        parity ^= 1u << cur;
        if (lane == 0) cx::mbar_expect_tx(bar0 + 8 * cur, bytes);
        if (cell_lane) {
          float s = 0.0f;
          for (uint32_t q = 0; q < CL; ++q)
            s += slot[(cur * MAX_CL + q) * MAX_UNITS + lane];
          dhr = s;
        }
      }
      if (cell_lane) {
        const float ft = in.pf + 1.0f;
        const float sgf = 1.0f / (1.0f + expf(-ft));
        const float lsf = fminf(ft, 0.0f) - log1pf(expf(-fabsf(ft)));
        const float mn = fmaxf(lsf + in.m, in.pi);
        const float ip = expf(in.pi - mn), fp = expf(lsf + in.m - mn);
        const float z = tanhf(in.pz);
        const float o = 1.0f / (1.0f + expf(-in.po));
        const float cn = fp * in.c + ip * z, nn = fp * in.n + ip;
        const float rd = 1.0f / fmaxf(nn, 1e-6f);
        const float dht = in.dh + dhr;
        const float dO = dht * cn * rd;
        const float dcn = dc + dht * o * rd;
        const float dnn = dn - (nn >= 1e-6f ? dht * o * cn * rd * rd : 0.0f);
        const float dz = dcn * ip;
        float dpi = (dcn * z + dnn) * ip;
        float dlsf = (dcn * in.c + dnn * in.n) * fp;
        dc = dcn * fp;
        dn = dnn * fp;
        if (lsf + in.m >= in.pi) {
          dlsf += g;
        } else {
          dpi += g;
          g = 0.0f;
        }
        dm = dlsf;
        const float4 dv = make_float4(dz * (1.0f - z * z), dpi,
                                      dlsf * (1.0f - sgf),
                                      dO * o * (1.0f - o));
        dl[cur * MAX_UNITS + lane] = dv;
        float* out = delta + ((int64_t)b * T + t) * 4 * D + col;
        out[0] = dv.x;
        out[D] = dv.y;
        out[2 * D] = dv.z;
        out[3 * D] = dv.w;
        if (t > 0)
          in = load_step(saved, dh, c0, n0, m0, (int64_t)b * T + t - 1, D,
                         col, sb, t - 1);
        if (t - PREFETCH >= 0) {
          const int64_t bt = (int64_t)b * T + t - PREFETCH;
          const float* rec = saved + bt * SAVED * D + col;
#pragma unroll
          for (int k = 0; k < SAVED; ++k)
            asm volatile("prefetch.global.L2 [%0];" :: "l"(rec + k * D));
          asm volatile("prefetch.global.L2 [%0];" :: "l"(dh + bt * D + col));
        }
      }
    }
    __syncthreads();
    if (drow) {
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
      const float4* dc4 = dl + cur * MAX_UNITS;
#pragma unroll
      for (int j = 0; j < MAX_UNITS; ++j) {
        const float4 v = dc4[j];
        s0 = fmaf(R[j][0], v.x, s0);
        s1 = fmaf(R[j][1], v.y, s1);
        s2 = fmaf(R[j][2], v.z, s2);
        s3 = fmaf(R[j][3], v.w, s3);
      }
      const uint32_t dst =
          slot0 + 4 * ((nxt * MAX_CL + rank) * MAX_UNITS + dst_idx);
      cx::st_async(cx::map_rank(dst, dst_rank), (s0 + s1) + (s2 + s3),
                   cx::map_rank(bar0 + 8 * nxt, dst_rank));
    }
  }
  // Step -1: the partials of delta(0) are dh0.
  if (w == 0) {
    cx::mbar_wait(bar0 + 8, (parity >> 1) & 1);
    if (cell_lane) {
      float s = 0.0f;
      for (uint32_t q = 0; q < CL; ++q)
        s += slot[(MAX_CL + q) * MAX_UNITS + lane];
      dh0[sb] = s;
      dc0[sb] = dc;
      dn0[sb] = dn;
      dm0[sb] = dm;
    }
  }
}

size_t smem_bytes() {
  return 16 + 2 * MAX_CL * MAX_UNITS * 4 + 2 * MAX_UNITS * 16;
}

bool shape_ok(int B, int H, int Dh, int cluster) {
  return B > 0 && H > 0 && Dh > 0 && Dh <= THREADS &&
         (int64_t)B * H <= 65535 &&
         cluster == (Dh + MAX_UNITS - 1) / MAX_UNITS;
}

}  // namespace

// rz, ri, rf, ro: (H, Dh, Dh) in the R type (rdtype 0 f32, 1 bf16); c0,
// n0, m0 (B, H, Dh) f32, the initial state; saved (B, T, 7, H*Dh) f32, the
// forward's record; dh (B, T, H*Dh) f32; dh1, dc1, dn1, dm1 (B, H, Dh)
// f32, the final state's gradients, each may be null (zero). delta (B, T,
// 4, H*Dh) f32 and dh0, dc0, dn0, dm0 (B, H, Dh) f32 out. cluster: blocks
// per (b, head), ceil(Dh / 32), as the forward.
extern "C" int slstm_bwd_launch(
    const void* rz, const void* ri, const void* rf, const void* ro,
    const void* c0, const void* n0, const void* m0, const void* saved,
    const void* dh, const void* dh1, const void* dc1, const void* dn1,
    const void* dm1, void* delta, void* dh0, void* dc0, void* dn0, void* dm0,
    int B, int T, int H, int Dh, int rdtype, int cluster, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (!shape_ok(B, H, Dh, cluster)) return (int)cudaErrorInvalidValue;
  const int U = (Dh + cluster - 1) / cluster;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto kernel, auto r) {
    using TRp = decltype(r);
    return cx::launch_clustered(
        kernel, cluster, B * H, THREADS, smem_bytes(), s, (TRp)rz, (TRp)ri,
        (TRp)rf, (TRp)ro, (const float*)c0, (const float*)n0,
        (const float*)m0, (const float*)saved, (const float*)dh,
        (const float*)dh1, (const float*)dc1, (const float*)dn1,
        (const float*)dm1, (float*)delta, (float*)dh0, (float*)dc0,
        (float*)dn0, (float*)dm0, T, H, Dh, U);
  };
  switch (rdtype) {
    case 0:
      return (int)run(slstm_bwd_kernel<float>, (const float*)nullptr);
    case 1:
      return (int)run(slstm_bwd_kernel<__nv_bfloat16>,
                      (const __nv_bfloat16*)nullptr);
  }
  return (int)cudaErrorInvalidValue;
}

// How many clusters of B8-bwd (f32 R) at head size Dh the card runs at
// once (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int slstm_bwd_max_clusters(int Dh, int cluster, int* out) {
  if (!shape_ok(1, 1, Dh, cluster)) return (int)cudaErrorInvalidValue;
  auto kernel = slstm_bwd_kernel<float>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes());
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes();
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, (void*)kernel, &cfg);
}
