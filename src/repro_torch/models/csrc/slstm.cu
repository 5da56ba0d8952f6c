// sLSTM recurrence (B8), for sm_90a.
//
// Replaces `slstm_apply` of src/repro/models/xlstm.py (a `lax.scan` over T
// of `slstm_step`). Per (b, head) with state h, c, n, m (Dh each, f32) and
// recurrent weights R_g (Dh x Dh) of the four gates g = z, i, f, o:
//
//   pre_g = wx_g[t] + h_{t-1} R_g
//   z = tanh(pre_z), i~ = pre_i, f~ = pre_f + 1, o = sigmoid(pre_o)
//   m' = max(log_sigmoid(f~) + m, i~)
//   i' = exp(i~ - m'), f' = exp(log_sigmoid(f~) + m - m')
//   c' = f' c + i' z,  n' = f' n + i',  h' = o c' / max(n', 1e-6)
//
// Strictly sequential in t: every step needs all of h_{t-1}.
//
// What bounds it on an H100: the chain of steps. Neither the bytes (R
// once, wx once, h out) nor the operations (8 Dh^2 FLOP per (b, head,
// step)) come near: at xlstm-125m's 1 x 4 heads x 32,768 steps the
// operations bound is 0.59 ms, 18 ns a step. A step's latency is set by
// handing h to every SM that holds part of R and by the cell update, so
// the design shortens that chain.
//
// Design. One thread-block cluster of CL blocks per (b, head), CL =
// ceil(Dh / 32) (`slstm_cluster` in xlstm.py passes it: the fewest blocks
// that hold <= 32 units each, 6 at Dh 192); block r owns units
// [r U, (r+1) U), U = ceil(Dh / CL), one unit per lane. Why the fewest:
// the exchange alone (slstm_probe.cu, `st.async` one way; chip_smoke.py
// on an H100 80GB HBM3 at 700 W) took 0.283 / 0.342 / 0.346 /
// 0.354 / 0.380 us a step at cluster 2 / 4 / 6 / 8 / 16, and the whole
// kernel at Dh 192 took 0.692 us a step at cluster 6 against 0.717 at 7
// and 0.701 at 8 (with a 15.1 us decode step at 8 against 8.8 at 6).
// A block has 8 warps: warp w holds rows k of [w KS, (w+1) KS) of its
// units' four R columns in registers, as f32 (a bf16 R is widened once
// when loaded; 4 x KS <= 128 registers a thread at Dh 256, within the 255
// that 256 threads may each hold), loaded once per launch, neighbouring
// lanes on neighbouring columns (coalesced). Each step:
//
//   1. every thread waits for h_{t-1} in its block's own h buffer, dots
//      its KS values of h (float4 reads, a broadcast) with its four R
//      columns and writes the four partial sums to shared memory;
//   2. one block barrier; warp 0 adds the 8 partials of its unit's four
//      gates, adds wx, and runs the cell update, lane = unit, so the units
//      of a block update in parallel and the four gates' activations are
//      independent chains of one lane;
//   3. warp 0 stores h_t into the h buffer of every block of the cluster
//      (itself included) with `st.async`, each completing 4 bytes on that
//      block's mbarrier, and writes h_t to global memory (U contiguous
//      floats, one store instruction).
//
// The exchange is one-way: no cluster barrier. Each block has two h
// buffers with one mbarrier each; a block waits on the parity of its own
// barrier and re-arms it (`arrive.expect_tx` of Dh x 4 bytes) as soon as
// the wait returns. Why a store into buffer (t+1) % 2 can never land
// while a block still reads it for step t-1: a block at step t already
// holds every peer's h_{t-1}, and each peer sent that only after the
// block barrier of its step t-1, which all of that peer's threads pass
// only after reading their h for step t-1. For the same reason a
// barrier's phase has completed before any byte of its next phase
// arrives. The last step sends nothing, so no store is in flight into a
// block that has exited.
//
// wx is pulled into L2 by warp 0 `PREFETCH` steps ahead and loaded into
// registers two steps ahead (the loop is unrolled by two so that no
// register is moved while its load is in flight). The cell update uses
// the fast intrinsics (__expf, __logf, __fdividef; tanh as
// 1 - 2 / (exp(2|x|) + 1)): their errors (a few ulp, absolute below 1e-6
// in the activations) stay far inside the kernel's stated tolerance.
//
// For training, `slstm_launch` given a `saved` record also writes, per
// step, what B8-bwd (slstm_bwd.cu) reads: the four pre-activations and the
// new c, n, m, 7 floats a unit from warp 0's cell lanes. With a null
// record it is the serving paths' launch as before.
//
// Tried and not adopted: 16 warps of half as many rows (R's 64 registers
// a thread and the partial sums did not fit the 128 registers that 512
// threads may each hold, and spilled to local memory); a wx ring in
// registers four steps deep (no faster than the L2 prefetch); a hang
// guard counting the barrier polls (it lengthened every step); bf16 R
// kept packed as bf16x2 and widened by a shift each step (the f32 slice
// fits the registers, so the shift would only add instructions); a
// staging tile for h_out (warp 0's store of U contiguous floats is already
// one coalesced instruction); clusters of 7 and 8 (above); the cell on
// tanhf, expf and log1pf as the first design (0.815 us a step); the
// exchange as 64-bit (step, h) stores that the receiver spins on (0.725
// us a step at cluster 6 against `st.async`'s 0.346). chip_smoke.py's
// `slstm_exchange` line times the exchange alone at cluster sizes 2-16
// (the latency floor of a step) and its `recurrent_checks` line the
// kernel (PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_exchange.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KS_MAX = 32;          // rows of R per thread: Dh <= 256
constexpr int MAX_UNITS = 32;       // units per block: one per lane
constexpr int PREFETCH = 16;        // steps ahead that wx is pulled into L2

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Cell {
  float c, n, m, h;

  __device__ __forceinline__ void step(float pz, float pi, float pf,
                                       float po) {
    const float ft = pf + 1.0f;
    const float az = fabsf(pz);
    const float z =
        copysignf(1.0f - __fdividef(2.0f, __expf(2.0f * az) + 1.0f), pz);
    const float o = __fdividef(1.0f, 1.0f + __expf(-po));
    const float lsf = fminf(ft, 0.0f) - __logf(1.0f + __expf(-fabsf(ft)));
    const float m_new = fmaxf(lsf + m, pi);
    const float ip = __expf(pi - m_new);
    const float fp = __expf(lsf + m - m_new);
    c = fp * c + ip * z;
    n = fp * n + ip;
    h = __fdividef(o * c, fmaxf(n, 1e-6f));
    m = m_new;
  }
};

template <typename TX, typename TR, bool SAVE>
__global__ void __launch_bounds__(THREADS, 1)
slstm_kernel(const TX* __restrict__ wz, const TX* __restrict__ wi,
             const TX* __restrict__ wf, const TX* __restrict__ wo,
             const TR* __restrict__ rz, const TR* __restrict__ ri,
             const TR* __restrict__ rf, const TR* __restrict__ ro,
             const float* __restrict__ h0, const float* __restrict__ c0,
             const float* __restrict__ n0, const float* __restrict__ m0,
             float* __restrict__ hout, float* __restrict__ h1,
             float* __restrict__ c1, float* __restrict__ n1,
             float* __restrict__ m1, float* __restrict__ saved, int T, int H,
             int Dh, int U, int KS) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* part = reinterpret_cast<float4*>(smem + 16);   // [WARPS][32]
  float* hbuf = reinterpret_cast<float*>(smem + 16 + WARPS * 32 * 16);
  const int HP = WARPS * KS;                              // [2][HP]
  const uint32_t bar0 = cx::smem_addr(smem);              // 2 mbarriers
  const uint32_t hb0 = cx::smem_addr(hbuf);
  const uint32_t rank = cx::cluster_rank(), CL = cx::cluster_size();
  const uint32_t bytes = (uint32_t)Dh * 4;

  const int bh = blockIdx.y;                // b * H + head
  const int head = bh % H, b = bh / H;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int e = (int)rank * U + lane;       // this lane's unit
  const bool live = lane < U && e < Dh;
  const int k0 = w * KS;

  // This thread's rows of its unit's four R columns, zero past Dh.
  float R[4][KS_MAX];
  {
    const TR* Rg[4] = {rz, ri, rf, ro};
    const int64_t col = (int64_t)head * Dh * Dh + e;
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int i = 0; i < KS_MAX; ++i) {
        const int k = k0 + i;
        R[g][i] = live && i < KS && k < Dh
                      ? to_f32(Rg[g][col + (int64_t)k * Dh]) : 0.0f;
      }
  }
  const int64_t sbase = (int64_t)bh * Dh;
  for (int k = tid; k < 2 * HP; k += THREADS)
    hbuf[k] = k < Dh ? h0[sbase + k] : 0.0f;
  if (tid == 0) {
    cx::mbar_init(bar0, 1);
    cx::mbar_init(bar0 + 8, 1);
    cx::fence_mbar_init();
    cx::mbar_expect_tx(bar0 + 8, bytes);   // step 0's h, into buffer 1
    cx::mbar_expect_tx(bar0, bytes);       // step 1's, into buffer 0
  }
  Cell cell{0.0f, 1.0f, 0.0f, 0.0f};
  const bool cell_lane = w == 0 && live;
  if (cell_lane) {
    cell.c = c0[sbase + e];
    cell.n = n0[sbase + e];
    cell.m = m0[sbase + e];
  }
  const int64_t D = (int64_t)H * Dh;
  const int64_t col = (int64_t)head * Dh + e;
  const TX* wg[4] = {wz, wi, wf, wo};
  TX wxa[4], wxb[4];   // wx of steps t and t + 1, loaded two steps ahead
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    wxa[g] = cell_lane ? wg[g][(int64_t)b * T * D + col] : TX(0.0f);
    wxb[g] = cell_lane && T > 1 ? wg[g][((int64_t)b * T + 1) * D + col]
                                : TX(0.0f);
  }
  cx::cluster_sync();   // every block running, every barrier armed

  uint32_t parity = 0;  // bit j: the phase parity to wait for on barrier j
  auto step = [&](int t, TX (&wx)[4]) {
    const int cur = t & 1;
    if (t > 0) {
      cx::mbar_wait(bar0 + 8 * cur, (parity >> cur) & 1);
      parity ^= 1u << cur;
      if (tid == 0) cx::mbar_expect_tx(bar0 + 8 * cur, bytes);
    }
    const float* hc = hbuf + cur * HP + k0;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int j = 0; j < KS_MAX / 4; ++j) {
      if (4 * j < KS) {
        const float4 hv = *reinterpret_cast<const float4*>(hc + 4 * j);
        const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a0 = fmaf(hk[i], R[0][4 * j + i], a0);
          a1 = fmaf(hk[i], R[1][4 * j + i], a1);
          a2 = fmaf(hk[i], R[2][4 * j + i], a2);
          a3 = fmaf(hk[i], R[3][4 * j + i], a3);
        }
      }
    }
    part[w * 32 + lane] = make_float4(a0, a1, a2, a3);
    __syncthreads();
    if (w != 0) return;
    // The warps' partial sums, in four independent chains.
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = part[i * 32 + lane];
#pragma unroll
    for (int i = 4; i < WARPS; ++i) {
      const float4 q = part[i * 32 + lane];
      p[i & 3].x += q.x;
      p[i & 3].y += q.y;
      p[i & 3].z += q.z;
      p[i & 3].w += q.w;
    }
#pragma unroll
    for (int s = 2; s > 0; s >>= 1)
#pragma unroll
      for (int i = 0; i < s; ++i) {
        p[i].x += p[i + s].x;
        p[i].y += p[i + s].y;
        p[i].z += p[i + s].z;
        p[i].w += p[i + s].w;
      }
    if (live) {
      const float pre[4] = {to_f32(wx[0]) + p[0].x, to_f32(wx[1]) + p[0].y,
                            to_f32(wx[2]) + p[0].z, to_f32(wx[3]) + p[0].w};
      cell.step(pre[0], pre[1], pre[2], pre[3]);
      if (SAVE) {
        // B8-bwd's record of this step: the pre-activations, then the
        // new c, n, m (SLSTM_SAVED rows of D).
        float* rec = saved + ((int64_t)b * T + t) * 7 * D + col;
#pragma unroll
        for (int g = 0; g < 4; ++g) rec[g * D] = pre[g];
        rec[4 * D] = cell.c;
        rec[5 * D] = cell.n;
        rec[6 * D] = cell.m;
      }
      if (t + 1 < T) {
        const uint32_t dst = hb0 + 4 * ((cur ^ 1) * HP + e);
        const uint32_t bar = bar0 + 8 * (cur ^ 1);
        for (uint32_t q = 0; q < CL; ++q)
          cx::st_async(cx::map_rank(dst, q), cell.h, cx::map_rank(bar, q));
      }
      hout[((int64_t)b * T + t) * D + col] = cell.h;
      if (t + PREFETCH < T) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          asm volatile("prefetch.global.L2 [%0];" :: "l"(
              wg[g] + ((int64_t)b * T + t + PREFETCH) * D + col));
      }
      if (t + 2 < T) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          wx[g] = wg[g][((int64_t)b * T + t + 2) * D + col];
      }
    }
  };
  for (int t = 0; t < T; t += 2) {
    step(t, wxa);
    if (t + 1 < T) step(t + 1, wxb);
  }
  if (cell_lane) {
    h1[sbase + e] = cell.h;
    c1[sbase + e] = cell.c;
    n1[sbase + e] = cell.n;
    m1[sbase + e] = cell.m;
  }
}

template <typename TX, typename TR>
cudaError_t launch(void* const* p, float* saved, int B, int T, int H, int Dh,
                   int CL, cudaStream_t s) {
  const int U = (Dh + CL - 1) / CL;
  const int KS = ((Dh + WARPS - 1) / WARPS + 3) / 4 * 4;
  const size_t smem = 16 + WARPS * 32 * 16 + 2 * (size_t)WARPS * KS * 4;
  // The record is a template parameter, so that the serving launch
  // compiles to the kernel it was before the record existed.
  auto run = [&](auto kernel) {
    return cx::launch_clustered(
        kernel, CL, B * H, THREADS, smem, s, p[0], p[1], p[2], p[3], p[4],
        p[5], p[6], p[7], p[8], p[9], p[10], p[11], p[12], p[13], p[14],
        p[15], p[16], saved, T, H, Dh, U, KS);
  };
  return saved ? run(slstm_kernel<TX, TR, true>)
               : run(slstm_kernel<TX, TR, false>);
}


cudaError_t dispatch(const void* const* in, void* saved, int B, int T,
                     int H, int Dh, int dtypes, int cluster, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (H <= 0 || Dh <= 0 || Dh > WARPS * KS_MAX || (int64_t)B * H > 65535 ||
      cluster != (Dh + MAX_UNITS - 1) / MAX_UNITS)
    return cudaErrorInvalidValue;
  void* const* p = const_cast<void* const*>(in);
  float* sv = static_cast<float*>(saved);
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtypes) {
    case 0: return launch<float, float>(p, sv, B, T, H, Dh, cluster, s);
    case 1:
      return launch<float, __nv_bfloat16>(p, sv, B, T, H, Dh, cluster, s);
    case 2:
      return launch<__nv_bfloat16, float>(p, sv, B, T, H, Dh, cluster, s);
    case 3:
      return launch<__nv_bfloat16, __nv_bfloat16>(p, sv, B, T, H, Dh,
                                                    cluster, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// wz, wi, wf, wo: (B, T, H*Dh) in the wx type; rz, ri, rf, ro: (H, Dh, Dh)
// in the R type; h0, c0, n0, m0: (B, H, Dh) f32; hout (B, T, H*Dh) f32 and
// h1, c1, n1, m1 (B, H, Dh) f32 out. saved: null, or the record B8-bwd
// reads (B, T, 7, H*Dh) f32 out, per step the four pre-activations (z, i,
// f before its + 1, o) and the new c, n, m. dtypes = 2 * wx code + R code
// (0 f32, 1 bf16). cluster: blocks per (b, head), ceil(Dh / 32) (the
// portable cluster sizes hold every Dh <= 256).
extern "C" int slstm_launch(
    const void* wz, const void* wi, const void* wf, const void* wo,
    const void* rz, const void* ri, const void* rf, const void* ro,
    const void* h0, const void* c0, const void* n0, const void* m0,
    void* hout, void* h1, void* c1, void* n1, void* m1, void* saved, int B,
    int T, int H, int Dh, int dtypes, int cluster, void* stream) {
  const void* const p[17] = {wz, wi, wf, wo, rz, ri, rf, ro, h0, c0,
                             n0, m0, hout, h1, c1, n1, m1};
  return (int)dispatch(p, saved, B, T, H, Dh, dtypes, cluster, stream);
}
