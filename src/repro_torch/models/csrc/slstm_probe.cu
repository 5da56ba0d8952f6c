// Probe of the sLSTM kernel B8's per-step exchange, for sm_90a.
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
// Each step of variants 1-2 depends on the previous step's values from
// every rank, as in B8. The cluster size is a launch argument (2 .. 16;
// above 8 needs the non-portable attribute and may not launch). Launched
// only by chip_smoke.py (`slstm_exchange` line): the fastest exchange is
// B8's latency floor per step.

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

}  // namespace

// out: (BH, Dh) f32, the last h of each unit. Returns a cudaError_t code.
extern "C" int slstm_probe_launch(int variant, int cluster, int BH, int Dh,
                                  int T, void* out, void* stream) {
  if (cluster < 1 || cluster > 16 || BH <= 0 || Dh <= 0 || T <= 0 ||
      variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  const int U = (Dh + cluster - 1) / cluster;
  const int threads = (U + 31) / 32 * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = 16 + 2 * (size_t)Dh * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  float* o = (float*)out;
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
