// sLSTM recurrence (B8), first design, for sm_90a.
//
// On no route since its redesign (slstm.cu): built and held against the
// plain version and timed beside the new design by chip_smoke.py only.
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
// Design: one thread-block cluster of 8 blocks per (b, head). Block r of
// the cluster owns units [r U, (r+1) U), U = ceil(Dh / 8), one warp a unit.
// It keeps the four gates' R columns of its units in shared memory, as
// f32, for the whole sequence (4 x 192 x 24 x 4 B = 74 KB at Dh 192; the
// whole R of a head, 590 KB in f32, fits no single SM). Each step a warp
// forms its unit's four pre-activations — lanes 8g..8g+7 split gate g's
// dot product over k and reduce by shuffles — lane 0 updates the unit's
// c, n, m, h in registers, and eight lanes write the new h into the h
// buffer of every block of the cluster through distributed shared memory.
// One cluster barrier per step; the h buffer is double-buffered, so a
// block may start step t+1's writes while another still reads step t's
// buffer only after that block has passed the barrier of step t. The wx
// inputs of step t+1 are loaded during step t.
//
// What bounds it on an H100: the serial chain of steps, one cluster
// barrier and one exchange through distributed shared memory each, not
// bytes (R once, wx once, h out) nor operations (8 Dh^2 FLOP per (b,
// head, step)).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;              // blocks per cluster
constexpr int MAX_UNITS = 32;      // warps per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

// Stride of one gate's R column in shared memory: a multiple of 32 plus 8,
// so the four gates' lanes (k = j + 8 i at gate g) fall on 32 banks.
__host__ __device__ inline int gate_stride(int Dh) {
  return (Dh + 31) / 32 * 32 + 8;
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return -(fmaxf(-x, 0.0f) + log1pf(expf(-fabsf(x))));
}

template <typename TX, typename TR>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(MAX_UNITS * 32)
slstm_kernel(const TX* __restrict__ wz, const TX* __restrict__ wi,
             const TX* __restrict__ wf, const TX* __restrict__ wo,
             const TR* __restrict__ rz, const TR* __restrict__ ri,
             const TR* __restrict__ rf, const TR* __restrict__ ro,
             const float* __restrict__ h0, const float* __restrict__ c0,
             const float* __restrict__ n0, const float* __restrict__ m0,
             float* __restrict__ hout, float* __restrict__ h1,
             float* __restrict__ c1, float* __restrict__ n1,
             float* __restrict__ m1, int T, int H, int Dh, int U) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int GS = gate_stride(Dh);
  float* Rs = smem;                         // [U][4][GS]
  float* hbuf = smem + (size_t)U * 4 * GS;  // [2][Dh]

  const int bh = blockIdx.y;                // b * H + head
  const int head = bh % H, b = bh / H;
  const int tid = threadIdx.x, lane = tid & 31, u = tid >> 5;
  const int e = rank * U + u;               // this warp's unit
  const bool live = e < Dh;
  const int g = lane >> 3, j = lane & 7;

  const TR* Rg[4] = {rz, ri, rf, ro};
  const int64_t rhead = (int64_t)head * Dh * Dh;
  for (int idx = tid; idx < 4 * Dh * U; idx += blockDim.x) {
    const int uu = idx % U, k = (idx / U) % Dh, gg = idx / (U * Dh);
    const int ee = rank * U + uu;
    Rs[(uu * 4 + gg) * GS + k] =
        ee < Dh ? load(Rg[gg], rhead + (int64_t)k * Dh + ee) : 0.0f;
  }
  const int64_t sbase = (int64_t)bh * Dh;
  for (int k = tid; k < Dh; k += blockDim.x) hbuf[k] = h0[sbase + k];
  float c = 0.0f, n = 1.0f, m = 0.0f;
  if (live && lane == 0) {
    c = c0[sbase + e];
    n = n0[sbase + e];
    m = m0[sbase + e];
  }
  const TX* wg = g == 0 ? wz : g == 1 ? wi : g == 2 ? wf : wo;
  const int64_t D = (int64_t)H * Dh;
  const int64_t col = (int64_t)head * Dh + e;
  const bool loader = live && j == 0;
  float wx = loader ? load(wg, (int64_t)b * T * D + col) : 0.0f;
  const float* Rrow = Rs + (u * 4 + g) * GS;
  float h = 0.0f;
  cluster.sync();   // every block running, every h buffer filled

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const float wx_next = (loader && t + 1 < T)
        ? load(wg, ((int64_t)b * T + t + 1) * D + col) : 0.0f;
    const float* hc = hbuf + cur * Dh;
    float acc = 0.0f;
    if (live)
      for (int k = j; k < Dh; k += 8) acc += hc[k] * Rrow[k];
    acc += __shfl_xor_sync(FULL, acc, 4);
    acc += __shfl_xor_sync(FULL, acc, 2);
    acc += __shfl_xor_sync(FULL, acc, 1);
    const float pre = wx + acc;
    const float pz = __shfl_sync(FULL, pre, 0);
    const float pi = __shfl_sync(FULL, pre, 8);
    const float pf = __shfl_sync(FULL, pre, 16);
    const float po = __shfl_sync(FULL, pre, 24);
    if (lane == 0 && live) {
      const float z = tanhf(pz);
      const float ft = pf + 1.0f;
      const float o = 1.0f / (1.0f + expf(-po));
      const float lsf = log_sigmoid(ft);
      const float m_new = fmaxf(lsf + m, pi);
      const float ip = expf(pi - m_new);
      const float fp = expf(lsf + m - m_new);
      c = fp * c + ip * z;
      n = fp * n + ip;
      h = o * c / fmaxf(n, 1e-6f);
      m = m_new;
      hout[((int64_t)b * T + t) * D + col] = h;
    }
    const float hn = __shfl_sync(FULL, h, 0);
    if (live && lane < CL) {
      float* remote = cluster.map_shared_rank(hbuf + (cur ^ 1) * Dh, lane);
      remote[e] = hn;
    }
    cluster.sync();
    cur ^= 1;
    wx = wx_next;
  }
  if (live && lane == 0) {
    h1[sbase + e] = h;
    c1[sbase + e] = c;
    n1[sbase + e] = n;
    m1[sbase + e] = m;
  }
}

template <typename TX, typename TR>
cudaError_t launch(void* const* p, int B, int T, int H, int Dh,
                   cudaStream_t s) {
  const int U = (Dh + CL - 1) / CL;
  const size_t bytes =
      ((size_t)U * 4 * gate_stride(Dh) + 2 * (size_t)Dh) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_kernel<TX, TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  slstm_kernel<TX, TR><<<dim3(CL, B * H), U * 32, bytes, s>>>(
      (const TX*)p[0], (const TX*)p[1], (const TX*)p[2], (const TX*)p[3],
      (const TR*)p[4], (const TR*)p[5], (const TR*)p[6], (const TR*)p[7],
      (const float*)p[8], (const float*)p[9], (const float*)p[10],
      (const float*)p[11], (float*)p[12], (float*)p[13], (float*)p[14],
      (float*)p[15], (float*)p[16], T, H, Dh, U);
  return cudaGetLastError();
}

}  // namespace

// wz, wi, wf, wo: (B, T, H*Dh) in the wx type; rz, ri, rf, ro: (H, Dh, Dh)
// in the R type; h0, c0, n0, m0: (B, H, Dh) f32; hout (B, T, H*Dh) f32 and
// h1, c1, n1, m1 (B, H, Dh) f32 out. dtypes = 2 * wx code + R code (0 f32,
// 1 bf16).
extern "C" int slstm_first_launch(
    const void* wz, const void* wi, const void* wf, const void* wo,
    const void* rz, const void* ri, const void* rf, const void* ro,
    const void* h0, const void* c0, const void* n0, const void* m0,
    void* hout, void* h1, void* c1, void* n1, void* m1, int B, int T, int H,
    int Dh, int dtypes, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (H <= 0 || Dh <= 0 || Dh > CL * MAX_UNITS || (int64_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  void* const p[17] = {(void*)wz, (void*)wi, (void*)wf, (void*)wo,
                       (void*)rz, (void*)ri, (void*)rf, (void*)ro,
                       (void*)h0, (void*)c0, (void*)n0, (void*)m0,
                       hout, h1, c1, n1, m1};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtypes) {
    case 0: return (int)launch<float, float>(p, B, T, H, Dh, s);
    case 1: return (int)launch<float, __nv_bfloat16>(p, B, T, H, Dh, s);
    case 2: return (int)launch<__nv_bfloat16, float>(p, B, T, H, Dh, s);
    case 3:
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(p, B, T, H, Dh, s);
  }
  return (int)cudaErrorInvalidValue;
}
