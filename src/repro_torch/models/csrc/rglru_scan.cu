// RG-LRU gates and linear scan (B6), for sm_90a.
//
// Replaces `rglru_apply` of src/repro/models/rglru.py (the gates of
// `_gates` and a `jax.lax.associative_scan` over T):
//
//   r = sigmoid(wa), i = sigmoid(wx)                 (dense outputs in)
//   a = exp(-8 softplus(lam) r),  b = sqrt(max(1 - a^2, 1e-9)) i x
//   h_t = a_t h_{t-1} + b_t,  y_t = h_t in x's type,  h_last = h_T (f32)
//
// over (B, T, D), f32 arithmetic whatever the input type.
//
// Design. recurrentgemma-9b runs B 1 x D 4,096: one thread per channel
// looping over all of T would keep 4,096 threads busy, far too few to
// stream from HBM. So T is cut into chunks of L steps and the scan runs in
// three passes, one thread per (b, chunk, d), neighbouring threads on
// neighbouring channels (coalesced):
//   1. reduce: each chunk's (prod a, h from 0) pair, computed in order;
//   2. carry:  one thread per (b, d) walks the chunks' pairs from h0 and
//              writes the h each chunk starts from (nc = T / L steps);
//   3. fix-up: each chunk rescans its steps from its start h, writing y;
//              the last chunk writes h_last (so h_last == y[:, -1]).
// The gates are recomputed in pass 3 rather than stored: reading the
// three inputs twice costs less than writing and reading a, b in f32.
//
// What bounds it on an H100: bytes. The least traffic is each input read
// once and y written once (8 bytes per (b, t, d) in bf16, 16 in f32); this
// design reads the inputs twice (14 / 28 bytes). The pairs of the carry
// pass are 12 bytes per (b, chunk, d), 1/64 of that at L = 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float load(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int64_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// -8 * softplus(lam): the exponent's factor, once per channel.
__device__ __forceinline__ float neg_c_softplus(float lam) {
  return -8.0f * (fmaxf(lam, 0.0f) + log1pf(expf(-fabsf(lam))));
}

template <typename TX>
__device__ __forceinline__ void gate(const TX* wa, const TX* wx, const TX* x,
                                     int64_t i, float k, float& a, float& b) {
  const float r = sigmoid(load(wa, i));
  const float ig = sigmoid(load(wx, i));
  a = expf(k * r);
  b = sqrtf(fmaxf(1.0f - a * a, 1e-9f)) * (ig * load(x, i));
}

template <typename TX, typename TL>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const TX* __restrict__ wa, const TX* __restrict__ wx,
              const TX* __restrict__ x, const TL* __restrict__ lam,
              float* __restrict__ prod_a, float* __restrict__ h_loc, int T,
              int D, int L, int nc) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (d >= D) return;
  const float k = neg_c_softplus(load(lam, d));
  const int t1 = min(T, (c + 1) * L);
  float A = 1.0f, H = 0.0f;
  for (int t = c * L; t < t1; ++t) {
    float a, bb;
    gate(wa, wx, x, ((int64_t)b * T + t) * D + d, k, a, bb);
    A *= a;
    H = a * H + bb;
  }
  const int64_t o = ((int64_t)b * nc + c) * D + d;
  prod_a[o] = A;
  h_loc[o] = H;
}

__global__ void __launch_bounds__(THREADS)
carry_kernel(const float* __restrict__ prod_a, const float* __restrict__ h_loc,
             const float* __restrict__ h0, float* __restrict__ h_in, int D,
             int nc) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  float h = h0 ? h0[(int64_t)b * D + d] : 0.0f;
  for (int c = 0; c < nc; ++c) {
    const int64_t o = ((int64_t)b * nc + c) * D + d;
    h_in[o] = h;
    h = prod_a[o] * h + h_loc[o];
  }
}

template <typename TX, typename TL>
__global__ void __launch_bounds__(THREADS)
fixup_kernel(const TX* __restrict__ wa, const TX* __restrict__ wx,
             const TX* __restrict__ x, const TL* __restrict__ lam,
             const float* __restrict__ h_in, TX* __restrict__ y,
             float* __restrict__ h_last, int T, int D, int L, int nc) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (d >= D) return;
  const float k = neg_c_softplus(load(lam, d));
  const int t1 = min(T, (c + 1) * L);
  float h = h_in[((int64_t)b * nc + c) * D + d];
  for (int t = c * L; t < t1; ++t) {
    const int64_t i = ((int64_t)b * T + t) * D + d;
    float a, bb;
    gate(wa, wx, x, i, k, a, bb);
    h = a * h + bb;
    store(y, i, h);
  }
  if (c == nc - 1) h_last[(int64_t)b * D + d] = h;
}

template <typename TX, typename TL>
cudaError_t launch(const void* wa, const void* wx, const void* x,
                   const void* lam, const float* h0, void* y, float* h_last,
                   float* scratch, int B, int T, int D, int L,
                   cudaStream_t s) {
  const int nc = (T + L - 1) / L;
  const int64_t plane = (int64_t)B * nc * D;
  float* prod_a = scratch;
  float* h_loc = scratch + plane;
  float* h_in = scratch + 2 * plane;
  const dim3 grid((D + THREADS - 1) / THREADS, nc, B);
  reduce_kernel<TX, TL><<<grid, THREADS, 0, s>>>(
      (const TX*)wa, (const TX*)wx, (const TX*)x, (const TL*)lam, prod_a,
      h_loc, T, D, L, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  carry_kernel<<<dim3((D + THREADS - 1) / THREADS, B), THREADS, 0, s>>>(
      prod_a, h_loc, h0, h_in, D, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fixup_kernel<TX, TL><<<grid, THREADS, 0, s>>>(
      (const TX*)wa, (const TX*)wx, (const TX*)x, (const TL*)lam, h_in,
      (TX*)y, h_last, T, D, L, nc);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (x_dtype for wa / wx / x / y, lam_dtype
// for lam). h0 may be null (zeros). scratch: 3 x B x ceil(T / L) x D f32.
extern "C" int rglru_scan_launch(const void* wa, const void* wx,
                                 const void* x, const void* lam,
                                 const void* h0, void* y, void* h_last,
                                 void* scratch, int B, int T, int D, int L,
                                 int x_dtype, int lam_dtype, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0) return 0;
  if (L <= 0 || B > 65535 || (T + L - 1) / L > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* h = (const float*)h0;
  float* hl = (float*)h_last;
  float* sc = (float*)scratch;
  if (x_dtype == 0 && lam_dtype == 0)
    return (int)launch<float, float>(wa, wx, x, lam, h, y, hl, sc, B, T, D,
                                     L, s);
  if (x_dtype == 0 && lam_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(wa, wx, x, lam, h, y, hl, sc, B,
                                             T, D, L, s);
  if (x_dtype == 1 && lam_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(wa, wx, x, lam, h, y, hl, sc, B,
                                             T, D, L, s);
  if (x_dtype == 1 && lam_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(wa, wx, x, lam, h, y, hl,
                                                     sc, B, T, D, L, s);
  return (int)cudaErrorInvalidValue;
}
