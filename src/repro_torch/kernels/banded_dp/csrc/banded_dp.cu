// Adaptive banded affine-gap wavefront DP (paper Eq. (4)) for sm_90a.
//
// Replaces the TPU kernel `_wavefront_kernel` (wrapper
// `banded_align_pallas`) of src/repro/kernels/banded_dp/banded_dp.py. It
// computes the same function and is laid out anew for a GPU: each pair
// loops over t = 1 .. n + m itself, and the TPU kernel's step-chunk grid
// axis, its scratch carry between chunks and its batch tile have no
// counterpart: pairs run in parallel and each leaves its loop at its own
// n + m, or at the step the xdrop rule retires it. Two per-pair bodies,
// chosen here from the band:
//
//   * B <= 128, the warp body (wavefront_warp.cuh): one warp per pair and
//     one warp per block, C = 1, 2 or 4 (B <= 32, 64, 128) band lanes per
//     thread in registers; the +/-1 lane shift is three shuffles, the best
//     cell is joined over the warp once per pair, and a step has no
//     barrier. Every bucket class of the main paths (bands 20, 60, 100)
//     runs here.
//   * 128 < B <= 1024, the block body (wavefront.cuh): one block per pair,
//     one thread per band lane, the band state in shared memory, double
//     buffered and padded by one dead lane on each side, one
//     __syncthreads() per step; per-warp reductions joined across warps in
//     lane order through shared memory behind that barrier. The persistent
//     kernel (persistent.cu) picks between the two bodies the same way,
//     from the widest band of its request.
//
// Both bodies: a strict `>` keeps the lowest lane on best-cell ties; 4-bit
// flags are packed two per byte and stored straight to global memory; rows
// past the last live step are zeroed and `los` is filled with the frozen
// offset, so the output is defined everywhere.
//
// What bounds it on an H100: a serial chain of n + m dependent steps per
// pair, each a few dozen int32 operations per lane plus shuffles or a
// barrier; neither the memory rate nor the int32 rate is approached (see
// PERF.md). The chain's latency and the number of pairs in flight set the
// time.
//
// `cell_dtype="narrow"` of the caller changes only how the TPU kernel
// stored its carry between chunks; results are identical by construction,
// so this kernel runs narrow requests on its int32 path.
//
// All of band, T, Lq, Lr, the scoring and xdrop are run-time arguments;
// the warp body is compiled for C = 1, 2 and 4 lanes per thread.

#include "wavefront.cuh"
#include "wavefront_warp.cuh"

namespace {

using namespace wavefront;

struct Params {
  const int8_t* q;      // (N, Lq)
  const int8_t* r;      // (N, Lr)
  const int* n;         // (N,)
  const int* m;         // (N,)
  int* stats;           // (6, N): score, final_lo, best, best_i, best_j, status
  uint8_t* tb;          // (N, T, Bp) or null
  int* los;             // (N, T + 1) or null
  int N, Lq, Lr, T, B;
  Scoring S;
};

// Where pair `pair` of the launch reads its inputs and writes its results.
__device__ __forceinline__ Row pair_row(const Params& P, int pair) {
  const int Bp = (P.B + 1) >> 1;
  Row R;
  R.q = P.q + (long long)pair * P.Lq;
  R.r = P.r + (long long)pair * P.Lr;
  R.n = P.n[pair];
  R.m = P.m[pair];
  R.Lq = P.Lq;
  R.Lr = P.Lr;
  R.T = P.T;
  R.B = P.B;
  R.stats = P.stats + pair;
  R.stride = P.N;
  R.tb = P.tb ? P.tb + (long long)pair * P.T * Bp : nullptr;
  R.los = P.los ? P.los + (long long)pair * (P.T + 1) : nullptr;
  return R;
}

template <bool SEMI, bool ADAPTIVE, bool TB, bool XDROP>
__global__ void wavefront_kernel(Params P) {
  extern __shared__ int smem[];
  align_row<SEMI, ADAPTIVE, TB, XDROP>(pair_row(P, blockIdx.x), P.S, smem);
}

template <int C, bool SEMI, bool ADAPTIVE, bool TB, bool XDROP>
__global__ void __launch_bounds__(32)
wavefront_warp_kernel(Params P) {
  align_row_warp<C, SEMI, ADAPTIVE, TB, XDROP>(pair_row(P, blockIdx.x), P.S);
}

template <bool SEMI, bool ADAPTIVE, bool TB, bool XDROP>
cudaError_t launch(const Params& P, int threads, size_t smem,
                   cudaStream_t stream) {
  wavefront_kernel<SEMI, ADAPTIVE, TB, XDROP>
      <<<P.N, threads, smem, stream>>>(P);
  return cudaGetLastError();
}

template <bool SEMI, bool ADAPTIVE, bool TB, bool XDROP>
cudaError_t launch_warp(const Params& P, cudaStream_t stream) {
  if (P.B <= 32)
    wavefront_warp_kernel<1, SEMI, ADAPTIVE, TB, XDROP>
        <<<P.N, 32, 0, stream>>>(P);
  else if (P.B <= 64)
    wavefront_warp_kernel<2, SEMI, ADAPTIVE, TB, XDROP>
        <<<P.N, 32, 0, stream>>>(P);
  else
    wavefront_warp_kernel<4, SEMI, ADAPTIVE, TB, XDROP>
        <<<P.N, 32, 0, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace

// Largest band one launch takes: one lane per thread of a block.
extern "C" int banded_dp_max_band() { return 1024; }

// Launches the wavefront on `stream` for N pairs: the warp body for
// B <= WARP_MAX_BAND, the block body above. `block_body` is a measurement
// switch that runs the block body at any band, so that both bodies can be
// timed on the same inputs; the main paths never set it. Returns the CUDA
// error code of the launch (0 = success). Allocates nothing and does not
// synchronise. xdrop < 0 switches the retire rule off.
extern "C" int banded_dp_launch(
    const void* q, const void* r, const void* n, const void* m,
    void* stats, void* tb, void* los,
    int N, int Lq, int Lr, int T, int B,
    int match, int mismatch, int gap_open, int gap_extend, int xdrop,
    int semiglobal, int adaptive, int collect_tb, int block_body,
    void* stream) {
  if (N <= 0) return 0;
  if (B < 1 || B > 1024) return (int)cudaErrorInvalidValue;
  Params P;
  P.q = (const int8_t*)q; P.r = (const int8_t*)r;
  P.n = (const int*)n; P.m = (const int*)m;
  P.stats = (int*)stats; P.tb = (uint8_t*)tb; P.los = (int*)los;
  P.N = N; P.Lq = Lq; P.Lr = Lr; P.T = T; P.B = B;
  P.S = Scoring{match, mismatch, gap_open, gap_extend, xdrop};
  const int threads = ((B + 31) / 32) * 32;
  const size_t smem = smem_ints(B) * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= WARP_MAX_BAND && !block_body) {
#define LAUNCH(A, B_, C, D) launch_warp<A, B_, C, D>(P, s)
    WAVEFRONT_DISPATCH(semiglobal, adaptive, collect_tb, xdrop >= 0, LAUNCH)
#undef LAUNCH
  }
#define LAUNCH(A, B_, C, D) launch<A, B_, C, D>(P, threads, smem, s)
  WAVEFRONT_DISPATCH(semiglobal, adaptive, collect_tb, xdrop >= 0, LAUNCH)
#undef LAUNCH
}
