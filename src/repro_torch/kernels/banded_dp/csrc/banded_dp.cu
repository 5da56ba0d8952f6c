// Adaptive banded affine-gap wavefront DP (paper Eq. (4)) for sm_90a.
//
// Replaces the TPU kernel `_wavefront_kernel` (wrapper
// `banded_align_pallas`) of src/repro/kernels/banded_dp/banded_dp.py. It
// computes the same function and is laid out anew for a GPU:
//
//   * one thread block owns one pair and loops over t = 1 .. n + m itself;
//     one thread owns one band lane. The TPU kernel's step-chunk grid axis,
//     its scratch carry between chunks and its batch tile have no
//     counterpart: blocks of different pairs run in parallel and each
//     leaves its loop at its own n + m, or at the step the xdrop rule
//     retires it.
//   * the band state (u, v, x, y, H) lives in shared memory, double
//     buffered and padded by one dead lane on each side, so the +/-1 lane
//     shift between diagonals is an index offset and one __syncthreads()
//     per step orders writers and readers.
//   * the band maximum (xdrop) and the first maximising lane (best cell)
//     are `__reduce_max_sync` / `__reduce_min_sync` per warp, joined
//     across warps in lane order through shared memory behind that same
//     barrier; a strict `>` keeps the lowest lane on ties.
//   * 4-bit flags are packed two per byte with one shuffle and stored
//     straight to global memory; rows past the last live step are zeroed
//     and `los` is filled with the frozen offset, so the output is defined
//     everywhere.
//
// What bounds it on an H100: a serial chain of n + m dependent steps per
// pair, each a few dozen int32 operations per lane, a barrier and two
// byte gathers; neither the memory rate nor the int32 rate is approached
// (see PERF.md). Occupancy across pairs is the only parallelism this
// design uses. 16-bit lanes with DPX intrinsics, several lanes per thread
// and staging q/r in shared memory are left to later work.
//
// `cell_dtype="narrow"` of the caller changes only how the TPU kernel
// stored its carry between chunks; results are identical by construction,
// so this kernel runs narrow requests on its int32 path.
//
// All of band, T, Lq, Lr, the scoring and xdrop are run-time arguments.
// The per-pair body lives in wavefront.cuh, shared with the persistent
// kernel (persistent.cu).

#include "wavefront.cuh"

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

template <bool SEMI, bool ADAPTIVE, bool TB, bool XDROP>
__global__ void wavefront_kernel(Params P) {
  extern __shared__ int smem[];
  const int pair = blockIdx.x;
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
  R.tb = TB ? P.tb + (long long)pair * P.T * Bp : nullptr;
  R.los = TB ? P.los + (long long)pair * (P.T + 1) : nullptr;
  align_row<SEMI, ADAPTIVE, TB, XDROP>(R, P.S, smem);
}

template <bool SEMI, bool ADAPTIVE, bool TB, bool XDROP>
cudaError_t launch(const Params& P, int threads, size_t smem,
                   cudaStream_t stream) {
  wavefront_kernel<SEMI, ADAPTIVE, TB, XDROP>
      <<<P.N, threads, smem, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace

// Largest band one launch takes: one lane per thread of a block.
extern "C" int banded_dp_max_band() { return 1024; }

// Launches the wavefront on `stream` for N pairs. Returns the CUDA error
// code of the launch (0 = success). Allocates nothing and does not
// synchronise. xdrop < 0 switches the retire rule off.
extern "C" int banded_dp_launch(
    const void* q, const void* r, const void* n, const void* m,
    void* stats, void* tb, void* los,
    int N, int Lq, int Lr, int T, int B,
    int match, int mismatch, int gap_open, int gap_extend, int xdrop,
    int semiglobal, int adaptive, int collect_tb, void* stream) {
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
#define LAUNCH(A, B_, C, D) launch<A, B_, C, D>(P, threads, smem, s)
  WAVEFRONT_DISPATCH(semiglobal, adaptive, collect_tb, xdrop >= 0, LAUNCH)
#undef LAUNCH
}
