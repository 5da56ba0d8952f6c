// Persistent dispatch: the wavefront over every dispatch group of a
// request in one launch, for sm_90a.
//
// Replaces the TPU kernel `_persistent_kernel` (wrapper
// `persistent_align_pallas`) of src/repro/kernels/banded_dp/persistent.py.
// That kernel stacks the groups into one uniform (G, tiles, bt, L_max)
// layout padded to the widest group's rows, steps and band, and walks a
// (group, tile, step chunk) grid whose per-group band / chunk count / tile
// count arrive as scalar prefetch. On a GPU the uniform layout would cost
// gigabytes of traceback plane for a ragged request, so this kernel takes
// a work table instead:
//
//   * inputs and outputs are flat ragged buffers; row x of the table gives
//     the output row, the q / r offsets and padded lengths, the band B_x,
//     the sweep length T_x and the offsets of the pair's (T_x, ceil(B_x/2))
//     flag plane and (T_x + 1) band offsets. Every one of them is a
//     run-time value: a new request geometry builds nothing.
//   * one WARP per table row, blocks of 32 threads, when the request's
//     widest band is at most WARP_MAX_BAND (128): each row runs B1's warp
//     body (wavefront_warp.cuh) with C = 1, 2 or 4 band lanes per thread
//     picked from the row's own band, the band state in registers and no
//     barrier per step. Every table of the main paths (bands 20, 60, 100)
//     runs here. The results are those of the per-group kernel bit for
//     bit, as B1's two bodies are.
//   * a wider request keeps one thread block per table row, running the
//     block body (wavefront.cuh) with that row's own band. Blocks are
//     sized for the widest band of the request; lanes >= B_x are the
//     out-of-band lanes of a B_x-wide block. `block_body` is a measurement
//     switch that runs this kernel at any band, so that both bodies can be
//     timed on the same tables; the main paths never set it.
//   * the table is ordered longest sweep first, so the long pairs start
//     first and the short ones fill the tail.
//
// The TPU kernel's per-tile all-retired flag has no counterpart: a pair
// the xdrop rule retires leaves its own loop. What bounds it on an H100 is
// what bounds the per-group kernel (see banded_dp.cu): each row is a
// serial chain of n + m dependent steps.

#include "wavefront.cuh"
#include "wavefront_warp.cuh"
#include "work_table.cuh"

namespace {

using namespace wavefront;
using namespace work_table;

struct Params {
  const long long* table;  // (R, NCOL)
  const int8_t* q;         // flat, q_off + Lq per row
  const int8_t* r;         // flat, r_off + Lr per row
  const int* n;            // (R,) by output row
  const int* m;            // (R,)
  int* stats;              // (6, R)
  uint8_t* tb;             // flat, tb_off + T * ceil(B/2) per row, or null
  int* los;                // flat, los_off + T + 1 per row, or null
  int R;
  Scoring S;
};

// Where table row x reads its inputs and writes its results.
__device__ __forceinline__ Row table_row(const Params& P, int x) {
  const long long* e = P.table + (long long)x * NCOL;
  const int row = (int)e[ROW];
  Row R;
  R.q = P.q + e[Q_OFF];
  R.r = P.r + e[R_OFF];
  R.n = P.n[row];
  R.m = P.m[row];
  R.Lq = (int)e[LQ];
  R.Lr = (int)e[LR];
  R.T = (int)e[STEPS];
  R.B = (int)e[BAND];
  R.stats = P.stats + row;
  R.stride = P.R;
  R.tb = P.tb ? P.tb + e[TB_OFF] : nullptr;
  R.los = P.los ? P.los + e[LOS_OFF] : nullptr;
  return R;
}

template <bool SEMI, bool ADAPTIVE, bool TB, bool XDROP>
__global__ void persistent_kernel(Params P) {
  extern __shared__ int smem[];
  align_row<SEMI, ADAPTIVE, TB, XDROP>(table_row(P, blockIdx.x), P.S, smem);
}

template <bool SEMI, bool ADAPTIVE, bool TB, bool XDROP>
__global__ void __launch_bounds__(32) persistent_warp_kernel(Params P) {
  const Row R = table_row(P, blockIdx.x);
  if (R.B <= 32)
    align_row_warp<1, SEMI, ADAPTIVE, TB, XDROP>(R, P.S);
  else if (R.B <= 64)
    align_row_warp<2, SEMI, ADAPTIVE, TB, XDROP>(R, P.S);
  else
    align_row_warp<4, SEMI, ADAPTIVE, TB, XDROP>(R, P.S);
}

template <bool SEMI, bool ADAPTIVE, bool TB, bool XDROP>
cudaError_t launch(const Params& P, int threads, size_t smem,
                   cudaStream_t stream) {
  persistent_kernel<SEMI, ADAPTIVE, TB, XDROP>
      <<<P.R, threads, smem, stream>>>(P);
  return cudaGetLastError();
}

template <bool SEMI, bool ADAPTIVE, bool TB, bool XDROP>
cudaError_t launch_warp(const Params& P, cudaStream_t stream) {
  persistent_warp_kernel<SEMI, ADAPTIVE, TB, XDROP><<<P.R, 32, 0, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace

// Columns of the work table, checked by the wrapper.
extern "C" int persistent_table_cols() { return NCOL; }

// Launches the persistent wavefront on `stream` over the R rows of
// `table`; `band_max` is the widest band in it (at most 1024): the warp
// kernel for band_max <= WARP_MAX_BAND, the block kernel above or with
// `block_body` (a measurement switch). Returns the CUDA error code of the
// launch (0 = success). Allocates nothing and does not synchronise.
// xdrop < 0 switches the retire rule off.
extern "C" int persistent_launch(
    const void* table, const void* q, const void* r, const void* n,
    const void* m, void* stats, void* tb, void* los, int R, int band_max,
    int match, int mismatch, int gap_open, int gap_extend, int xdrop,
    int semiglobal, int adaptive, int collect_tb, int block_body,
    void* stream) {
  if (R <= 0) return 0;
  if (band_max < 1 || band_max > 1024) return (int)cudaErrorInvalidValue;
  Params P;
  P.table = (const long long*)table;
  P.q = (const int8_t*)q; P.r = (const int8_t*)r;
  P.n = (const int*)n; P.m = (const int*)m;
  P.stats = (int*)stats; P.tb = (uint8_t*)tb; P.los = (int*)los;
  P.R = R;
  P.S = Scoring{match, mismatch, gap_open, gap_extend, xdrop};
  cudaStream_t s = (cudaStream_t)stream;
  if (band_max <= WARP_MAX_BAND && !block_body) {
#define LAUNCH(A, B_, C, D) launch_warp<A, B_, C, D>(P, s)
    WAVEFRONT_DISPATCH(semiglobal, adaptive, collect_tb, xdrop >= 0, LAUNCH)
#undef LAUNCH
  }
  const int threads = ((band_max + 31) / 32) * 32;
  const size_t smem = smem_ints(band_max) * sizeof(int);
#define LAUNCH(A, B_, C, D) launch<A, B_, C, D>(P, threads, smem, s)
  WAVEFRONT_DISPATCH(semiglobal, adaptive, collect_tb, xdrop >= 0, LAUNCH)
#undef LAUNCH
}
