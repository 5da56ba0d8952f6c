// Traceback walker with run-length encoding, for sm_90a.
//
// Replaces the jit'd device loop `decode_packed_tb` (a `lax.scan` over T
// lockstep iterations plus a gather / cumsum / scatter RLE pass) of
// src/repro/core/traceback_device.py. The output layout is the contract,
// not the method: cig_ops (N, K) uint8, cig_runs (N, K) int32, cig_len
// (N,) int32, runs in path order, columns >= cig_len zero.
//
// Design: one warp per pair. Lane 0 chases the path from the start cell
// to (0, 0) through that pair's packed flag plane — each step reads the
// three nibbles at (i, j), (i-1, j), (i, j-1) through `los` and applies
// the M/I/D state machine with the band-escape diagonal fallback and the
// forced boundary gaps — and run-length encodes while it walks, writing
// segments in walk order. Then the whole warp reverses the segments into
// path order and zeroes the unused columns with coalesced stores.
//
// What bounds it on an H100: latency. Every step is two dependent global
// loads (the band offset, then the flag byte) on a single lane, so the
// time is (path length) x (load latency), far above the bytes it moves
// over the memory rate (see PERF.md). Parallelism comes only from the
// number of pairs in flight. Fusing the walk behind the wavefront kernel,
// while the plane is still in L2, is left to later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int OP_M = 1, OP_I = 2, OP_D = 3;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Plane {
  const uint8_t* tb;   // (T, Bp)
  const int* los;      // (T + 1,)
  int T, Bp, band;

  // Flags at (ii, jj) and whether the cell is inside the band.
  __device__ __forceinline__ int lookup(int ii, int jj, bool& ok) const {
    const int t = ii + jj;
    const int k = ii - los[clampi(t, 0, T)];
    ok = t >= 1 && k >= 0 && k < band;
    const int kc = clampi(k, 0, band - 1);
    const int byte = tb[(long long)clampi(t - 1, 0, T - 1) * Bp + (kc >> 1)];
    return (byte >> ((kc & 1) * 4)) & 0xF;
  }
};

__global__ void traceback_kernel(
    const uint8_t* __restrict__ tb, const int* __restrict__ los,
    const int* __restrict__ start_i, const int* __restrict__ start_j,
    uint8_t* __restrict__ cig_ops, int* __restrict__ cig_runs,
    int* __restrict__ cig_len, int N, int T, int Bp, int band) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (pair >= N) return;            // whole warps leave together

  uint8_t* ops = cig_ops + (long long)pair * T;
  int* runs = cig_runs + (long long)pair * T;
  int nseg = 0;

  if (lane == 0) {
    Plane pl{tb + (long long)pair * T * Bp, los + (long long)pair * (T + 1),
             T, Bp, band};
    int i = start_i[pair], j = start_j[pair], st = 0;
    int cur_op = 0, cur_run = 0;
    for (int step = 0; step < T && (i > 0 || j > 0); ++step) {
      bool in_band, up_ok, left_ok;
      const int c = pl.lookup(i, j, in_band);
      const int cu = pl.lookup(i - 1, j, up_ok);
      const int cl = pl.lookup(i, j - 1, left_ok);
      const int d = c & 3;

      const bool b_del = i == 0;
      const bool b_ins = i > 0 && j == 0;
      const bool interior = i > 0 && j > 0;
      const bool esc = interior && !in_band;   // diagonal fallback
      const bool core = interior && in_band;
      const bool diag = core && st == 0 && d == 0;
      const bool ins = core && (st == 1 || (st == 0 && d == 1));
      const bool dele = core && (st == 2 || (st == 0 && d >= 2));
      // Gap-extend bits live on the next cell of the run.
      const bool ext_e = up_ok && (i - 1 >= 1) && (j >= 1) && (cu & 4);
      const bool ext_f = left_ok && (j - 1 >= 1) && (i >= 1) && (cl & 8);

      const int emit = (b_ins || ins) ? OP_I
                     : (b_del || dele) ? OP_D
                     : (diag || esc) ? OP_M : 0;
      if (diag || esc || b_ins || ins) --i;
      if (diag || esc || b_del || dele) --j;
      if (ins) st = ext_e ? 1 : 0;
      else if (dele) st = ext_f ? 2 : 0;

      if (emit == cur_op) {
        ++cur_run;
      } else {
        if (cur_op) { ops[nseg] = (uint8_t)cur_op; runs[nseg] = cur_run; ++nseg; }
        cur_op = emit;
        cur_run = 1;
      }
    }
    if (cur_op) { ops[nseg] = (uint8_t)cur_op; runs[nseg] = cur_run; ++nseg; }
    cig_len[pair] = nseg;
  }
  nseg = __shfl_sync(FULL, nseg, 0);   // also orders lane 0's stores
  __syncwarp();

  // Walk order -> path order.
  for (int s = lane; s < nseg / 2; s += 32) {
    const int e = nseg - 1 - s;
    const uint8_t o = ops[s]; ops[s] = ops[e]; ops[e] = o;
    const int r = runs[s]; runs[s] = runs[e]; runs[e] = r;
  }
  for (int s = nseg + lane; s < T; s += 32) { ops[s] = 0; runs[s] = 0; }
}

}  // namespace

// Launches the walker on `stream` for N pairs. Returns the CUDA error code
// of the launch (0 = success). Allocates nothing, does not synchronise.
extern "C" int traceback_launch(
    const void* tb, const void* los, const void* start_i, const void* start_j,
    void* cig_ops, void* cig_runs, void* cig_len,
    int N, int T, int Bp, int band, void* stream) {
  if (N <= 0 || T <= 0) return 0;
  const int warps_per_block = 4;
  const int blocks = (N + warps_per_block - 1) / warps_per_block;
  traceback_kernel<<<blocks, warps_per_block * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tb, (const int*)los, (const int*)start_i,
      (const int*)start_j, (uint8_t*)cig_ops, (int*)cig_runs, (int*)cig_len,
      N, T, Bp, band);
  return (int)cudaGetLastError();
}
