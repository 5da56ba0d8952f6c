// Traceback walker with run-length encoding, for sm_90a.
//
// Replaces the jit'd device loop `decode_packed_tb` (a `lax.scan` over T
// lockstep iterations plus a gather / cumsum / scatter RLE pass) of
// src/repro/core/traceback_device.py. The output layout is the contract,
// not the method: cig_ops (N, K) uint8, cig_runs (N, K) int32, cig_len
// (N,) int32, runs in path order, columns >= cig_len zero.
//
// A second entry point, `traceback_table_launch`, walks every row of a
// persistent request (kernels/banded_dp/csrc/persistent.cu) in one launch:
// each row has its own band, sweep length and plane offsets from the work
// table, and writes one row of (R, K) RLE planes, zero past its segments.
//
// Design: one warp per pair, and the walk reads only shared memory. Lane 0
// chases the path from the start cell to (0, 0) — each step reads the
// three nibbles at (i, j), (i-1, j), (i, j-1) through `los` and applies
// the M/I/D state machine with the band-escape diagonal fallback and the
// forced boundary gaps — and run-length encodes while it walks.
//
//   * The plane is staged in windows. A step at t = i + j reads band
//     offsets t and t-1 and flag rows t-1 and t-2 (each index clamped to
//     the plane as the reference clamps it), and every step lowers t by 1
//     or 2. A window is W consecutive flag rows [lo, hi] and the W + 1
//     band offsets [lo, hi + 1]; it serves every step whose lowest row,
//     clamp(t - 2), is >= lo. The next window is rows [lo + 2 - W, lo + 1]:
//     the step that leaves a window lands at t = lo + 1 or lo, which it
//     serves for W >= 4, so the whole sequence of windows is fixed before
//     the walk reaches it. W is sized from the band
//     (`traceback_window_rows`: about 12.8 KB of flags, 32..1024 rows, at
//     most the sweep).
//   * Two buffers per warp: while lane 0 walks one window, all 32 lanes'
//     `cp.async` copies fill the other with the next. A window is one
//     contiguous byte range of the plane (and one of `los`); plane offsets
//     are not 16-byte aligned, so the copy takes the 16-byte chunks that
//     cover the range and places the range at the same offset mod 16 in
//     shared memory. The bytes it reads outside the range lie in a 16-byte
//     chunk that also holds a byte of the range, so they never leave
//     mapped memory; they land in shared memory no step reads.
//   * Segments go to a shared ring of `SEGS`. When it fills, the warp
//     writes it, coalesced, to the END of the pair's RLE row in reverse
//     walk order (walk segment w at column K-1-w: path order, shifted). At
//     the end the warp moves that part down to where it belongs, writes
//     the ring's last segments reversed from shared memory in front of it
//     and zeroes the rest of the row. A path of up to `SEGS` segments is
//     reversed in shared memory alone.
//   * Several warps per block, `1 + (N - 1) / 132` up to 4, so that a
//     launch of a few dozen pairs spreads over as many SMs; dynamic shared
//     memory is sized by the launch's widest window.
//
// What bounds it on an H100: latency. A step is two dependent shared-memory
// loads (the band offset, then the flag bytes) and the state machine on a
// single lane, so the time is (path length) x (step latency), far above the
// bytes it moves over the memory rate (see PERF.md). The window copies run
// behind the walk. Parallelism comes only from the number of pairs in
// flight. Fusing the walk behind the wavefront kernel, while the plane is
// still in L2, is left to later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "../../kernels/banded_dp/csrc/wavefront.cuh"
#include "../../kernels/banded_dp/csrc/work_table.cuh"

namespace {

using namespace work_table;
using wavefront::clampi;
using wavefront::zero_bytes;

constexpr unsigned FULL = 0xffffffffu;
constexpr int OP_M = 1, OP_I = 2, OP_D = 3;

// Window geometry: flag bytes a window aims at, and its least and most
// rows (`traceback_window_rows`).
constexpr int WINDOW_BYTES = 12800;
constexpr int WINDOW_MIN_ROWS = 32, WINDOW_MAX_ROWS = 1024;
// RLE segments a warp holds in shared memory.
constexpr int SEGS = 256;
constexpr int MAX_WARPS_PER_BLOCK = 4;
constexpr int SMS = 132;

__host__ __device__ inline int window_rows(int band, int T) {
  const int Bp = (band + 1) >> 1;
  int W = WINDOW_BYTES / Bp;
  W = W < WINDOW_MIN_ROWS ? WINDOW_MIN_ROWS
    : (W > WINDOW_MAX_ROWS ? WINDOW_MAX_ROWS : W);
  return W < T ? W : T;
}

__host__ __device__ inline int round16(int b) { return (b + 15) & ~15; }

// Shared memory of one warp: nbuf x (flags, band offsets), then the ring.
struct Smem {
  int flag_bytes, los_bytes, nbuf;
  __host__ __device__ int buf_bytes() const { return flag_bytes + los_bytes; }
  __host__ __device__ int warp_bytes() const {
    return nbuf * buf_bytes() + SEGS * 5;
  }
};

// Smem for windows of at most `flag_cap` flag bytes and `rows_cap` rows;
// one buffer when no pair needs a second window. 32 bytes of slack each:
// the head offset mod 16 and the tail chunk of an unaligned copy.
__host__ inline Smem smem_for(int flag_cap, int rows_cap, int nbuf) {
  return Smem{round16(flag_cap + 32), round16(4 * (rows_cap + 1) + 32),
              nbuf};
}

// The M/I/D state machine of one step at (i, j) in state st, from the
// flags of (i, j) (its band test and direction d), of (i-1, j) and of
// (i, j-1) (band tests and flags): moves (i, j), updates st and returns
// the op emitted (every step of an unfinished walk emits one).
__device__ __forceinline__ int advance(int& i, int& j, int& st, bool in_band,
                                       int d, bool up_ok, int cu,
                                       bool left_ok, int cl) {
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
  i -= (diag || esc || b_ins || ins);
  j -= (diag || esc || b_del || dele);
  st = ins ? (ext_e ? 1 : 0) : (dele ? (ext_f ? 2 : 0) : st);
  return emit;
}

// The flags of band lane k in `row`. A lane outside [0, band) reads lane
// band - 1 instead: its value is never used (every use is gated by the
// lane's band test), and the read stays inside the row.
__device__ __forceinline__ int nibble(const uint8_t* row, int k, int band) {
  const unsigned kc = min((unsigned)k, (unsigned)band - 1u);
  return row[kc >> 1] >> ((kc & 1u) << 2);
}

// One step of the staged walker at t = i + j >= 1, from a window whose
// first flag row and band offset (row and offset `lo` of the plane) are at
// F and L. It makes the plain walker's three lookups (`lookup` in
// core/traceback_device.py: for a cell at s = ii + jj, lane k = ii -
// los[clamp(s, 0, T)], flags of lane clamp(k) in row clamp(s - 1, 0, T - 1),
// in band when s >= 1 and 0 <= k < band) with the clamps that t >= 1 makes
// identities dropped, the two neighbour lookups sharing their band offset
// and row, band tests as one unsigned compare, and the clamp of an
// out-of-band lane (whose flags are never used) as one unsigned min.
__device__ __forceinline__ int staged_step(const uint8_t* F, const int* L,
                                           int lo, int T, int Bp, int band,
                                           int& i, int& j, int& st) {
  const int t = i + j;
  const int k = i - L[min(t, T) - lo];
  const int ku = i - 1 - L[min(t - 1, T) - lo];   // (i-1, j); (i, j-1): ku+1
  const uint8_t* row = F + (min(t - 1, T - 1) - lo) * Bp;
  const uint8_t* nrow = F + (max(min(t - 2, T - 1), 0) - lo) * Bp;
  const unsigned B = (unsigned)band;
  return advance(i, j, st, (unsigned)k < B, nibble(row, k, band) & 3,
                 t >= 2 && (unsigned)ku < B, nibble(nrow, ku, band),
                 t >= 2 && (unsigned)(ku + 1) < B,
                 nibble(nrow, ku + 1, band));
}

// ---------------------------------------------------------------------------
// The staged walker.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copies global bytes [src, src + len) to shared memory at dst + (src mod
// 16) (dst 16-byte aligned) with the warp's 16-byte cp.async, the covering
// chunks only. Returns src mod 16.
__device__ __forceinline__ int stage(uint8_t* dst, const void* src, int len,
                                     int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = a & ~(uintptr_t)15;
  const int chunks = len > 0 ? (int)((a + len + 15 - a0) >> 4) : 0;
  for (int c = lane; c < chunks; c += 32)
    cp_async16(dst + 16 * c, reinterpret_cast<const void*>(a0 + 16 * c));
  return (int)(a & 15);
}

// One window of a pair: flag rows [lo, hi], band offsets [lo, hi + 1].
struct Span {
  int lo, hi;
};

__device__ __forceinline__ Span next_span(Span s, int W) {
  const int hi = s.lo + 1;
  return Span{hi - W + 1 > 0 ? hi - W + 1 : 0, hi};
}

// Issues the copies of window `s` into buffer `buf`; returns the shared
// offsets of flag row s.lo and band offset s.lo.
__device__ __forceinline__ void stage_window(
    uint8_t* buf, const Smem& sm, const uint8_t* tb, const int* los, int Bp,
    Span s, int lane, int& tb_off, int& los_off) {
  tb_off = stage(buf, tb + (long long)s.lo * Bp, (s.hi - s.lo + 1) * Bp,
                 lane);
  los_off = stage(buf + sm.flag_bytes, los + s.lo, 4 * (s.hi - s.lo + 2),
                  lane);
}

// Walks one pair from (i, j) to (0, 0) with the warp through its staged
// windows; writes cig_len and K columns of ops / runs (segments in path
// order, zero past them). `smem` is this warp's share.
__device__ __forceinline__ void walk_staged(
    const uint8_t* tb, const int* los, int T, int band, int i, int j,
    uint8_t* ops, int* runs, int* len, int K, uint8_t* smem, Smem sm) {
  const int lane = threadIdx.x & 31;
  const int Bp = (band + 1) >> 1;
  uint8_t* ring_ops = smem + sm.nbuf * sm.buf_bytes();
  int* ring_runs = reinterpret_cast<int*>(ring_ops + SEGS);

  const int t0 = i + j;
  int flushed = 0, nring = 0;
  if (t0 > 0 && T > 0) {
    const int W = window_rows(band, T);
    Span cur{0, clampi(t0 - 1, 0, T - 1)};
    cur.lo = cur.hi - W + 1 > 0 ? cur.hi - W + 1 : 0;
    int b = 0;                                   // buffer of `cur`
    int tb_off[2], los_off[2];
    stage_window(smem, sm, tb, los, Bp, cur, lane, tb_off[0], los_off[0]);
    cp_async_commit();
    if (cur.lo > 0)
      stage_window(smem + sm.buf_bytes(), sm, tb, los, Bp, next_span(cur, W),
                   lane, tb_off[1], los_off[1]);
    cp_async_commit();
    cp_async_wait_prior();
    __syncwarp();

    // Lane 0's walk state lives across windows and flushes.
    int st = 0, cur_op = 0, cur_run = 0, step = 0;
    for (;;) {
      // 0: the next step needs the next window; 1: the ring is full;
      // 2: the walk has ended and its last segment is in the ring.
      int why = 0;
      if (lane == 0) {
        const uint8_t* buf = smem + b * sm.buf_bytes();
        const uint8_t* F = buf + tb_off[b];
        const int* L = reinterpret_cast<const int*>(buf + sm.flag_bytes +
                                                    los_off[b]);
        // The lowest t this window serves: clamp(t - 2) >= cur.lo.
        const int t_min = cur.lo > 0 ? cur.lo + 2 : 1;
        int t = i + j;
        while (step < T && t >= t_min && nring < SEGS) {
          const int emit = staged_step(F, L, cur.lo, T, Bp, band, i, j, st);
          t = i + j;
          ++step;
          const bool next = emit != cur_op;
          const bool push = next && cur_op;
          if (push) {
            ring_ops[nring] = (uint8_t)cur_op;
            ring_runs[nring] = cur_run;
          }
          nring += push;
          cur_run = next ? 1 : cur_run + 1;
          cur_op = emit;
        }
        if (step >= T || t == 0) {               // the walk has ended
          why = 2;
          if (cur_op && nring == SEGS) {
            why = 1;
          } else if (cur_op) {
            ring_ops[nring] = (uint8_t)cur_op;
            ring_runs[nring] = cur_run;
            ++nring;
            cur_op = 0;
          }
        } else {
          why = t < t_min ? 0 : 1;
        }
      }
      why = __shfl_sync(FULL, why, 0);
      nring = __shfl_sync(FULL, nring, 0);
      __syncwarp();                              // the ring, for all lanes
      if (why == 2) break;
      if (why == 1) {
        // Walk segment w goes to column K-1-w.
        for (int s = lane; s < nring; s += 32) {
          ops[K - 1 - flushed - s] = ring_ops[s];
          runs[K - 1 - flushed - s] = ring_runs[s];
        }
        flushed += nring;
        nring = 0;
        __syncwarp();
        continue;
      }
      // Into the next window, which is in the other buffer; its successor
      // goes into the buffer just left.
      cur = next_span(cur, W);
      b ^= 1;
      if (cur.lo > 0)
        stage_window(smem + (b ^ 1) * sm.buf_bytes(), sm, tb, los, Bp,
                     next_span(cur, W), lane, tb_off[b ^ 1], los_off[b ^ 1]);
      cp_async_commit();
      cp_async_wait_prior();
      __syncwarp();
    }
  }

  // Path order: segment p is walk segment nseg-1-p. The flushed walk
  // segments [0, flushed) sit at columns [K - flushed, K) and move down
  // by K - nseg to [nseg - flushed, nseg), 32 at a time in ascending
  // order (a chunk's sources lie above every earlier chunk's targets);
  // the ring's walk segments [flushed, nseg) fill [0, nring).
  const int nseg = flushed + nring;
  const int shift = K - nseg;
  if (shift > 0) {
    for (int p0 = nseg - flushed; p0 < nseg; p0 += 32) {
      const int p = p0 + lane;
      uint8_t o = 0;
      int r = 0;
      if (p < nseg) { o = ops[p + shift]; r = runs[p + shift]; }
      __syncwarp();
      if (p < nseg) { ops[p] = o; runs[p] = r; }
      __syncwarp();
    }
  }
  for (int p = lane; p < nring; p += 32) {
    ops[p] = ring_ops[nring - 1 - p];
    runs[p] = ring_runs[nring - 1 - p];
  }
  zero_bytes(ops, nseg, K, lane, 32);
  zero_bytes(reinterpret_cast<uint8_t*>(runs), 4LL * nseg, 4LL * K, lane, 32);
  if (lane == 0) *len = nseg;
}

__global__ void traceback_kernel(
    const uint8_t* __restrict__ tb, const int* __restrict__ los,
    const int* __restrict__ start_i, const int* __restrict__ start_j,
    uint8_t* __restrict__ cig_ops, int* __restrict__ cig_runs,
    int* __restrict__ cig_len, int N, int T, int Bp, int band, Smem sm) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int pair = blockIdx.x * (blockDim.x >> 5) + warp;
  if (pair >= N) return;            // whole warps leave together
  walk_staged(tb + (long long)pair * T * Bp, los + (long long)pair * (T + 1),
              T, band, start_i[pair], start_j[pair],
              cig_ops + (long long)pair * T, cig_runs + (long long)pair * T,
              cig_len + pair, T, smem + warp * sm.warp_bytes(), sm);
}

// One warp per table row: each row has its own band, sweep length and
// plane offsets; its RLE row is K = max sweep wide.
__global__ void traceback_table_kernel(
    const long long* __restrict__ table, const uint8_t* __restrict__ tb,
    const int* __restrict__ los, const int* __restrict__ start_i,
    const int* __restrict__ start_j, uint8_t* __restrict__ cig_ops,
    int* __restrict__ cig_runs, int* __restrict__ cig_len, int R, int K,
    Smem sm) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int w = blockIdx.x * (blockDim.x >> 5) + warp;
  if (w >= R) return;
  const long long* e = table + (long long)w * NCOL;
  const int row = (int)e[ROW], band = (int)e[BAND];
  walk_staged(tb + e[TB_OFF], los + e[LOS_OFF], (int)e[STEPS], band,
              start_i[row], start_j[row], cig_ops + (long long)row * K,
              cig_runs + (long long)row * K, cig_len + row, K,
              smem + warp * sm.warp_bytes(), sm);
}

// Warps per block of a staged launch over `n` pairs, and its block count.
inline int staged_warps(int n) {
  const int w = 1 + (n - 1) / SMS;
  return w < MAX_WARPS_PER_BLOCK ? w : MAX_WARPS_PER_BLOCK;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// Rows of a staged window of `band` in a plane of `T` rows (the wrappers
// size the table launch's shared memory from it).
extern "C" int traceback_window_rows(int band, int T) {
  return window_rows(band, T);
}

// Launches the walker on `stream` for N pairs. Returns the CUDA error code
// of the launch (0 = success). Allocates nothing, does not synchronise.
extern "C" int traceback_launch(
    const void* tb, const void* los, const void* start_i, const void* start_j,
    void* cig_ops, void* cig_runs, void* cig_len,
    int N, int T, int Bp, int band, void* stream) {
  if (N <= 0 || T <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int W = window_rows(band, T);
  const Smem sm = smem_for(W * Bp, W, W < T ? 2 : 1);
  const int warps = staged_warps(N);
  const size_t bytes = (size_t)warps * sm.warp_bytes();
  cudaError_t err = allow_smem(traceback_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  traceback_kernel<<<(N + warps - 1) / warps, warps * 32, bytes, s>>>(
      (const uint8_t*)tb, (const int*)los, (const int*)start_i,
      (const int*)start_j, (uint8_t*)cig_ops, (int*)cig_runs, (int*)cig_len,
      N, T, Bp, band, sm);
  return (int)cudaGetLastError();
}

// Launches the table walker on `stream` over the R rows of `table`; the
// RLE planes are (R, K) with K >= every row's sweep length. `flag_cap` /
// `rows_cap` are the most flag bytes / rows of any row's window and
// `two_windows` whether any row needs more than one (the wrapper computes
// them from the request's groups by `traceback_window_rows`). Returns the
// CUDA error code of the launch (0 = success).
extern "C" int traceback_table_launch(
    const void* table, const void* tb, const void* los, const void* start_i,
    const void* start_j, void* cig_ops, void* cig_runs, void* cig_len,
    int R, int K, int flag_cap, int rows_cap, int two_windows,
    void* stream) {
  if (R <= 0 || K <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Smem sm = smem_for(flag_cap, rows_cap, two_windows ? 2 : 1);
  const int warps = staged_warps(R);
  const size_t bytes = (size_t)warps * sm.warp_bytes();
  cudaError_t err = allow_smem(traceback_table_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  traceback_table_kernel<<<(R + warps - 1) / warps, warps * 32, bytes, s>>>(
      (const long long*)table, (const uint8_t*)tb, (const int*)los,
      (const int*)start_i, (const int*)start_j, (uint8_t*)cig_ops,
      (int*)cig_runs, (int*)cig_len, R, K, sm);
  return (int)cudaGetLastError();
}
