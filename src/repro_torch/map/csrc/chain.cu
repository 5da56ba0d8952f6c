// Anchor chaining DP with best-chain backtrack, for sm_90a.
//
// Replaces the jit'd device loop `_chain_one` (a `fori_loop` over the A
// anchor slots, vmapped over reads) of src/repro/map/chain.py:
//
//   f[i]    = valid[i] ? (best > k ? best : k) : NEG
//   best    = max_j (ok(j, i) ? f[j] + gain(j, i) : NEG), leftmost j
//   pred[i] = valid[i] && best > k ? j : -1
//
// with gain = min(dq, dr, k) - (dd * k / 100 + floor(log2(dd + 1)) / 2)
// and ok = 0 < dq, dr <= max_gap, dd = |dr - dq| <= max_dd, valid[j];
// then the membership mask of the chain ending at the leftmost argmax of f
// and that endpoint (-1 when no slot is valid).
//
// Design: one block per anchor set, one thread per slot. Thread j keeps
// f[j] and pred[j] in registers; slots j >= i still hold NEG when slot i
// is scored, exactly as in the reference (f is written in order). For
// each i every thread forms its candidate, each warp reduces it to
// (max, lowest lane) with `__reduce_max_sync` / `__reduce_min_sync`, and
// the warps' results are joined in lane order behind one barrier per i
// (the partials are double-buffered by the parity of i). Thread i applies
// the update to its own registers. The backtrack is a walk of at most A
// steps by one thread through pred in shared memory.
//
// What bounds it on an H100: the A dependent steps, each a barrier and
// two warp reductions — a serial chain per anchor set, not bytes or int32
// throughput (see PERF.md). Parallelism comes from the number of sets.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 30);
constexpr int MAX_WARPS = 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int gap_cost(int dd, int k) {
  // dd >= 0, so truncating division is the reference's floor division.
  const int lin = (dd * k) / 100;
  const int lg = dd > 0 ? (31 - __clz(dd + 1)) / 2 : 0;
  return lin + lg;
}

// Leftmost maximum of (v, slot) over the block: per-warp reductions,
// joined in warp order through `red` (2 * MAX_WARPS ints) behind one
// barrier. Every thread gets the result.
__device__ __forceinline__ void block_argmax(int v, int slot, int* red,
                                             int& best, int& arg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int w_max = __reduce_max_sync(FULL, v);
  const unsigned w_arg =
      __reduce_min_sync(FULL, v == w_max ? (unsigned)slot : 0xffffffffu);
  if (lane == 0) {
    red[warp] = w_max;
    red[MAX_WARPS + warp] = (int)w_arg;
  }
  __syncthreads();
  best = red[0];
  arg = red[MAX_WARPS];
  for (int w = 1; w < nwarps; ++w) {
    if (red[w] > best) { best = red[w]; arg = red[MAX_WARPS + w]; }
  }
}

__global__ void chain_kernel(
    const int* __restrict__ qp, const int* __restrict__ rp,
    const uint8_t* __restrict__ valid, int* __restrict__ f_out,
    int* __restrict__ pred_out, uint8_t* __restrict__ mask_out,
    int* __restrict__ best_out, int A, int k, int max_gap, int max_dd) {
  extern __shared__ int smem[];
  int* sq = smem;                       // (A,)
  int* sr = sq + A;                     // (A,)
  int* sv = sr + A;                     // (A,) valid, then best-chain mask
  int* spred = sv + A;                  // (A,)
  int* red = spred + A;                 // [2 parities][2][MAX_WARPS]

  const long long set = blockIdx.x;
  const int j = threadIdx.x;
  const bool slot = j < A;
  const long long base = set * A;
  if (slot) {
    sq[j] = qp[base + j];
    sr[j] = rp[base + j];
    sv[j] = valid[base + j];
  }
  __syncthreads();
  const int qj = slot ? sq[j] : 0, rj = slot ? sr[j] : 0;
  const bool vj = slot && sv[j];
  int f = NEG, pred = -1;

  for (int i = 0; i < A; ++i) {
    // Positions are >= 0, so these differences cannot overflow; the
    // unsigned casts only keep the compiler from assuming they do not.
    const int dq = (int)((unsigned)sq[i] - (unsigned)qj);
    const int dr = (int)((unsigned)sr[i] - (unsigned)rj);
    const int diff = (int)((unsigned)dr - (unsigned)dq);
    const int dd = (int)(diff < 0 ? 0u - (unsigned)diff : (unsigned)diff);
    const bool ok = slot && vj && dq > 0 && dr > 0 && dq <= max_gap &&
                    dr <= max_gap && dd >= 0 && dd <= max_dd;
    // gain is formed only where ok holds, where it cannot overflow.
    const int cand = ok ? f + (min(min(dq, dr), k) - gap_cost(dd, k)) : NEG;
    int best, arg;
    block_argmax(slot ? cand : NEG, slot ? j : 0x7fffffff,
                 red + (i & 1) * 2 * MAX_WARPS, best, arg);
    if (j == i) {
      const bool extend = best > k;     // strict: ties start a fresh chain
      f = vj ? (extend ? best : k) : NEG;
      pred = vj && extend ? arg : -1;
    }
  }

  // ---- backtrack from the leftmost argmax of f ----
  // The partials go to the parity the last step did not use: threads may
  // still be reading that step's.
  if (slot) spred[j] = pred;
  int fmax, best_idx;
  block_argmax(slot ? f : NEG, slot ? j : 0x7fffffff,
               red + (A & 1) * 2 * MAX_WARPS, fmax, best_idx);
  if (!(fmax > NEG)) best_idx = -1;
  if (slot) sv[j] = 0;
  __syncthreads();
  if (j == 0) {
    for (int cur = best_idx, s = 0; cur >= 0 && s < A; ++s) {
      sv[cur] = 1;
      cur = spred[cur];
    }
    best_out[set] = best_idx;
  }
  __syncthreads();
  if (slot) {
    f_out[base + j] = f;
    pred_out[base + j] = pred;
    mask_out[base + j] = (uint8_t)sv[j];
  }
}

}  // namespace

// Launches the chainer on `stream` for R anchor sets of A slots (A at most
// 1024). Returns the CUDA error code of the launch (0 = success). Allocates
// nothing and does not synchronise.
extern "C" int chain_launch(
    const void* qp, const void* rp, const void* valid, void* f, void* pred,
    void* mask, void* best, int R, int A, int k, int max_gap, int max_dd,
    void* stream) {
  if (R <= 0) return 0;
  if (A < 1 || A > 1024) return (int)cudaErrorInvalidValue;
  const int threads = ((A + 31) / 32) * 32;
  const size_t smem = (size_t)(4 * A + 2 * 2 * MAX_WARPS) * sizeof(int);
  chain_kernel<<<R, threads, smem, (cudaStream_t)stream>>>(
      (const int*)qp, (const int*)rp, (const uint8_t*)valid, (int*)f,
      (int*)pred, (uint8_t*)mask, (int*)best, A, k, max_gap, max_dd);
  return (int)cudaGetLastError();
}
