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
// Design: one warp per anchor set, `WARPS` sets per block, no block-wide
// barrier. Slot j lives on lane j % 32 in register j / 32: f, pred and the
// slot's read / reference position and valid bit stay in registers for
// A <= 256 (`chain_kernel<S>`: S = 4 registers a lane for every A <= 128,
// the main path's A = 128 among them, S = 8 up to 256). Above 256 f and pred live in the warp's share
// of shared memory (`chain_kernel<0>`). Positions and valid flags are
// staged once in the warp's shared memory, from which every lane reads the
// broadcast q[i], r[i], valid[i] of the step.
//
//   * Only live slots are stepped. A ballot over valid finds the last valid
//     slot L, and the loop runs i = 0 .. L; a step whose slot is not valid
//     is skipped by the whole warp (f stays NEG, pred -1). A set with no
//     valid slot writes NEG / -1 / 0 and endpoint -1 at once.
//   * At step i only slots j < i form a candidate: a lane leaves its
//     register loop at the first register s with s * 32 >= i.
//   * Each lane keeps its own leftmost maximum, scanning its registers
//     upward with a strict >; one `__reduce_max_sync` gives the maximum
//     and one `__reduce_min_sync` the lowest slot among the lanes that
//     hold it. Lane i % 32 stores f[i] and pred[i] into register i / 32 by
//     an unrolled select (a register index must be known when compiling).
//   * The endpoint is the same two-step reduction over all A slots; lane 0
//     walks pred (copied to shared memory) for at most A steps, and the
//     write-out is coalesced: register s of the 32 lanes is 32 consecutive
//     slots.
//
// Why skipping slots j >= i, and steps past L, is exact. In the reference
// a slot j >= i still holds f[j] = NEG when slot i is scored (f is written
// in order), so where ok holds its candidate is NEG + gain <= NEG + k. A
// valid j < i has f[j] >= k and a candidate >= k + gain, far above that for
// any gain above NEG (every max_dd with max_dd * k < 2^31); an invalid j
// fails ok and gives NEG. So either the maximum lies among j < i, with the
// same leftmost slot, or best <= NEG + k: then extend is false and f[i]
// and pred[i] do not depend on which slot won. An invalid i gives NEG / -1
// whatever the candidates, and every i > L is invalid. None of this needs
// sorted positions or a prefix mask.
//
// What bounds it on an H100: the dependent steps of one set (a shared
// broadcast, a short register scan, two warp reductions and the select) —
// a serial chain per set whose length is the set's live slots, not A.
// Parallelism comes from the number of sets, eight warps a block; the
// bytes (positions in, f / pred / mask out) are small beside it (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;
// Anchor sets (warps) a block takes, and the dynamic shared memory a block
// may use without an opt-in.
constexpr int WARPS = 8;
constexpr int SMEM_BUDGET = 48 * 1024;
// Most slots kept in registers (8 a lane).
constexpr int MAX_REG_SLOTS = 256;

__device__ __forceinline__ int gap_cost(int dd, int k) {
  // dd >= 0, so truncating division is the reference's floor division.
  const int lin = (dd * k) / 100;
  const int lg = dd > 0 ? (31 - __clz(dd + 1)) / 2 : 0;
  return lin + lg;
}

// The candidate of slot j (positions qj, rj, valid vj, score fj) for the
// anchor at (qi, ri): f[j] + gain(j, i) where ok(j, i) holds, else NEG.
__device__ __forceinline__ int candidate(int qi, int ri, int qj, int rj,
                                         bool vj, int fj, int k, int max_gap,
                                         int max_dd) {
  // Positions are >= 0, so these differences cannot overflow; the unsigned
  // casts only keep the compiler from assuming they do not.
  const int dq = (int)((unsigned)qi - (unsigned)qj);
  const int dr = (int)((unsigned)ri - (unsigned)rj);
  const int diff = (int)((unsigned)dr - (unsigned)dq);
  const int dd = (int)(diff < 0 ? 0u - (unsigned)diff : (unsigned)diff);
  const bool ok = vj && dq > 0 && dr > 0 && dq <= max_gap && dr <= max_gap &&
                  dd >= 0 && dd <= max_dd;
  // gain is formed only where ok holds, where it cannot overflow.
  return ok ? fj + (min(min(dq, dr), k) - gap_cost(dd, k)) : NEG;
}

// Leftmost maximum over the warp of each lane's (best, slot): every lane
// gets the maximum and the lowest slot holding it.
__device__ __forceinline__ void warp_argmax(int best, unsigned slot,
                                            int& wbest, unsigned& wslot) {
  wbest = __reduce_max_sync(FULL, best);
  wslot = __reduce_min_sync(FULL, best == wbest ? slot : NONE);
}

// One warp's shared memory for A slots: positions, pred (for the walk;
// also f with S == 0), and the valid flags, later the best-chain mask.
struct Smem {
  int* q;
  int* r;
  int* pred;
  int* f;
  uint8_t* flag;
};

__host__ __device__ inline int warp_smem_bytes(int A, bool f_shared) {
  return (4 * A * (f_shared ? 4 : 3) + A + 15) & ~15;
}

template <int S>
__global__ void chain_kernel(
    const int* __restrict__ qp, const int* __restrict__ rp,
    const uint8_t* __restrict__ valid, int* __restrict__ f_out,
    int* __restrict__ pred_out, uint8_t* __restrict__ mask_out,
    int* __restrict__ best_out, int R, int A, int k, int max_gap,
    int max_dd) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr bool SHARED = S == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long set = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (set >= R) return;                 // whole warps leave together
  const long long base = set * A;
  uint8_t* mine = smem + warp * warp_smem_bytes(A, SHARED);
  const Smem sm{reinterpret_cast<int*>(mine),
                reinterpret_cast<int*>(mine) + A,
                reinterpret_cast<int*>(mine) + 2 * A,
                reinterpret_cast<int*>(mine) + 3 * A,
                mine + 4 * A * (SHARED ? 4 : 3)};

  // Stage positions and flags; f = NEG, pred = -1 everywhere.
  for (int j = lane; j < A; j += 32) {
    sm.q[j] = qp[base + j];
    sm.r[j] = rp[base + j];
    sm.flag[j] = valid[base + j];
    if (SHARED) {
      sm.f[j] = NEG;
      sm.pred[j] = -1;
    }
  }
  __syncwarp();

  // Registers of the lane's slots j = s * 32 + lane (S > 0).
  constexpr int SR = SHARED ? 1 : S;
  int f[SR], pred[SR], qj[SR], rj[SR];
  unsigned vbits = 0;
  if (!SHARED) {
#pragma unroll
    for (int s = 0; s < SR; ++s) {
      const int j = s * 32 + lane;
      const bool in = j < A;
      f[s] = NEG;
      pred[s] = -1;
      qj[s] = in ? sm.q[j] : 0;
      rj[s] = in ? sm.r[j] : 0;
      vbits |= (in && sm.flag[j]) ? 1u << s : 0u;
    }
  }

  // The last valid slot L.
  int last = -1;
  for (int c = 0; c * 32 < A; ++c) {
    const int j = c * 32 + lane;
    const unsigned bal = __ballot_sync(FULL, j < A && sm.flag[j]);
    if (bal) last = c * 32 + 31 - __clz(bal);
  }
  if (last < 0) {
    for (int j = lane; j < A; j += 32) {
      f_out[base + j] = NEG;
      pred_out[base + j] = -1;
      mask_out[base + j] = 0;
    }
    if (lane == 0) best_out[set] = -1;
    return;
  }

  for (int i = 0; i <= last; ++i) {
    if (!sm.flag[i]) continue;          // the same answer on every lane
    const int qi = sm.q[i], ri = sm.r[i];
    int lbest = NEG;
    unsigned lslot = NONE;
    if (SHARED) {
      for (int j = lane; j < i; j += 32) {
        const int c = candidate(qi, ri, sm.q[j], sm.r[j], sm.flag[j],
                                sm.f[j], k, max_gap, max_dd);
        if (c > lbest) { lbest = c; lslot = (unsigned)j; }
      }
    } else {
#pragma unroll
      for (int s = 0; s < SR; ++s) {
        if (s * 32 >= i) break;
        const int j = s * 32 + lane;
        const int c = candidate(qi, ri, qj[s], rj[s],
                                j < i && ((vbits >> s) & 1u), f[s], k,
                                max_gap, max_dd);
        if (c > lbest) { lbest = c; lslot = (unsigned)j; }
      }
    }
    int wbest;
    unsigned wslot;
    warp_argmax(lbest, lslot, wbest, wslot);
    const bool extend = wbest > k;      // strict: ties start a fresh chain
    const int fi = extend ? wbest : k;
    const int pi = extend ? (int)wslot : -1;
    if (lane == (i & 31)) {
      if (SHARED) {
        sm.f[i] = fi;
        sm.pred[i] = pi;
      } else {
#pragma unroll
        for (int s = 0; s < SR; ++s) {
          if (s == (i >> 5)) { f[s] = fi; pred[s] = pi; }
        }
      }
    }
    if (SHARED) __syncwarp();
  }

  // ---- endpoint: leftmost argmax of f (slot `last` is valid, so > NEG) --
  int lbest = NEG;
  unsigned lslot = NONE;
  if (SHARED) {
    for (int j = lane; j < A; j += 32) {
      if (sm.f[j] > lbest) { lbest = sm.f[j]; lslot = (unsigned)j; }
    }
  } else {
#pragma unroll
    for (int s = 0; s < SR; ++s) {
      const int j = s * 32 + lane;
      if (j < A) {
        sm.pred[j] = pred[s];
        if (f[s] > lbest) { lbest = f[s]; lslot = (unsigned)j; }
      }
    }
  }
  int fmax;
  unsigned end;
  warp_argmax(lbest, lslot, fmax, end);
  __syncwarp();                         // every lane's reads of the flags
  for (int j = lane; j < A; j += 32) sm.flag[j] = 0;
  __syncwarp();
  if (lane == 0) {
    for (int cur = (int)end, s = 0; cur >= 0 && s < A; ++s) {
      sm.flag[cur] = 1;
      cur = sm.pred[cur];
    }
    best_out[set] = (int)end;
  }
  __syncwarp();

  if (SHARED) {
    for (int j = lane; j < A; j += 32) {
      f_out[base + j] = sm.f[j];
      pred_out[base + j] = sm.pred[j];
      mask_out[base + j] = sm.flag[j];
    }
  } else {
#pragma unroll
    for (int s = 0; s < SR; ++s) {
      const int j = s * 32 + lane;
      if (j < A) {
        f_out[base + j] = f[s];
        pred_out[base + j] = pred[s];
        mask_out[base + j] = sm.flag[j];
      }
    }
  }
}

template <int S>
int launch(const void* qp, const void* rp, const void* valid, void* f,
           void* pred, void* mask, void* best, int R, int A, int k,
           int max_gap, int max_dd, cudaStream_t stream) {
  const int per_warp = warp_smem_bytes(A, S == 0);
  int warps = SMEM_BUDGET / per_warp;
  warps = warps < 1 ? 1 : (warps > WARPS ? WARPS : warps);
  const int blocks = (R + warps - 1) / warps;
  chain_kernel<S><<<blocks, warps * 32, (size_t)warps * per_warp, stream>>>(
      (const int*)qp, (const int*)rp, (const uint8_t*)valid, (int*)f,
      (int*)pred, (uint8_t*)mask, (int*)best, R, A, k, max_gap, max_dd);
  return (int)cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  if (A <= 128)
    return launch<4>(qp, rp, valid, f, pred, mask, best, R, A, k, max_gap,
                     max_dd, s);
  if (A <= MAX_REG_SLOTS)
    return launch<8>(qp, rp, valid, f, pred, mask, best, R, A, k, max_gap,
                     max_dd, s);
  return launch<0>(qp, rp, valid, f, pred, mask, best, R, A, k, max_gap,
                   max_dd, s);
}
