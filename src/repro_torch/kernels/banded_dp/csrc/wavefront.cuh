// One pair's adaptive banded affine-gap wavefront (paper Eq. (4)), run by
// one thread block: the body shared by the per-group kernel
// (banded_dp.cu) and the persistent one (persistent.cu). The design note
// is at the top of banded_dp.cu.
//
// A block may have more threads than the pair's band B (the persistent
// kernel sizes its blocks for the widest band of the request): threads
// k >= B are out-of-band lanes exactly like the lanes past B of a block
// whose B is not a multiple of 32. The shared layout is sized by B, so
// the pad column right of the band holds NEG and the adaptive test,
// must_down and the corner lane all read this pair's own B.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wavefront {

constexpr int NEG = -(1 << 28);
constexpr int DEAD = -(1 << 27);
constexpr int MAX_WARPS = 32;
constexpr unsigned FULL = 0xffffffffu;

struct Scoring {
  int match, mismatch, o, e, xdrop;
};

// One pair: where its inputs are and where its results go.
struct Row {
  const int8_t* q;      // (Lq,)
  const int8_t* r;      // (Lr,)
  int n, m, Lq, Lr;
  int T, B;             // sweep length, band
  int* stats;           // stats[k * stride] = result k of this pair
  long long stride;
  uint8_t* tb;          // (T, ceil(B/2)) or null
  int* los;             // (T + 1,) or null
};

// Shared memory (in ints) a block needs for bands up to B.
__host__ __device__ inline size_t smem_ints(int B) {
  return (size_t)(2 * 5 * (B + 2) + 2 * 3 * MAX_WARPS);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Zero bytes [from, to) of `p` with `nt` threads (this one is `tid`: the
// whole block, or one warp), 16 bytes a thread where the address allows it.
__device__ inline void zero_bytes(uint8_t* p, long long from, long long to,
                                  int tid, int nt) {
  uint8_t* a = p + from;
  long long len = to - from;
  if (len <= 0) return;
  long long head = (16 - (reinterpret_cast<uintptr_t>(a) & 15)) & 15;
  if (head > len) head = len;
  for (long long i = tid; i < head; i += nt) a[i] = 0;
  long long body = (len - head) / 16;
  uint4* a16 = reinterpret_cast<uint4*>(a + head);
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (long long i = tid; i < body; i += nt) a16[i] = z;
  for (long long i = head + body * 16 + tid; i < len; i += nt) a[i] = 0;
}

template <bool SEMI, bool ADAPTIVE, bool TB, bool XDROP>
__device__ __forceinline__ void align_row(const Row& R, const Scoring& S,
                                          int* smem) {
  const int B = R.B;
  const int W = B + 2;              // padded lane count
  // state[buf][plane][W]; planes: 0 H, 1 u, 2 v, 3 x, 4 y
  int* state = smem;
  int* red = smem + 2 * 5 * W;      // [2 parities][3 values][MAX_WARPS]

  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool in_band = k < B;

  const int n = R.n, m = R.m;
  const int nm = n + m;
  const int8_t* q = R.q;
  const int8_t* r = R.r;
  const int o = S.o, e = S.e, oe = o + e, shift = 2 * (o + e);
  const int Bp = (B + 1) >> 1;
  uint8_t* tb = R.tb;
  int* los = R.los;

  // Diagonal 0: only cell (0, 0) is alive. Pads: H dead, the rest 0.
  for (int idx = k; idx < 2 * 5 * W; idx += blockDim.x) {
    const int plane = (idx / W) % 5, col = idx % W;
    state[idx] = plane == 0 ? (col == 1 && idx < 5 * W ? 0 : NEG) : 0;
  }
  if (TB && k == 0) los[0] = 0;
  __syncthreads();

  int p = 0;                        // buffer holding the previous diagonal
  int lo = 0;
  int best = SEMI ? NEG : 0, best_i = 0, best_j = 0;
  int pair_best = 0, status = 0;
  const int t_end = nm < R.T ? nm : R.T;
  int t_live = 0;                   // live steps written so far

  for (int t = 1; t <= t_end; ++t) {
    const int* prev = state + p * 5 * W;
    int* cur = state + (p ^ 1) * 5 * W;

    // ---- direction (paper §IV-B2 + feasibility clamps), uniform ----
    const bool must_down = (lo + (nm - t)) < (n - B + 1);
    const bool must_right = lo >= n;
    bool heur_right;
    if (ADAPTIVE) {
      heur_right = prev[1] > prev[B];
    } else {
      // int32 arithmetic that wraps as two's complement does.
      const int lhs = (int)((unsigned)(2 * lo + B) * (unsigned)nm);
      const int rhs = (int)((unsigned)(2 * t) * (unsigned)n);
      heur_right = lhs >= rhs;
    }
    const bool go_down = must_down || (!must_right && !heur_right);
    const int lo_new = lo + (go_down ? 1 : 0);

    int H_new = NEG, code = 0, H_masked = NEG;
    if (in_band) {
      // down: up[k] = prev[k], left[k] = prev[k+1];
      // right: up[k] = prev[k-1], left[k] = prev[k]   (lane k at col k+1)
      const int up_c = go_down ? k + 1 : k;
      const int left_c = up_c + 1;
      const int up_H = prev[up_c], left_H = prev[left_c];
      const int left_u = prev[W + left_c];
      const int up_v = prev[2 * W + up_c];
      const int up_x = prev[3 * W + up_c];
      const int left_y = prev[4 * W + left_c];
      const bool up_valid = up_H > DEAD, left_valid = left_H > DEAD;

      const int i = lo_new + k, j = t - i;
      const bool valid = i >= 0 && i <= n && j >= 0 && j <= m;
      const bool interior = valid && i >= 1 && j >= 1;
      const bool brow = valid && i == 0 && j >= 1;
      const bool bcol = valid && j == 0 && i >= 1;

      const int qb = q[clampi(i - 1, 0, R.Lq - 1)];
      const int rb = r[clampi(j - 1, 0, R.Lr - 1)];
      const bool is_match = qb == rb && qb < 4 && rb < 4;
      const int s_sub = is_match ? S.match : -S.mismatch;

      // ---- Eq. (4) ----
      const int x_arm = up_valid ? up_x : NEG;
      const int y_arm = left_valid ? left_y : NEG;
      const int v_up = up_valid ? up_v : oe;
      const int u_left = left_valid ? left_u : oe;
      const int s_arm = (up_valid || left_valid) ? s_sub + shift : NEG;

      const int a_new = max(max(s_arm, x_arm), y_arm);
      int u_new = a_new - v_up;
      int v_new = a_new - u_left;
      int x_new = max(a_new, x_arm + o) - u_left;
      int y_new = max(a_new, y_arm + o) - v_up;
      H_new = up_valid ? up_H + u_new - oe
                       : (left_valid ? left_H + v_new - oe : NEG);

      if (TB && interior) {
        const int dir = a_new == s_arm ? 0 : (a_new == x_arm ? 1 : 2);
        code = dir + ((x_arm + o) > a_new ? 4 : 0)
                   + ((y_arm + o) > a_new ? 8 : 0);
      }

      // ---- boundary overrides ----
      if (brow) {
        if (SEMI) {
          v_new = oe; x_new = oe; H_new = 0;
        } else {
          v_new = x_new = (j == 1 ? 0 : o);
          H_new = -(o + j * e);
        }
        u_new = o; y_new = o;
      }
      if (bcol) {
        u_new = y_new = (i == 1 ? 0 : o);
        v_new = o; x_new = o;
        H_new = -(o + i * e);
      }
      if (!valid) { H_new = NEG; u_new = v_new = x_new = y_new = 0; }

      cur[k + 1] = H_new;
      cur[W + k + 1] = u_new;
      cur[2 * W + k + 1] = v_new;
      cur[3 * W + k + 1] = x_new;
      cur[4 * W + k + 1] = y_new;

      // Best-cell candidates: interior cells (retirement is settled
      // below, before the update is applied); semiglobal: last read row.
      const bool elig = interior && (!SEMI || i == n);
      H_masked = elig ? H_new : NEG;
    }

    // ---- per-warp reductions, joined behind the step barrier ----
    const int par = t & 1;
    int* redp = red + par * 3 * MAX_WARPS;
    const int w_cand = __reduce_max_sync(FULL, H_masked);
    const unsigned w_kbest = __reduce_min_sync(
        FULL, (in_band && H_masked == w_cand) ? (unsigned)k : 0xffffu);
    int w_bmax = NEG;
    if (XDROP) w_bmax = __reduce_max_sync(FULL, H_new);
    if (lane == 0) {
      redp[warp] = w_cand;
      redp[MAX_WARPS + warp] = (int)w_kbest;
      if (XDROP) redp[2 * MAX_WARPS + warp] = w_bmax;
    }
    __syncthreads();
    int cand = redp[0], k_best = redp[MAX_WARPS], band_max = NEG;
    if (XDROP) band_max = redp[2 * MAX_WARPS];
    for (int w = 1; w < nwarps; ++w) {
      const int c = redp[w];
      if (c > cand) { cand = c; k_best = redp[MAX_WARPS + w]; }
      if (XDROP) band_max = max(band_max, redp[2 * MAX_WARPS + w]);
    }

    // ---- xdrop retire rule: never on the final diagonal ----
    if (XDROP) {
      const int pb_new = max(pair_best, band_max);
      if (t != nm && band_max < pb_new - S.xdrop) {
        status = t;
        break;                      // carry, best cell and outputs freeze
      }
      pair_best = pb_new;
    }

    // ---- the step is live: apply it ----
    if (cand > best) {
      k_best = clampi(k_best, 0, B - 1);
      best = cand;
      best_i = lo_new + k_best;
      best_j = t - best_i;
    }
    if (TB) {
      // Even lane low nibble, odd lane high nibble. An even lane's odd
      // neighbour is in the same warp; lanes >= B carry code 0.
      const int hi = __shfl_down_sync(FULL, code, 1);
      if (in_band && !(k & 1))
        tb[(long long)(t - 1) * Bp + (k >> 1)] = (uint8_t)(code | (hi << 4));
      if (k == 0) los[t] = lo_new;
    }
    lo = lo_new;
    p ^= 1;
    t_live = t;
  }

  // ---- results ----
  __syncthreads();
  if (k == 0) {
    int score = NEG, final_lo = 0;
    if (status == 0 && t_live == nm && nm >= 1) {
      const int kc = clampi(n - lo, 0, B - 1);
      score = state[p * 5 * W + kc + 1];
      final_lo = lo;
    }
    int* st = R.stats;
    st[0] = score;
    st[R.stride] = final_lo;
    st[2 * R.stride] = best;
    st[3 * R.stride] = best_i;
    st[4 * R.stride] = best_j;
    st[5 * R.stride] = status;
  }
  if (TB) {
    // Non-live steps: zero flags, frozen offset.
    zero_bytes(tb, (long long)t_live * Bp, (long long)R.T * Bp, k,
               blockDim.x);
    for (int t = t_live + 1 + k; t <= R.T; t += blockDim.x) los[t] = lo;
  }
}

}  // namespace wavefront

// Expands to a switch over the 16 flag combinations of one launch:
// LAUNCH(SEMI, ADAPTIVE, TB, XDROP) must be an expression giving a
// cudaError_t. The switch returns from the enclosing function.
#define WAVEFRONT_DISPATCH(semiglobal, adaptive, collect_tb, xdrop_on, LAUNCH) \
  switch (((semiglobal) ? 8 : 0) | ((adaptive) ? 4 : 0) |                    \
          ((collect_tb) ? 2 : 0) | ((xdrop_on) ? 1 : 0)) {                    \
    case 0: return (int)LAUNCH(false, false, false, false);                   \
    case 1: return (int)LAUNCH(false, false, false, true);                    \
    case 2: return (int)LAUNCH(false, false, true, false);                    \
    case 3: return (int)LAUNCH(false, false, true, true);                     \
    case 4: return (int)LAUNCH(false, true, false, false);                    \
    case 5: return (int)LAUNCH(false, true, false, true);                     \
    case 6: return (int)LAUNCH(false, true, true, false);                     \
    case 7: return (int)LAUNCH(false, true, true, true);                      \
    case 8: return (int)LAUNCH(true, false, false, false);                    \
    case 9: return (int)LAUNCH(true, false, false, true);                     \
    case 10: return (int)LAUNCH(true, false, true, false);                    \
    case 11: return (int)LAUNCH(true, false, true, true);                     \
    case 12: return (int)LAUNCH(true, true, false, false);                    \
    case 13: return (int)LAUNCH(true, true, false, true);                     \
    case 14: return (int)LAUNCH(true, true, true, false);                     \
    default: return (int)LAUNCH(true, true, true, true);                      \
  }
