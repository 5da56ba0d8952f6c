// One pair's adaptive banded affine-gap wavefront (paper Eq. (4)), run by
// ONE WARP with the band state in registers: the per-pair body the
// per-group kernel (banded_dp.cu) and the persistent kernel (persistent.cu)
// launch for bands B <= 128. Wider bands keep the block body of
// wavefront.cuh; the two give the same results bit for bit (same
// arithmetic, same sentinels, same tie-breaks), which chip_smoke.py checks
// over bands across both bodies' edges, on persistent tables through both
// bodies and through the persistent == pipelined comparison.
//
// Layout: thread `lane` of the warp owns the C contiguous band lanes
// k = lane * C + c, C = 1, 2 or 4 for B <= 32, 64, 128. Lanes k >= B
// hold the block body's pad
// values (H = NEG, u = v = x = y = 0) at every step, so they are the pad
// column right of the band. The +/-1 lane shift of a step is uniform over
// the warp (the direction is), so it needs only the boundary cell of the
// neighbouring thread:
//
//   down  (up[k] = prev[k],   left[k] = prev[k+1]): __shfl_down of H, u, y
//         of the next thread's first cell (lane 31: the pad);
//   right (up[k] = prev[k-1], left[k] = prev[k]):   __shfl_up of H, v, x of
//         the previous thread's last cell (lane 0: the pad left of lane 0).
//
// A warp issues its instructions in order, so a step costs the sum of the
// latencies on its dependent chain. The design keeps that chain short:
//
//   * the six neighbour shuffles of both directions are issued together
//     with the two that read H at band lanes 0 and B-1 for the adaptive
//     test, before the direction is known; the direction then selects;
//   * q and r are read through L1 one step ahead: a cell's bytes at step
//     t + 1 are its bytes at step t or their successors (down: q[i],
//     right: r[j]), which are the next / previous cell's bytes of step t,
//     so each step loads only a thread's two end bytes for the next;
//   * the best cell (first maximum over steps, lowest lane within a step)
//     is kept per thread — the first step and lowest lane of the thread's
//     own maximum, strict > — and joined over the warp once, at the end;
//     only the xdrop rule needs a warp reduction (the band maximum) per
//     step;
//   * the cell update is straight-line (no branch per cell, so a thread's
//     C cells interleave), and a step whose band lies wholly inside the
//     grid's interior — all but about the first and last 2B steps of a
//     pair — takes a variant without the boundary and validity tests.
//
// There is no __syncthreads and no shared memory. What bounds it on an
// H100 is the latency of that chain, n + m steps per pair; one warp per
// block spreads 64 pairs over 64 SMs, and a launch of thousands of pairs
// fills every SM with warps whose chains interleave.

#pragma once

#include <type_traits>

#include "wavefront.cuh"

namespace wavefront {

// Widest band of this body: four band lanes per thread of one warp.
constexpr int WARP_MAX_BAND = 128;

// x[c] for a run-time c < C, without indexing registers dynamically.
template <int C>
__device__ __forceinline__ int pick(const int (&x)[C], int c) {
  int v = x[0];
#pragma unroll
  for (int i = 1; i < C; ++i) v = c == i ? x[i] : v;
  return v;
}

// Eq. (4) for one band cell (i, j) from its up and left neighbours, with
// the block body's boundary overrides; cells off the grid, and lanes past
// the band (`in_band` false), are dead (H = NEG). INTERIOR: the caller
// knows (i, j) is an interior grid cell if it is in the band.
template <bool INTERIOR, bool SEMI, bool TB>
__device__ __forceinline__ void cell_update(
    int upH, int upV, int upX, int leftH, int leftU, int leftY, int qb,
    int rb, int i, int j, bool in_band, int n, int m, const Scoring& S,
    int& H_out, int& u_out, int& v_out, int& x_out, int& y_out, int& code,
    int& H_masked) {
  const int o = S.o, e = S.e, oe = o + e, shift = 2 * (o + e);
  const bool up_valid = upH > DEAD, left_valid = leftH > DEAD;
  const bool valid = INTERIOR || (i >= 0 && i <= n && j >= 0 && j <= m);
  const bool interior = INTERIOR || (valid && i >= 1 && j >= 1);

  const bool is_match = qb == rb && qb < 4 && rb < 4;
  const int s_sub = is_match ? S.match : -S.mismatch;

  const int x_arm = up_valid ? upX : NEG;
  const int y_arm = left_valid ? leftY : NEG;
  const int v_up = up_valid ? upV : oe;
  const int u_left = left_valid ? leftU : oe;
  const int s_arm = (up_valid || left_valid) ? s_sub + shift : NEG;

  const int a_new = __vimax3_s32(s_arm, x_arm, y_arm);
  const int xo = x_arm + o, yo = y_arm + o;
  int u_new = a_new - v_up;
  int v_new = a_new - u_left;
  int x_new = max(a_new, xo) - u_left;
  int y_new = max(a_new, yo) - v_up;
  int H_new = up_valid ? upH + u_new - oe
                       : (left_valid ? leftH + v_new - oe : NEG);

  code = 0;
  if (TB) {
    const int dir = a_new == s_arm ? 0 : (a_new == x_arm ? 1 : 2);
    code = in_band && interior
               ? dir + (xo > a_new ? 4 : 0) + (yo > a_new ? 8 : 0)
               : 0;
  }

  if (!INTERIOR) {
    // ---- boundary overrides ----
    const bool brow = valid && i == 0 && j >= 1;
    const bool bcol = valid && j == 0 && i >= 1;
    const int b_row_vx = SEMI ? oe : (j == 1 ? 0 : o);
    const int b_row_h = SEMI ? 0 : -(o + j * e);
    const int b_col_uy = i == 1 ? 0 : o;
    u_new = brow ? o : (bcol ? b_col_uy : u_new);
    y_new = brow ? o : (bcol ? b_col_uy : y_new);
    v_new = brow ? b_row_vx : (bcol ? o : v_new);
    x_new = brow ? b_row_vx : (bcol ? o : x_new);
    H_new = brow ? b_row_h : (bcol ? -(o + i * e) : H_new);
  }
  // A dead cell is one whose H is dead: its neighbours read its u, v, x, y
  // only when its H is live, so only H takes the pad value here.
  H_out = in_band && valid ? H_new : NEG;
  u_out = u_new;
  v_out = v_new;
  x_out = x_new;
  y_out = y_new;
  const bool elig = in_band && interior && (!SEMI || i == n);
  H_masked = elig ? H_new : NEG;
}

template <int C, bool SEMI, bool ADAPTIVE, bool TB, bool XDROP>
__device__ __forceinline__ void align_row_warp(const Row& R,
                                               const Scoring& S) {
  static_assert(C == 1 || C == 2 || C == 4, "C is 1, 2 or 4");
  const int B = R.B;
  const int lane = threadIdx.x & 31;
  const int k0 = lane * C;
  const int n = R.n, m = R.m;
  const int nm = n + m;
  const int8_t* q = R.q;
  const int8_t* r = R.r;
  const int Bp = (B + 1) >> 1;
  uint8_t* tb = R.tb;
  int* los = R.los;

  // Diagonal 0: only cell (0, 0), band lane 0, is alive.
  int H[C], U[C], V[C], X[C], Y[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    H[c] = k0 + c == 0 ? 0 : NEG;
    U[c] = V[c] = X[c] = Y[c] = 0;
  }
  if (TB && lane == 0) los[0] = 0;

  // Sequence bytes of each cell at the previous step's (i, j), and their
  // successors q[i], r[j]: the next step's bytes whichever way it moves.
  int qc[C], rc[C], qn[C], rn[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = k0 + c, j = -(k0 + c);      // diagonal 0, lo = 0
    qc[c] = __ldg(q + clampi(i - 1, 0, R.Lq - 1));
    rc[c] = __ldg(r + clampi(j - 1, 0, R.Lr - 1));
    qn[c] = __ldg(q + clampi(i, 0, R.Lq - 1));
    rn[c] = __ldg(r + clampi(j, 0, R.Lr - 1));
  }

  // Owner of band lane B-1 (adaptive test) and its cell index.
  const int last_src = (B - 1) / C, last_c = (B - 1) % C;

  // This thread's best cell: its first maximum, strict >, from the
  // initial best; joined over the warp after the loop.
  const int best0 = SEMI ? NEG : 0;
  int my_best = best0, my_t = 0, my_k = 0xffff, my_i = 0, my_j = 0;

  int lo = 0;
  int pair_best = 0, status = 0;
  const int t_end = nm < R.T ? nm : R.T;
  int t_live = 0;

  for (int t = 1; t <= t_end; ++t) {
    // ---- every shuffle of the step at once ----
    int h_first = 0, h_last = 0;
    if (ADAPTIVE) {
      h_first = __shfl_sync(FULL, H[0], 0);
      h_last = __shfl_sync(FULL, pick<C>(H, last_c), last_src);
    }
    int nH = __shfl_down_sync(FULL, H[0], 1);
    int nU = __shfl_down_sync(FULL, U[0], 1);
    int nY = __shfl_down_sync(FULL, Y[0], 1);
    int pH = __shfl_up_sync(FULL, H[C - 1], 1);
    int pV = __shfl_up_sync(FULL, V[C - 1], 1);
    int pX = __shfl_up_sync(FULL, X[C - 1], 1);
    if (lane == 31) { nH = NEG; nU = 0; nY = 0; }
    if (lane == 0) { pH = NEG; pV = 0; pX = 0; }

    // ---- direction (paper §IV-B2 + feasibility clamps), uniform ----
    const bool must_down = (lo + (nm - t)) < (n - B + 1);
    const bool must_right = lo >= n;
    bool heur_right;
    if (ADAPTIVE) {
      heur_right = h_first > h_last;
    } else {
      // int32 arithmetic that wraps as two's complement does.
      const int lhs = (int)((unsigned)(2 * lo + B) * (unsigned)nm);
      const int rhs = (int)((unsigned)(2 * t) * (unsigned)n);
      heur_right = lhs >= rhs;
    }
    const bool go_down = must_down || (!must_right && !heur_right);
    const int lo_new = lo + (go_down ? 1 : 0);

    // ---- Eq. (4) on this thread's cells ----
    // The band [lo_new, lo_new + B) x (t - i) inside the interior?
    const bool inside = lo_new >= 1 && lo_new + B - 1 <= n
                        && t - (lo_new + B - 1) >= 1 && t - lo_new <= m;
    int Hn[C], Un[C], Vn[C], Xn[C], Yn[C], code[C], Hm[C];
    int band_max = NEG;
    // The C cells, with the interior variant chosen once for the step.
    auto cells = [&](auto interior) {
      constexpr bool INTERIOR = decltype(interior)::value;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = k0 + c;
        // down: up[k] = prev[k], left[k] = prev[k+1];
        // right: up[k] = prev[k-1], left[k] = prev[k].
        const int upH = go_down ? H[c] : (c > 0 ? H[c - 1] : pH);
        const int upV = go_down ? V[c] : (c > 0 ? V[c - 1] : pV);
        const int upX = go_down ? X[c] : (c > 0 ? X[c - 1] : pX);
        const int leftH = !go_down ? H[c] : (c + 1 < C ? H[c + 1] : nH);
        const int leftU = !go_down ? U[c] : (c + 1 < C ? U[c + 1] : nU);
        const int leftY = !go_down ? Y[c] : (c + 1 < C ? Y[c + 1] : nY);

        const int i = lo_new + k, j = t - i;
        // down: (i, j) = (i' + 1, j'), right: (i', j' + 1).
        const int qb = go_down ? qn[c] : qc[c];
        const int rb = go_down ? rc[c] : rn[c];
        qc[c] = qb;
        rc[c] = rb;
        // q[i] is the next cell's q byte, r[j] the previous cell's r byte:
        // a thread loads only its ends.
        if (c + 1 == C) qn[c] = __ldg(q + clampi(i, 0, R.Lq - 1));
        if (c == 0) rn[c] = __ldg(r + clampi(j, 0, R.Lr - 1));
        cell_update<INTERIOR, SEMI, TB>(upH, upV, upX, leftH, leftU, leftY,
                                        qb, rb, i, j, k < B, n, m, S, Hn[c],
                                        Un[c], Vn[c], Xn[c], Yn[c], code[c],
                                        Hm[c]);
        if (XDROP) band_max = max(band_max, Hn[c]);
      }
    };
    if (inside) cells(std::true_type{});
    else cells(std::false_type{});
#pragma unroll
    for (int c = 0; c + 1 < C; ++c) qn[c] = qc[c + 1];
#pragma unroll
    for (int c = C - 1; c > 0; --c) rn[c] = rc[c - 1];

    // ---- xdrop retire rule: never on the final diagonal ----
    if (XDROP) {
      const int w_band_max = __reduce_max_sync(FULL, band_max);
      const int pb_new = max(pair_best, w_band_max);
      if (t != nm && w_band_max < pb_new - S.xdrop) {
        status = t;
        break;                      // carry, best cell and outputs freeze
      }
      pair_best = pb_new;
    }

    // ---- the step is live: apply it ----
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (Hm[c] > my_best) {
        my_best = Hm[c];
        my_t = t;
        my_k = k0 + c;
        my_i = lo_new + k0 + c;
        my_j = t - my_i;
      }
    }
    if (TB) {
      // Even lane low nibble, odd lane high nibble; lanes >= B carry 0.
      // At C = 1 an even lane's odd neighbour is the next thread.
      uint8_t* row = tb + (long long)(t - 1) * Bp;
      if (C == 1) {
        const int hi = __shfl_down_sync(FULL, code[0], 1);
        if (k0 < B && !(lane & 1))
          row[k0 >> 1] = (uint8_t)(code[0] | (hi << 4));
      } else {
#pragma unroll
        for (int c = 0; c + 1 < C; c += 2)
          if (k0 + c < B)
            row[(k0 + c) >> 1] = (uint8_t)(code[c] | (code[c + 1] << 4));
      }
      if (lane == 0) los[t] = lo_new;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      H[c] = Hn[c]; U[c] = Un[c]; V[c] = Vn[c]; X[c] = Xn[c]; Y[c] = Yn[c];
    }
    lo = lo_new;
    t_live = t;
  }

  // ---- results ----
  // The best cell: the largest value, then its first step, then its
  // lowest lane; the initial best (score 0 / NEG at (0, 0)) unless beaten.
  const int w_best = __reduce_max_sync(FULL, my_best);
  const unsigned w_t = __reduce_min_sync(
      FULL, my_best == w_best ? (unsigned)my_t : 0xffffffffu);
  const unsigned w_k = __reduce_min_sync(
      FULL, my_best == w_best && (unsigned)my_t == w_t ? (unsigned)my_k
                                                       : 0xffffu);
  const int src = (int)(w_k < 0xffffu ? w_k : 0) / C;
  const int b_i = __shfl_sync(FULL, my_i, src);
  const int b_j = __shfl_sync(FULL, my_j, src);
  const bool beaten = w_best > best0;

  int score = NEG, final_lo = 0;
  const int kc = clampi(n - lo, 0, B - 1);
  const int h_end = __shfl_sync(FULL, pick<C>(H, kc % C), kc / C);
  if (status == 0 && t_live == nm && nm >= 1) {
    score = h_end;
    final_lo = lo;
  }
  if (lane == 0) {
    int* st = R.stats;
    st[0] = score;
    st[R.stride] = final_lo;
    st[2 * R.stride] = beaten ? w_best : best0;
    st[3 * R.stride] = beaten ? b_i : 0;
    st[4 * R.stride] = beaten ? b_j : 0;
    st[5 * R.stride] = status;
  }
  if (TB) {
    // Non-live steps: zero flags, frozen offset.
    zero_bytes(tb, (long long)t_live * Bp, (long long)R.T * Bp, lane, 32);
    for (int t = t_live + 1 + lane; t <= R.T; t += 32) los[t] = lo;
  }
}

}  // namespace wavefront
