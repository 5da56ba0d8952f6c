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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int DEAD = -(1 << 27);
constexpr int MAX_WARPS = 32;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const int8_t* q;      // (N, Lq)
  const int8_t* r;      // (N, Lr)
  const int* n;         // (N,)
  const int* m;         // (N,)
  int* stats;           // (6, N): score, final_lo, best, best_i, best_j, status
  uint8_t* tb;          // (N, T, Bp) or null
  int* los;             // (N, T + 1) or null
  int N, Lq, Lr, T, B;
  int match, mismatch, o, e, xdrop;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Zero bytes [from, to) of `p` with the whole block, 16 bytes a thread
// where the address allows it.
__device__ void zero_bytes(uint8_t* p, long long from, long long to) {
  const int tid = threadIdx.x, nt = blockDim.x;
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
__global__ void wavefront_kernel(Params P) {
  extern __shared__ int smem[];
  const int B = P.B;
  const int W = B + 2;              // padded lane count
  // state[buf][plane][W]; planes: 0 H, 1 u, 2 v, 3 x, 4 y
  int* state = smem;
  int* red = smem + 2 * 5 * W;      // [2 parities][3 values][MAX_WARPS]

  const int pair = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool in_band = k < B;

  const int n = P.n[pair], m = P.m[pair];
  const int nm = n + m;
  const int8_t* q = P.q + (long long)pair * P.Lq;
  const int8_t* r = P.r + (long long)pair * P.Lr;
  const int o = P.o, e = P.e, oe = o + e, shift = 2 * (o + e);
  const int Bp = (B + 1) >> 1;
  uint8_t* tb = TB ? P.tb + (long long)pair * P.T * Bp : nullptr;
  int* los = TB ? P.los + (long long)pair * (P.T + 1) : nullptr;

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
  const int t_end = nm < P.T ? nm : P.T;
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

      const int qb = q[clampi(i - 1, 0, P.Lq - 1)];
      const int rb = r[clampi(j - 1, 0, P.Lr - 1)];
      const bool is_match = qb == rb && qb < 4 && rb < 4;
      const int s_sub = is_match ? P.match : -P.mismatch;

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
      if (t != nm && band_max < pb_new - P.xdrop) {
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
    int* st = P.stats + pair;
    st[0] = score;
    st[P.N] = final_lo;
    st[2 * P.N] = best;
    st[3 * P.N] = best_i;
    st[4 * P.N] = best_j;
    st[5 * P.N] = status;
  }
  if (TB) {
    // Non-live steps: zero flags, frozen offset.
    zero_bytes(tb, (long long)t_live * Bp, (long long)P.T * Bp);
    for (int t = t_live + 1 + k; t <= P.T; t += blockDim.x) los[t] = lo;
  }
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
  P.match = match; P.mismatch = mismatch; P.o = gap_open; P.e = gap_extend;
  P.xdrop = xdrop;
  const int threads = ((B + 31) / 32) * 32;
  const size_t smem = (size_t)(2 * 5 * (B + 2) + 2 * 3 * MAX_WARPS) * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  const int key = (semiglobal ? 8 : 0) | (adaptive ? 4 : 0)
                | (collect_tb ? 2 : 0) | (xdrop >= 0 ? 1 : 0);
  switch (key) {
#define CASE(K, A, B_, C, D) case K: return (int)launch<A, B_, C, D>(P, threads, smem, s);
    CASE(0, false, false, false, false) CASE(1, false, false, false, true)
    CASE(2, false, false, true, false)  CASE(3, false, false, true, true)
    CASE(4, false, true, false, false)  CASE(5, false, true, false, true)
    CASE(6, false, true, true, false)   CASE(7, false, true, true, true)
    CASE(8, true, false, false, false)  CASE(9, true, false, false, true)
    CASE(10, true, false, true, false)  CASE(11, true, false, true, true)
    CASE(12, true, true, false, false)  CASE(13, true, true, false, true)
    CASE(14, true, true, true, false)   CASE(15, true, true, true, true)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}
