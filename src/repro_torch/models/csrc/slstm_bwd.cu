// Backward of the sLSTM recurrence (B8-bwd), for sm_90a.
//
// Replaces no kernel of the JAX package: the reference differentiates the
// `lax.scan` of `slstm_step` (src/repro/models/xlstm.py:198, scan at :233)
// with `jax.grad`. It is the backward of B8 (slstm.cu), behind
// `SLSTMScan` in xlstm.py. Per (b, head), backwards in time, from the
// record B8's forward writes when asked (per step the pre-activations
// pz, pi, pf, po and the new c, n, m) and the output's gradient dh:
//
//   f~ = pf + 1, m' = max(log_sigmoid(f~) + m, pi)   (m: the step's input)
//   i' = exp(pi - m'), f' = exp(log_sigmoid(f~) + m - m')
//   z = tanh(pz), o = sigmoid(po), c' = f' c + i' z, n' = f' n + i'
//   dh_t = dh[t] + dh_rec;  do = dh_t c' / n';  dc' = dc + dh_t o / n'
//   dn' = dn - dh_t o c' / n'^2;  dz = dc' i';  di' = dc' z + dn'
//   dlsf = (dc' c + dn' n) f';  dpi = di' i';  dc = dc' f', dn = dn' f'
//   delta = (dz (1 - z^2), dpi, dlsf sigmoid(-f~), do o (1 - o))
//   dh_rec[d] (for step t - 1) = sum_g sum_e R_g[d, e] delta_g[e]
//
// with m' held constant: the output does not depend on the stabiliser's
// value (xlstm.py's note on B8-bwd), and the gauge part of a final-state
// gradient, g = dm1 - dc1 c1 - dn1 n1, flows back through the maxes:
// where log_sigmoid(f~) + m wins, dlsf += g and g carries on to the step
// before; where pi wins, dpi += g and g stops. delta is written per step
// (f32, B x T x 4 x H Dh); dR_g = sum_t h_{t-1} delta_g^T is one batched
// product after the kernel (xlstm.py, `slstm_bwd_dr`).
//
// What bounds it on an H100: the chain of steps, as the forward. Per (b,
// head, step) 8 Dh^2 FLOP of the recurrent product and 52 Dh of the
// cell's backward (chip_smoke.py's SLSTM_BWD_CELL_OPS, term by term);
// the bytes (the 7-row record, dh and delta, 12 floats per unit and
// step) are read and written once. A step's latency is the exchange of
// dh_rec plus whatever else the chain holds, so the design keeps only the
// exchange, the linear part of the cell and the partial sums on it.
//
// The linear part. Everything above but dh_rec, and the dc, dn, g a unit
// carries, depends on the step's record alone, and dh_rec enters
// linearly. So per step and unit 13 coefficients (struct Coef: dh; o /
// n'; o c' / n'^2, 0 where the clamp binds; c' o (1 - o) / n'; i' (1 -
// z^2); z i'; i'; c f'; n f'; sigmoid(-f~); f'; the gauge term on the
// branch that wins, gi or gf: g depends only on which branch won each
// later step) are formed off the chain, in precise expf / log1pf / tanhf
// and divisions, and after the exchange only
//
//   dht = dh + dh_rec;  dc' = dc + dht kdc;  dn' = dn - dht kdn
//   delta = (dc' kz, dc' kzi + dn' ip + gi, dm kf, dht kdo)
//   dm = dc' kc + dn' kn + gf;  dc = dc' fp;  dn = dn' fp
//
// is left: five dependent operations from dh_rec to delta.
//
// Design. The forward's cluster: CL = ceil(Dh / 32) blocks per (b, head)
// (`slstm_cluster` in xlstm.py passes it), block r owns units [r U, (r+1)
// U), U = ceil(Dh / CL), one unit per lane of warp 0. Where the forward
// all-gathers h, the backward reduce-scatters dh_rec: each block forms,
// for every row d, the partial sum of dh_rec[d] over its own units and
// stores it into the block that owns unit d, one slot per sender:
// slot[buffer][sender][d - owner U], with `st.async`, which completes 4
// bytes on that block's mbarrier. `red.async` into distributed shared
// memory adds integers only, so no float add is in flight; the owner's
// warp 0 sums its CL slots. The block's R columns sit in registers, in
// quads of threads: quad p holds rows p + r P (r < 4, P = ceil(Dh / 4)),
// lane q of the quad units [8 q, 8 q + 8), so every float4 of delta a
// thread reads serves four rows (8 reads a thread a step, against 32 when
// a thread held one row), and three shuffles leave lane q with row p + q
// P's sum. Each step, on the chain:
//
//   1. warp 0 waits for the CL partials of each of its units (the step's
//      buffer, one mbarrier per buffer, re-armed as soon as the wait
//      returns), takes the step's coefficients from the ring, sums the
//      slots as a tree over 8 (depth 3), runs the linear update, lane =
//      unit, and puts delta in shared memory (two buffers, unit j at j +
//      j / 8 so that a quad's four lanes read four banks);
//   2. one barrier of the dot's warps (`bar.sync 1`);
//   3. each quad forms its four rows' partial sums from the four delta of
//      its units and its registers (16 chains 8 deep), reduce-scatters
//      them by shuffles, and each lane stores its row's into the owner's
//      buffer of the next step.
//
// Off the chain: warp 7, which the dot leaves free up to Dh 224 (4 P <=
// 224), forms every step's coefficients, from T - 1 down, into a ring of
// RING steps in shared memory, with full / empty mbarriers (32 arrivals
// each: the lanes), at most RING steps ahead of the chain; its inputs
// (the record of the step, the state before it, dh) arrive by cp.async
// AHEAD steps ahead into a stage in shared memory. Warp 0 writes delta to
// global memory after its send. At Dh 225-256 the dot needs all eight
// warps, and warp 0 forms the coefficients itself after its send, on the
// chain (`HELPER` false).
//
// The one-way argument carries over from the first design: a store into
// a block's buffer (t - 1) % 2 is sent from delta(t), which needs that
// block's own partial from delta(t + 1), which the block formed only
// after its warp 0 had summed buffer (t + 1) % 2 and re-armed its
// barrier; so no store lands in a buffer still being read, and no byte of
// a barrier's next phase arrives before the phase it follows has
// completed. After step 0 every block waits for the partials of step -1
// (its dh0), so every store into a block lands before it exits. The delta
// buffer in shared memory is double-buffered for the same reason: warp 0
// writes delta(t - 1) only after the partials of delta(t) from every
// block, its own threads' included, have arrived, and the dot's barrier
// of step t - 1 holds the other warps until they are done reading
// delta(t). The ring is the usual pair of barriers: warp 7 writes a slot
// only after warp 0's 32 lanes have arrived on its empty barrier (read
// it), warp 0 reads it only after warp 7's 32 lanes have arrived on its
// full barrier; the stage is each lane's own cp.async groups, waited for
// by that lane (`cp.async.wait_group`) before it reads them, and a slot
// is copied into again only after its reads.
//
// Shared memory: 80 B of mbarriers, the slots (2 x 8 x 32 floats, 2 KB),
// delta (2 x 36 float4), the stage (8 steps x 8 inputs x 32 units) and the
// ring (4 steps x 13 x 32): 18,128 B. Registers: R's 128 floats a
// thread, 16 accumulators, a cell lane's 13 coefficients (chip_smoke.py
// records the count and the spills).
//
// Tried and not adopted (chip_smoke.py's `slstm_exchange` line times the
// probe slstm_probe.cu's versions of the first design's step and of this
// one's): the first design's dot in eight chains 16 deep instead of four
// 32 deep (no faster: the dot was bound by its 32 broadcast reads a
// thread, not by its chains, hence the quads); the
// coefficients formed by warp 0 after its send (the window before the
// partials arrive is shorter than the precise math, and than the loads of
// the record); the same with fast intrinsics, or with the record staged
// by cp.async (both still on the chain); a ninth warp for the
// coefficients (three warps on one SM sub-partition cap the registers at
// 168, and R spilled); warp 0 taking the coefficients from the ring
// before its wait rather than after it (slower). The split behind the
// choices is in PERF.md §7.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_exchange.cuh"

namespace {

constexpr int THREADS = 256;    // one thread per row d: Dh <= 256
constexpr int MAX_UNITS = 32;   // units per block: one per lane of warp 0
constexpr int ROWS = 4;         // rows of R a thread holds
constexpr int GROUP = MAX_UNITS / ROWS;  // units of a thread: 8
// delta in shared memory: unit j at j + j / GROUP, so that the four
// groups of a quad read four different banks.
constexpr int DL = MAX_UNITS + MAX_UNITS / GROUP;
constexpr int MAX_CL = 8;       // blocks per cluster: Dh <= 256
constexpr int SAVED = 7;        // rows of the forward's record per step
constexpr int AHEAD = 8;        // steps of inputs in flight (cp.async)
constexpr int NIN = 8;          // inputs a unit and step (StepIn)
constexpr int NCOEF = 13;       // coefficients a unit and step (Coef)
constexpr int RING = 4;         // steps of coefficients in flight
// The coefficient warp (warp 7) where the dot needs at most 7 warps.
constexpr int HELPER_WARP = 7;
// Shared memory: the exchange's 2 mbarriers, the ring's RING full and
// RING empty ones, the slots [2][MAX_CL][32] f32, delta [2][DL] float4,
// the input stage [AHEAD][NIN][32] f32, the ring [RING][NCOEF][32] f32.
constexpr int OFF_FULL = 16;
constexpr int OFF_EMPTY = OFF_FULL + 8 * RING;
constexpr int OFF_SLOT = OFF_EMPTY + 8 * RING;
constexpr int OFF_DL = OFF_SLOT + 2 * MAX_CL * MAX_UNITS * 4;
constexpr int OFF_STAGE = OFF_DL + 2 * DL * 16;
constexpr int OFF_RING = OFF_STAGE + AHEAD * NIN * MAX_UNITS * 4;
constexpr int SMEM = OFF_RING + RING * NCOEF * MAX_UNITS * 4;
static_assert(OFF_SLOT % 16 == 0 && OFF_DL % 16 == 0 &&
              OFF_STAGE % 16 == 0 && OFF_RING % 16 == 0,
              "16-byte aligned sections");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A unit's inputs of one step: its record, the state before it, dh.
struct StepIn {
  float pz, pi, pf, po, c, n, m, dh;
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(dst), "l"(src) : "memory");
}

// Copies step t's inputs of this lane's unit into stage slot t % AHEAD
// ([AHEAD][NIN][32] f32 in shared memory) with cp.async, and commits
// them as one group (an empty one where t < 0 or the lane has no unit),
// so that every step adds one group.
__device__ __forceinline__ void stage_step(
    uint32_t stage0, const float* __restrict__ saved,
    const float* __restrict__ dh, const float* __restrict__ c0,
    const float* __restrict__ n0, const float* __restrict__ m0, int64_t bT,
    int64_t D, int64_t col, int64_t sb, int lane, int t, bool live) {
  if (live && t >= 0) {
    const uint32_t dst = stage0 + 4 * ((t % AHEAD) * NIN * MAX_UNITS + lane);
    const float* rec = saved + (bT + t) * SAVED * D + col;
#pragma unroll
    for (int f = 0; f < 4; ++f)
      cp_async4(dst + 4 * f * MAX_UNITS, rec + f * D);
    const float* prev[3] = {c0 + sb, n0 + sb, m0 + sb};
    if (t > 0)
#pragma unroll
      for (int f = 0; f < 3; ++f) prev[f] = rec - SAVED * D + (4 + f) * D;
#pragma unroll
    for (int f = 0; f < 3; ++f)
      cp_async4(dst + 4 * (4 + f) * MAX_UNITS, prev[f]);
    cp_async4(dst + 4 * 7 * MAX_UNITS, dh + (bT + t) * D + col);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Step t's inputs from its stage slot, once its group has landed.
__device__ __forceinline__ StepIn staged(const float* stage, int t,
                                         int lane) {
  const float* x = stage + (t % AHEAD) * NIN * MAX_UNITS + lane;
  return StepIn{x[0], x[MAX_UNITS], x[2 * MAX_UNITS], x[3 * MAX_UNITS],
                x[4 * MAX_UNITS], x[5 * MAX_UNITS], x[6 * MAX_UNITS],
                x[7 * MAX_UNITS]};
}

// One arrival on a barrier of this block (release at CTA scope).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar)
               : "memory");
}

// The block barrier of the warps on the chain (`threads` of them).
__device__ __forceinline__ void chain_sync(int threads) {
  asm volatile("bar.sync 1, %0;" :: "r"(threads) : "memory");
}

// Waits for all but the latest AHEAD - 1 groups of this thread's copies.
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(AHEAD - 1) : "memory");
}

// What a step's linear update needs of the record, formed off the chain:
// with dht = dh + dh_rec and the carried dc, dn,
//   dc' = dc + dht kdc,  dn' = dn - dht kdn,
//   delta = (dc' kz, dc' kzi + dn' ip + gi, dm kf, dht kdo),
//   dm = dc' kc + dn' kn + gf,  dc = dc' fp,  dn = dn' fp,
// where gi / gf is the gauge term g on the branch that wins the max.
struct Coef {
  float dh, kdc, kdn, kdo, kz, kzi, ip, kc, kn, kf, fp, gi, gf;
};

// The coefficients of one step from its record; g (the gauge term still
// flowing back) goes on or stops at this step's max.
__device__ __forceinline__ Coef coefficients(const StepIn& in, float& g) {
  const float ft = in.pf + 1.0f;
  const float sgf = 1.0f / (1.0f + expf(-ft));
  const float lsf = fminf(ft, 0.0f) - log1pf(expf(-fabsf(ft)));
  const float mn = fmaxf(lsf + in.m, in.pi);
  const float ip = expf(in.pi - mn), fp = expf(lsf + in.m - mn);
  const float z = tanhf(in.pz);
  const float o = 1.0f / (1.0f + expf(-in.po));
  const float cn = fp * in.c + ip * z, nn = fp * in.n + ip;
  const float rd = 1.0f / fmaxf(nn, 1e-6f);
  Coef k;
  k.dh = in.dh;
  k.kdc = o * rd;
  k.kdn = nn >= 1e-6f ? o * cn * rd * rd : 0.0f;
  k.kdo = cn * rd * o * (1.0f - o);
  k.kz = ip * (1.0f - z * z);
  k.kzi = z * ip;
  k.ip = ip;
  k.kc = in.c * fp;
  k.kn = in.n * fp;
  k.kf = 1.0f - sgf;
  k.fp = fp;
  const bool lsf_wins = lsf + in.m >= in.pi;
  k.gf = lsf_wins ? g : 0.0f;
  k.gi = lsf_wins ? 0.0f : g;
  g = k.gf;
  return k;
}

// HELPER: warp 7 forms the coefficients into a ring in shared memory and
// the dot's warps (at most 0-6) run the chain (Dh <= 224); else warp 0
// forms them itself after its send, on the chain (Dh 225-256, where the
// dot needs all eight warps).
template <typename TR, bool HELPER>
__global__ void __launch_bounds__(THREADS, 1)
slstm_bwd_kernel(const TR* __restrict__ rz, const TR* __restrict__ ri,
                 const TR* __restrict__ rf, const TR* __restrict__ ro,
                 const float* __restrict__ c0, const float* __restrict__ n0,
                 const float* __restrict__ m0,
                 const float* __restrict__ saved,
                 const float* __restrict__ dh, const float* __restrict__ dh1,
                 const float* __restrict__ dc1,
                 const float* __restrict__ dn1,
                 const float* __restrict__ dm1, float* __restrict__ delta,
                 float* __restrict__ dh0, float* __restrict__ dc0,
                 float* __restrict__ dn0, float* __restrict__ dm0, int T,
                 int H, int Dh, int U) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* slot = reinterpret_cast<float*>(smem + OFF_SLOT);
  float4* dl = reinterpret_cast<float4*>(smem + OFF_DL);
  float* stage = reinterpret_cast<float*>(smem + OFF_STAGE);
  float* ring = reinterpret_cast<float*>(smem + OFF_RING);
  const uint32_t bar0 = cx::smem_addr(smem);           // the exchange's
  const uint32_t full0 = bar0 + OFF_FULL, empty0 = bar0 + OFF_EMPTY;
  const uint32_t slot0 = cx::smem_addr(slot);
  const uint32_t stage0 = cx::smem_addr(stage);
  const uint32_t rank = cx::cluster_rank(), CL = cx::cluster_size();
  const int nlive = min(U, Dh - (int)rank * U);        // this block's units
  const uint32_t bytes = CL * (uint32_t)nlive * 4;

  const int bh = blockIdx.y;
  const int head = bh % H, b = bh / H;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int64_t D = (int64_t)H * Dh;
  const bool live = lane < nlive;                      // lane = unit
  const int e = (int)rank * U + lane;
  const int64_t col = (int64_t)head * Dh + e;
  const int64_t sb = (int64_t)bh * Dh + e;
  const int64_t bT = (int64_t)b * T;

  // Quads of chain threads: quad p holds rows p + r P (r < ROWS, P =
  // ceil(Dh / 4)), lane q of the quad the units [q GROUP, (q+1) GROUP) of
  // this block, four R columns each, zero past them. After the dot, lane
  // q of the quad holds row p + q P's sum over the block's units.
  const int P = (Dh + ROWS - 1) / ROWS;
  const int quad = tid >> 2, q4 = tid & 3;
  const bool dot_warp = w * 32 < ROWS * P;
  const int chain_threads = (ROWS * P + 31) / 32 * 32;  // the dot's warps
  float R[ROWS][GROUP][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
#pragma unroll
      for (int g = 0; g < 4; ++g) R[r][j][g] = 0.0f;
  if (dot_warp) {
    const TR* Rg[4] = {rz, ri, rf, ro};
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = quad + r * P;
      const int64_t base = ((int64_t)head * Dh + row) * Dh +
                           (int64_t)rank * U + q4 * GROUP;
#pragma unroll
      for (int j = 0; j < GROUP; ++j)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if (quad < P && row < Dh && q4 * GROUP + j < nlive)
            R[r][j][g] = to_f32(Rg[g][base + j]);
    }
  }
  const int my_row = quad + q4 * P;
  const bool sends = dot_warp && quad < P && my_row < Dh;
  const int dst_rank = sends ? my_row / U : 0;
  const int dst_idx = my_row - dst_rank * U;
  for (int i = tid; i < 2 * DL; i += THREADS)
    dl[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tid == 0) {
    cx::mbar_init(bar0, 1);
    cx::mbar_init(bar0 + 8, 1);
    for (int s = 0; s < RING; ++s) {
      cx::mbar_init(full0 + 8 * s, 32);
      cx::mbar_init(empty0 + 8 * s, 32);
    }
    cx::fence_mbar_init();
    cx::mbar_expect_tx(bar0, bytes);
    cx::mbar_expect_tx(bar0 + 8, bytes);
  }

  // The warp that forms the coefficients (warp 7 with a helper, else
  // warp 0): the inputs of steps T - 1 .. T - AHEAD in flight, and the
  // gauge term g of the final state.
  const bool former = w == (HELPER ? HELPER_WARP : 0);
  float g = 0.0f;
  if (former) {
    for (int s = 0; s < AHEAD; ++s)
      stage_step(stage0, saved, dh, c0, n0, m0, bT, D, col, sb, lane,
                 T - 1 - s, live);
    if (live) {
      const float* last = saved + (bT + T - 1) * SAVED * D + col;
      g = (dm1 ? dm1[sb] : 0.0f) - (dc1 ? dc1[sb] : 0.0f) * last[4 * D] -
          (dn1 ? dn1[sb] : 0.0f) * last[5 * D];
    }
  }
  // Step t's coefficients, once its inputs have landed; then the copies
  // of step t - AHEAD's inputs into the slot they leave.
  auto form = [&](int t) {
    stage_wait();
    Coef k{};
    if (live) k = coefficients(staged(stage, t, lane), g);
    stage_step(stage0, saved, dh, c0, n0, m0, bT, D, col, sb, lane,
               t - AHEAD, live);
    return k;
  };
  cx::cluster_sync();   // every block running, every barrier armed

  if (HELPER && w == HELPER_WARP) {
    // Every step's coefficients, from T - 1 down, into the ring, at most
    // RING steps ahead of the chain.
    for (int i = 0; i < T; ++i) {
      const int s = i % RING;
      const Coef k = form(T - 1 - i);
      if (i >= RING) cx::mbar_wait(empty0 + 8 * s, ((i / RING) - 1) & 1);
      const float kv[NCOEF] = {k.dh, k.kdc, k.kdn, k.kdo, k.kz, k.kzi, k.ip,
                               k.kc, k.kn, k.kf, k.fp, k.gi, k.gf};
      float* out = ring + s * NCOEF * MAX_UNITS + lane;
#pragma unroll
      for (int f = 0; f < NCOEF; ++f) out[f * MAX_UNITS] = kv[f];
      mbar_arrive(full0 + 8 * s);
    }
    return;
  }
  if (!dot_warp) return;   // past the dot's rows: nothing to do

  // Warp 0 (lane = unit): step T - 1 - i's coefficients, from the ring
  // (its slot then freed) or formed here.
  const bool cell_lane = w == 0 && live;
  Coef k{};
  auto fetch = [&](int i) {
    if (!HELPER) {
      k = form(T - 1 - i);
      return;
    }
    const int s = i % RING;
    cx::mbar_wait(full0 + 8 * s, (i / RING) & 1);
    const float* in = ring + s * NCOEF * MAX_UNITS + lane;
    float kv[NCOEF];
#pragma unroll
    for (int f = 0; f < NCOEF; ++f) kv[f] = in[f * MAX_UNITS];
    k = Coef{kv[0], kv[1], kv[2], kv[3], kv[4], kv[5], kv[6],
             kv[7], kv[8], kv[9], kv[10], kv[11], kv[12]};
    mbar_arrive(empty0 + 8 * s);
  };
  float dc = 0.0f, dn = 0.0f, dm = 0.0f, dhr = 0.0f;
  if (w == 0) {
    if (live) {
      dc = dc1 ? dc1[sb] : 0.0f;
      dn = dn1 ? dn1[sb] : 0.0f;
      dhr = dh1 ? dh1[sb] : 0.0f;
    }
    fetch(0);
  }

  uint32_t parity = 0;  // bit j: the phase parity to wait for on barrier j
  float4 dv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);   // the step's delta
  for (int t = T - 1; t >= 0; --t) {
    const int cur = t & 1, nxt = cur ^ 1;
    // The chain: the partials of dh_rec, their slot sum, the linear update.
    if (w == 0) {
      if (t < T - 1) {
        cx::mbar_wait(bar0 + 8 * cur, (parity >> cur) & 1);
        parity ^= 1u << cur;
        if (lane == 0) cx::mbar_expect_tx(bar0 + 8 * cur, bytes);
        // The helper's coefficients of this step: in the ring long since.
        if (HELPER) fetch(T - 1 - t);
        if (cell_lane) {
          float v[MAX_CL];
#pragma unroll
          for (int q = 0; q < MAX_CL; ++q)
            v[q] = q < (int)CL ? slot[(cur * MAX_CL + q) * MAX_UNITS + lane]
                               : 0.0f;
          dhr = ((v[0] + v[1]) + (v[2] + v[3])) +
                ((v[4] + v[5]) + (v[6] + v[7]));
        }
      }
      if (cell_lane) {
        const float dht = k.dh + dhr;
        const float dcn = fmaf(dht, k.kdc, dc);
        const float dnn = fmaf(-dht, k.kdn, dn);
        dm = fmaf(dcn, k.kc, fmaf(dnn, k.kn, k.gf));
        dv = make_float4(dcn * k.kz, fmaf(dcn, k.kzi, fmaf(dnn, k.ip, k.gi)),
                         dm * k.kf, dht * k.kdo);
        dl[cur * DL + lane + lane / GROUP] = dv;
        dc = dcn * k.fp;
        dn = dnn * k.fp;
      }
    }
    chain_sync(chain_threads);
    {
      // Each delta read serves four rows: 8 float4 reads a thread, 16
      // chains 8 deep (a row and a gate each).
      float a[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) a[r][g] = 0.0f;
      const float4* dc4 = dl + cur * DL + q4 * (GROUP + 1);
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        const float4 x = dc4[j];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          a[r][0] = fmaf(R[r][j][0], x.x, a[r][0]);
          a[r][1] = fmaf(R[r][j][1], x.y, a[r][1]);
          a[r][2] = fmaf(R[r][j][2], x.z, a[r][2]);
          a[r][3] = fmaf(R[r][j][3], x.w, a[r][3]);
        }
      }
      float s[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        s[r] = (a[r][0] + a[r][1]) + (a[r][2] + a[r][3]);
      // Reduce-scatter within the quad: lane q ends with row q's sum.
      const bool b0 = q4 & 1, b1 = q4 & 2;
      float k0 = b0 ? s[1] : s[0], k1 = b0 ? s[3] : s[2];
      k0 += __shfl_xor_sync(0xffffffffu, b0 ? s[0] : s[1], 1);
      k1 += __shfl_xor_sync(0xffffffffu, b0 ? s[2] : s[3], 1);
      const float part =
          (b1 ? k1 : k0) + __shfl_xor_sync(0xffffffffu, b1 ? k0 : k1, 2);
      if (sends) {
        const uint32_t dst =
            slot0 + 4 * ((nxt * MAX_CL + rank) * MAX_UNITS + dst_idx);
        cx::st_async(cx::map_rank(dst, dst_rank), part,
                     cx::map_rank(bar0 + 8 * nxt, dst_rank));
      }
    }
    // While the partials are in flight: delta out and, without a helper,
    // step t - 1's coefficients.
    if (w == 0) {
      if (cell_lane) {
        float* out = delta + (bT + t) * 4 * D + col;
        out[0] = dv.x;
        out[D] = dv.y;
        out[2 * D] = dv.z;
        out[3 * D] = dv.w;
      }
      if (!HELPER && t > 0) fetch(T - t);
    }
  }
  // Step -1: the partials of delta(0) are dh0.
  if (w == 0) {
    cx::mbar_wait(bar0 + 8, (parity >> 1) & 1);
    if (cell_lane) {
      float v[MAX_CL];
#pragma unroll
      for (int q = 0; q < MAX_CL; ++q)
        v[q] = q < (int)CL ? slot[(MAX_CL + q) * MAX_UNITS + lane] : 0.0f;
      dh0[sb] = ((v[0] + v[1]) + (v[2] + v[3])) +
                ((v[4] + v[5]) + (v[6] + v[7]));
      dc0[sb] = dc;
      dn0[sb] = dn;
      dm0[sb] = dm;
    }
  }
}

size_t smem_bytes() { return SMEM; }

// Whether the dot leaves warp 7 free for the coefficients.
bool helper(int Dh) {
  return (Dh + ROWS - 1) / ROWS * ROWS <= 32 * HELPER_WARP;
}

bool shape_ok(int B, int H, int Dh, int cluster) {
  return B > 0 && H > 0 && Dh > 0 && Dh <= THREADS &&
         (int64_t)B * H <= 65535 &&
         cluster == (Dh + MAX_UNITS - 1) / MAX_UNITS;
}

}  // namespace

// rz, ri, rf, ro: (H, Dh, Dh) in the R type (rdtype 0 f32, 1 bf16); c0,
// n0, m0 (B, H, Dh) f32, the initial state; saved (B, T, 7, H*Dh) f32, the
// forward's record; dh (B, T, H*Dh) f32; dh1, dc1, dn1, dm1 (B, H, Dh)
// f32, the final state's gradients, each may be null (zero). delta (B, T,
// 4, H*Dh) f32 and dh0, dc0, dn0, dm0 (B, H, Dh) f32 out. cluster: blocks
// per (b, head), ceil(Dh / 32), as the forward.
extern "C" int slstm_bwd_launch(
    const void* rz, const void* ri, const void* rf, const void* ro,
    const void* c0, const void* n0, const void* m0, const void* saved,
    const void* dh, const void* dh1, const void* dc1, const void* dn1,
    const void* dm1, void* delta, void* dh0, void* dc0, void* dn0, void* dm0,
    int B, int T, int H, int Dh, int rdtype, int cluster, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (!shape_ok(B, H, Dh, cluster)) return (int)cudaErrorInvalidValue;
  const int U = (Dh + cluster - 1) / cluster;
  cudaStream_t s = (cudaStream_t)stream;
  const bool help = helper(Dh);
  auto run = [&](auto kernel, auto r) {
    using TRp = decltype(r);
    return cx::launch_clustered(
        kernel, cluster, B * H, THREADS, smem_bytes(), s, (TRp)rz, (TRp)ri,
        (TRp)rf, (TRp)ro, (const float*)c0, (const float*)n0,
        (const float*)m0, (const float*)saved, (const float*)dh,
        (const float*)dh1, (const float*)dc1, (const float*)dn1,
        (const float*)dm1, (float*)delta, (float*)dh0, (float*)dc0,
        (float*)dn0, (float*)dm0, T, H, Dh, U);
  };
  switch (rdtype) {
    case 0:
      return help ? (int)run(slstm_bwd_kernel<float, true>,
                             (const float*)nullptr)
                  : (int)run(slstm_bwd_kernel<float, false>,
                             (const float*)nullptr);
    case 1:
      return help ? (int)run(slstm_bwd_kernel<__nv_bfloat16, true>,
                             (const __nv_bfloat16*)nullptr)
                  : (int)run(slstm_bwd_kernel<__nv_bfloat16, false>,
                             (const __nv_bfloat16*)nullptr);
  }
  return (int)cudaErrorInvalidValue;
}

// How many clusters of B8-bwd (f32 R) at head size Dh the card runs at
// once (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int slstm_bwd_max_clusters(int Dh, int cluster, int* out) {
  if (!shape_ok(1, 1, Dh, cluster)) return (int)cudaErrorInvalidValue;
  auto kernel = helper(Dh) ? slstm_bwd_kernel<float, true>
                           : slstm_bwd_kernel<float, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes());
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes();
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, (void*)kernel, &cfg);
}
