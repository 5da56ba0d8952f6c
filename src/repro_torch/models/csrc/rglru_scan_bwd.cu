// B6-bwd: the backward of the RG-LRU gates and linear scan (rglru_scan.cu),
// for sm_90a.
//
// Replaces the backward that the JAX package gets by differentiating
// `rglru_apply` of src/repro/models/rglru.py (`jax.grad` through `_gates`
// and the `associative_scan`); the TPU side has no kernel of its own for
// it. With r = sigmoid(wa), i = sigmoid(wx), k = -8 softplus(lam),
// a = exp(k r), s = sqrt(max(1 - a^2, 1e-9)), b = s i x, h_t = a_t h_{t-1}
// + b_t, and u_t = a_t g_t the gradient step t hands to step t - 1:
//
//   g_t = dy_t + u_{t+1}   (u_{T+1} = dh_last, 0 when there is none)
//   da  = g h_{t-1} - [1 - a^2 >= 1e-9] g i x a / s
//   dwa = da a k r (1 - r),  dwx = g s x i (1 - i),  dx = g s i
//   dlam = -8 sigmoid(lam) sum over B and T of da a r,  dh0 = u_1
//
// (dh0 = a_1 g_1: the reference folds h0 into b_1). Where the clamp binds
// (a = 1 in f32) the square root passes a nothing; i and x still get their
// share. f32 arithmetic whatever the input type.
//
// What bounds it on an H100: bytes. wa, wx, x and dy read once and dwa,
// dwx, dx written once, 14 bytes per (b, t, d) in bf16 (28 in f32), plus
// the forward's inclusive h, 4 bytes per (tile, channel): 0.14 ms at
// recurrentgemma-9b's training microbatch (2 x 4,096 x 4,096 bf16) at
// 3.35 TB/s.
//
// Design: the forward's (rglru_scan.cu), run from the end of T. One
// launch; a block owns a tile of the forward's shape (rglru_tiles.cuh: L =
// 96 steps by C = 128 channels of one batch row), so that the inclusive h
// the forward left for the tile before is the h entering this one — that
// is what the wrapper keeps of the forward, not h itself. The block cuts
// the tile into 16 warps of 6 steps (the forward: 8 of 12), one block an
// SM, so that a bf16 tile's rows of wa, wx, x and dy, 48 words a thread,
// stay in registers from step 2 to step 5 and are read from memory once
// (f32 rows, 96 words, are loaded again in step 5). A block
//
//   1. takes its tile from an atomic counter, in the order (t-tile from
//      the last, b, channel tile), so every tile it may wait for took its
//      number earlier and is resident or done;
//   2. loads its rows of wa, wx, x and dy, keeps (a, b) in shared memory,
//      forms its warp's segment of the forward map h -> P h + H and of the
//      reverse map u -> P u + H (P the product of a over the rows, H =
//      sum_r (prod_{q<=r} a_q) dy_r);
//   3. composes the warps: each warp's incoming h (the tile's from the
//      forward's scratch, h0 or 0 at t-tile 0), and each warp's exclusive
//      suffix of reverse maps and the tile's aggregate;
//   4. publishes the aggregate with the flag AGG (the tile holding step
//      T - 1 knows its incoming u, dh_last, and publishes its inclusive u
//      at once) and looks ahead: warp 0 reads the flags of the 32 tiles
//      after it, and the nearest INC behind a run of AGGs ends the walk,
//      as the forward's look-back does in the other direction. It
//      publishes its inclusive u (u at its first step; at t-tile 0 that
//      is dh0);
//   5. recomputes each warp's h from its incoming h (h_{t-1} replaces b in
//      shared memory), then walks each warp's rows from the last: g, u,
//      the gate chain, dwa, dwx, dx written;
//   6. sums its rows' da a r per warp (from the last row), then over the
//      warps in order, and adds -8 sigmoid(lam) times that into dlam, one
//      f32 atomic per channel and tile. The order in which those land
//      varies from launch to launch, so dlam may differ in its last bits
//      between two calls on the same inputs (`rglru_scan_bwd_tiles_plain`
//      in rglru.py sums in this order).
//
// The split of the first design (8 warps of 12 steps, two blocks an SM,
// the rows loaded again in step 5; H100 at recurrentgemma-9b's training
// microbatch, tools/bwd_parts.py, PERF.md §7): 0.344 ms, of which step 5
// 0.188 (its loads again 0.094, its stores 0.091), the look-ahead wait
// 0.015, dlam's atomics 0.004. This design takes 0.328: one block an SM
// leaves the serial steps 3, 4 and 6 with no other block to hide them
// (the first design without its loads again, two blocks an SM, took
// 0.251; its registers leave no room to keep the rows there). Tried and
// slower than the first design on the card: half the channels a tile (8
// warps of 12 steps, 2 channels a lane, rows kept, two blocks an SM),
// which spilled.
//
// Ordering of the look-ahead as in the forward: values stored at L2
// (`st.cg`), a block barrier, then the flag with `st.release.gpu`; flags
// read with `ld.acquire.gpu`, a block barrier, values with `ld.cg`. Flags,
// the counter and dlam are zeroed on the stream before every launch.
//
// Ragged edges as in the forward: steps past T are (a, b) = (1, 0) with dy
// 0, channels past D read 0 (a = 1, b = 0) and are not written; without
// 16-byte alignment the loads and stores go one element at a time. The
// gates use the forward's fast intrinsics, so h is recomputed as the
// forward computed it.

#include "rglru_tiles.cuh"

using namespace rglru;

namespace {

// The forward's tile, cut into 16 warps of 6 steps (module note), one
// block an SM.
constexpr int BWD_WARPS = 16, BWD_R = TILE_L / BWD_WARPS;
static_assert(BWD_WARPS * BWD_R == TILE_L, "the forward's tile");

template <typename TX, typename TL, bool VEC>
__global__ void __launch_bounds__(BWD_WARPS * 32, 1)
rglru_scan_bwd_kernel(const TX* __restrict__ wa, const TX* __restrict__ wx,
                      const TX* __restrict__ x, const TL* __restrict__ lam,
                      const float* __restrict__ h0,
                      const float* __restrict__ h_inc,
                      const TX* __restrict__ dy,
                      const float* __restrict__ dh_last,
                      TX* __restrict__ dwa, TX* __restrict__ dwx,
                      TX* __restrict__ dx, float* __restrict__ dlam,
                      float* __restrict__ dh0, float2* agg, float* inc,
                      int* flags, int* counter, int B, int T, int D, int nDC,
                      int nT) {
  constexpr int WARPS = BWD_WARPS, R = BWD_R, V = TILE_V, L = TILE_L,
                C = TILE_C;
  // bf16 rows stay in registers from step 2 to step 5 (48 words a thread);
  // f32 rows (96) are loaded again in step 5.
  constexpr bool KEEP = sizeof(TX) == 2;
  static_assert(WARPS * 32 >= C, "one thread per channel of the tile");
  extern __shared__ float2 ab[];    // [R][WARPS][C]: (a, b), then (a, h_{t-1})
  __shared__ float2 seg[WARPS][C];  // forward, then reverse segment maps
  __shared__ float hw[WARPS][C];    // each warp's incoming h; then dlam sums
  __shared__ float s_uin[C];        // u entering the tile from the next
  __shared__ int s_tile, s_n, s_done;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const int q = s_tile;
  const int dc = q % nDC;
  const int b = (q / nDC) % B;
  const int tt = nT - 1 - q / nDC / B;
  const int64_t pos = ((int64_t)tt * B + b) * nDC + dc;  // forward numbering
  const int c0 = dc * C + lane * V;  // this thread's first channel
  const int nch = D - c0;            // how many of its V exist
  const int t0 = tt * L + warp * R;  // its first step
  const int s = tid;                 // slot s = j * 32 + lane: channel
  const bool slot = s < C;           // dc * C + lane * V + j
  const int ch = dc * C + (s & 31) * V + (s >> 5);

  // 2. Gates and both segment maps of the warp's rows.
  float k[V];  // -8 softplus(lam); 0 past D, so that a = 1 and b = 0 there
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float l = j < nch ? load_lam(lam, c0 + j) : 0.0f;
    k[j] = j < nch ? -8.0f * (fmaxf(l, 0.0f) + log1pf(expf(-fabsf(l))))
                   : 0.0f;
  }
  float P[V], H[V];
  Raw<TX, V> ra[R], rx[R], rv[R], rd[R];
  {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + r;
      const int n = t < T ? nch : 0;
      const int64_t i = ((int64_t)b * T + t) * D + c0;
      ra[r] = load_raw<VEC, TX, V>(wa, i, n);
      rx[r] = load_raw<VEC, TX, V>(wx, i, n);
      rv[r] = load_raw<VEC, TX, V>(x, i, n);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      P[j] = 1.0f;
      H[j] = 0.0f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool live = t0 + r < T;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float a = __expf(k[j] * fast_sigmoid(unpack(ra[r], j)));
        const float g = fast_sigmoid(unpack(rx[r], j)) * unpack(rv[r], j);
        float bb = fast_sqrt(fmaxf(1.0f - a * a, 1e-9f)) * g;
        a = live ? a : 1.0f;
        bb = live ? bb : 0.0f;
        ab[(r * WARPS + warp) * C + j * 32 + lane] = make_float2(a, bb);
        H[j] = fmaf(a, H[j], bb);
        P[j] *= a;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) seg[warp][j * 32 + lane] = make_float2(P[j], H[j]);
  {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + r;
      rd[r] = load_raw<VEC, TX, V>(dy, ((int64_t)b * T + t) * D + c0,
                                   t < T ? nch : 0);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      P[j] = 1.0f;
      H[j] = 0.0f;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        P[j] *= ab[(r * WARPS + warp) * C + j * 32 + lane].x;
        H[j] = fmaf(P[j], unpack(rd[r], j), H[j]);
      }
    }
  }
  __syncthreads();

  // 3. Each warp's incoming h; then each warp's exclusive suffix of
  // reverse maps and the tile's aggregate, per slot.
  if (slot) {
    float h = 0.0f;
    if (tt > 0)
      h = h_inc[(pos - (int64_t)B * nDC) * C + s];
    else if (h0 && ch < D)
      h = h0[(int64_t)b * D + ch];
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float2 m = seg[w][s];
      hw[w][s] = h;
      h = fmaf(m.x, h, m.y);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < V; ++j) seg[warp][j * 32 + lane] = make_float2(P[j], H[j]);
  __syncthreads();
  Map tot = {1.0f, 0.0f};
  if (slot) {
#pragma unroll
    for (int w = WARPS - 1; w >= 0; --w) {
      const float2 m = seg[w][s];
      seg[w][s] = make_float2(tot.A, tot.H);
      tot.H = fmaf(m.x, tot.H, m.y);
      tot.A *= m.x;
    }
  }

  // 4. Publish, look ahead, publish the inclusive u. The t-tiles of one
  // chain are `stride` apart.
  const int64_t row = (int64_t)b * nDC + dc;
  const int64_t stride = (int64_t)B * nDC;
  float uin = 0.0f;
  if (tt == nT - 1) {
    if (slot && dh_last && ch < D) uin = dh_last[(int64_t)b * D + ch];
  } else {
    if (slot) __stcg(agg + pos * C + s, make_float2(tot.A, tot.H));
    __syncthreads();
    if (tid == 0) st_release(flags + pos, AGG);
    Map acc = {1.0f, 0.0f};  // the tiles between this and the nearest INC
    int lo = tt + 1;         // nearest t-tile not yet composed
    for (;;) {
      if (warp == 0) {
        const int j = lo + lane;
        const int* f = flags + (row + (int64_t)j * stride);
        int n, done;
        for (;;) {
          const int st = j < nT ? ld_acquire(f) : 0;
          const unsigned incs = __ballot_sync(~0u, j < nT && st == INC);
          const unsigned none = __ballot_sync(~0u, j < nT && st == 0);
          if (incs) {
            const int first = __ffs(incs) - 1;
            if (!(none & ((1u << first) - 1u))) {
              n = first;
              done = 1;
              break;
            }
          } else if (!none) {
            n = 32;  // 32 AGGs and no INC (the last t-tile is never AGG)
            done = 0;
            break;
          }
          __nanosleep(32);
        }
        if (lane == 0) {
          s_n = n;
          s_done = done;
        }
      }
      __syncthreads();
      const int n = s_n, done = s_done;
      if (slot) {
        for (int q0 = 0; q0 < n; q0 += 8) {
          float2 g[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            g[e] = q0 + e < n
                       ? __ldcg(agg + (row + (int64_t)(lo + q0 + e) * stride) * C + s)
                       : make_float2(1.0f, 0.0f);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            acc.H = fmaf(acc.A, g[e].y, acc.H);
            acc.A *= g[e].x;
          }
        }
        if (done)
          uin = fmaf(acc.A,
                     __ldcg(inc + (row + (int64_t)(lo + n) * stride) * C + s),
                     acc.H);
      }
      if (done) break;
      lo += n;
      __syncthreads();  // every thread has read s_n before warp 0 rewrites it
    }
  }
  if (slot) {
    s_uin[s] = uin;
    const float uout = fmaf(tot.A, uin, tot.H);
    __stcg(inc + pos * C + s, uout);
    if (tt == 0 && dh0 && ch < D) dh0[(int64_t)b * D + ch] = uout;
  }
  __syncthreads();
  if (tid == 0) st_release(flags + pos, INC);

  // 5. h_{t-1} of each row, then the rows from the last: g, u, the chain.
  float h[V], u[V], dl[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int sj = j * 32 + lane;
    h[j] = hw[warp][sj];
    const float2 e = seg[warp][sj];
    u[j] = fmaf(e.x, s_uin[sj], e.y);
    dl[j] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float2* e = &ab[(r * WARPS + warp) * C + j * 32 + lane];
      const float2 v = *e;
      e->y = h[j];
      h[j] = fmaf(v.x, h[j], v.y);
    }
  }
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const int t = t0 + r;
    const int n = t < T ? nch : 0;
    const int64_t i = ((int64_t)b * T + t) * D + c0;
    const Raw<TX, V> ga = KEEP ? ra[r] : load_raw<VEC, TX, V>(wa, i, n);
    const Raw<TX, V> gx = KEEP ? rx[r] : load_raw<VEC, TX, V>(wx, i, n);
    const Raw<TX, V> gv = KEEP ? rv[r] : load_raw<VEC, TX, V>(x, i, n);
    const Raw<TX, V> gd = KEEP ? rd[r] : load_raw<VEC, TX, V>(dy, i, n);
    float o_wa[V], o_wx[V], o_x[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float2 e = ab[(r * WARPS + warp) * C + j * 32 + lane];
      const float a = e.x, hp = e.y;
      const float g = unpack(gd, j) + u[j];
      u[j] = a * g;
      const float rr = fast_sigmoid(unpack(ga, j));
      const float ii = fast_sigmoid(unpack(gx, j));
      const float xv = unpack(gv, j);
      const float s2 = 1.0f - a * a;
      const float sq = fast_sqrt(fmaxf(s2, 1e-9f));
      const float gs = g * sq;
      float da = g * hp;
      if (s2 >= 1e-9f) da -= g * ii * xv * __fdividef(a, sq);
      const float dk = da * a * rr;
      o_wa[j] = dk * k[j] * (1.0f - rr);
      o_wx[j] = gs * xv * ii * (1.0f - ii);
      o_x[j] = gs * ii;
      if (t < T) dl[j] += dk;
    }
    if (t < T) {
      store_row<VEC, V>(dwa, i, nch, o_wa);
      store_row<VEC, V>(dwx, i, nch, o_wx);
      store_row<VEC, V>(dx, i, nch, o_x);
    }
  }

  // 6. dlam: the warps' sums per channel, one atomic per channel.
  __syncthreads();  // every warp has read hw
#pragma unroll
  for (int j = 0; j < V; ++j) hw[warp][j * 32 + lane] = dl[j];
  __syncthreads();
  if (slot && ch < D) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += hw[w][s];
    const float l = load_lam(lam, ch);
    atomicAdd(dlam + ch, -8.0f * sum / (1.0f + expf(-l)));
  }
}

template <typename TX, typename TL>
cudaError_t launch(const void* wa, const void* wx, const void* x,
                   const void* lam, const float* h0, const void* fwd_scratch,
                   const void* dy, const float* dh_last, void* dwa, void* dwx,
                   void* dx, float* dlam, float* dh0, void* scratch, int B,
                   int T, int D, bool vec, cudaStream_t s) {
  constexpr size_t smem = (size_t)TILE_L * TILE_C * sizeof(float2);
  const int64_t ntiles = tiles(B, T, D);
  // The forward's scratch: aggregates, then each tile's inclusive h.
  const float* h_inc =
      (const float*)((const float2*)fwd_scratch + ntiles * TILE_C);
  float2* agg = (float2*)scratch;
  float* inc = (float*)(agg + ntiles * TILE_C);
  int* flags = (int*)(inc + ntiles * TILE_C);
  cudaError_t err =
      cudaMemsetAsync(flags, 0, (ntiles + 1) * sizeof(int), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(dlam, 0, (size_t)D * sizeof(float), s);
  if (err != cudaSuccess) return err;
  auto kernel = vec ? rglru_scan_bwd_kernel<TX, TL, true>
                    : rglru_scan_bwd_kernel<TX, TL, false>;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  kernel<<<(unsigned)ntiles, BWD_WARPS * 32, smem, s>>>(
      (const TX*)wa, (const TX*)wx, (const TX*)x, (const TL*)lam, h0, h_inc,
      (const TX*)dy, dh_last, (TX*)dwa, (TX*)dwx, (TX*)dx, dlam, dh0, agg,
      inc, flags, flags + ntiles, B, T, D, (D + TILE_C - 1) / TILE_C,
      (T + TILE_L - 1) / TILE_L);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch a (B, T, D) launch needs (the forward's layout).
extern "C" int64_t rglru_scan_bwd_scratch_bytes(int B, int T, int D) {
  return tiles(B, T, D) * ((int64_t)TILE_C * 12 + 4) + 4;
}

// dtype codes: 0 float32, 1 bfloat16 (x_dtype for wa / wx / x / dy and the
// three gradients of x's type, lam_dtype for lam). fwd_scratch: the scratch
// of rglru_scan_launch on the same inputs, after it ran. h0, dh_last may be
// null (zeros); dh0 is written where it is not null. dlam: D floats, f32.
// scratch: `rglru_scan_bwd_scratch_bytes(B, T, D)` bytes, any contents.
extern "C" int rglru_scan_bwd_launch(
    const void* wa, const void* wx, const void* x, const void* lam,
    const void* h0, const void* fwd_scratch, const void* dy,
    const void* dh_last, void* dwa, void* dwx, void* dx, void* dlam,
    void* dh0, void* scratch, int B, int T, int D, int x_dtype,
    int lam_dtype, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0) return 0;
  if (tiles(B, T, D) >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* h = (const float*)h0;
  const float* dhl = (const float*)dh_last;
  float* dl = (float*)dlam;
  float* dh = (float*)dh0;
  const bool vec = D % 8 == 0 && aligned16(wa) && aligned16(wx) &&
                   aligned16(x) && aligned16(dy) && aligned16(dwa) &&
                   aligned16(dwx) && aligned16(dx);
#define RGLRU_BWD_ARGS                                                     \
  wa, wx, x, lam, h, fwd_scratch, dy, dhl, dwa, dwx, dx, dl, dh, scratch, \
      B, T, D, vec, s
  if (x_dtype == 0 && lam_dtype == 0)
    return (int)launch<float, float>(RGLRU_BWD_ARGS);
  if (x_dtype == 0 && lam_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(RGLRU_BWD_ARGS);
  if (x_dtype == 1 && lam_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(RGLRU_BWD_ARGS);
  if (x_dtype == 1 && lam_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(RGLRU_BWD_ARGS);
#undef RGLRU_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
