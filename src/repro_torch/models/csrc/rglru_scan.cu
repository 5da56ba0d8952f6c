// RG-LRU gates and linear scan (B6), for sm_90a.
//
// Replaces `rglru_apply` of src/repro/models/rglru.py (the gates of
// `_gates` and a `jax.lax.associative_scan` over T):
//
//   r = sigmoid(wa), i = sigmoid(wx)                 (dense outputs in)
//   a = exp(-8 softplus(lam) r),  b = sqrt(max(1 - a^2, 1e-9)) i x
//   h_t = a_t h_{t-1} + b_t,  y_t = h_t in x's type,  h_last = h_T (f32)
//
// over (B, T, D), f32 arithmetic whatever the input type.
//
// What bounds it on an H100: bytes. The least traffic is each input read
// once and y written once, 8 bytes per (b, t, d) in bf16 (16 in f32):
// 0.32 ms at recurrentgemma-9b's prefill (1 x 32,768 x 4,096) at 3.35
// TB/s. Next come the special-function units: six MUFU operations per
// element (an exponential and a reciprocal per sigmoid, the exponential of
// a, the square root), about 0.19 ms at 16 a clock on 132 SMs.
//
// Design: one launch, a single pass with decoupled look-back. A block
// owns a tile of L = W x R = 96 steps by C = 32 V = 128 channels of one
// batch row (W = 8 warps of R = 12 steps, V = 4; the TILE_ constants, see
// below for why): lane l of warp w holds channels [V l, V (l + 1)) of the
// tile — 8 bytes of a bf16 row (16 of f32) in one load, so a warp reads
// 256 contiguous bytes — and rows [w R, (w + 1) R). A block
//
//   1. takes its tile from an atomic counter, in the order (t-tile, b,
//      channel tile), so every tile it may wait for took its number
//      earlier and is resident or done: no block waits on one that is
//      not scheduled. While the counter answers, it asks L2 for the rows
//      of tile blockIdx.x: blocks start about in index order, so that
//      tile's owner, whichever block it is, starts about now (a hint;
//      correctness never rests on it);
//   2. loads its R rows (all in flight at once), computes (a, b) once,
//      keeps them in shared memory for step 5, and scans them from 0:
//      each warp's segment maps h -> P h + H;
//   3. composes the W segments in shared memory: each warp's exclusive
//      prefix and the tile's aggregate (A, H);
//   4. publishes the aggregate with the flag AGG (tile 0 of a row, which
//      knows its h0, publishes its inclusive h at once), then looks back:
//      warp 0 reads the flags of the 32 tiles before it, and the nearest
//      INC behind a run of AGGs ends the walk; the block composes those
//      tiles' aggregates onto that tile's inclusive h (a window of 32
//      AGGs without an INC is composed and the walk goes on). It
//      publishes its own inclusive h (flag INC);
//   5. runs each warp's R steps on from its incoming h — h = a h + b, the
//      plain recurrence — and writes y; the tile holding step T - 1
//      writes h_last from the same f32 value that y rounds.
//
// Ordering. The block stores its aggregate or inclusive values at L2
// (`st.cg`); a block barrier; then thread 0 stores the flag with
// `st.release.gpu`, which is cumulative over the stores the barrier
// ordered before it (the pattern of CUTLASS's semaphore). A reader's warp
// 0 loads flags with `ld.acquire.gpu`; a block barrier; then the block
// loads the values with `ld.cg` (L2, never a stale L1 line). So a flag
// seen as AGG or INC orders every value it covers before the read, and no
// value is torn: each tile writes its aggregate once and its inclusive
// value once, and never changes either. Flags and the counter are zeroed
// by a memset on the stream before every launch, so no launch reads
// another's flags.
//
// What sets the time: each tile's chain of latencies — the counter, the
// loads, the gates, the barriers, the look-back's round trips to L2 — so
// what helps is more elements a tile, more tiles resident an SM, and
// loads that find their rows already in L2. Trial builds on the way here
// ran slower: (a, b) in registers (one block an SM at 32 x 256), smaller
// tiles at three blocks an SM, persistent blocks that prefetch their next
// tile, and a hint of the tile a block's SM takes a wave later. The tiles
// tried, L x C x W, each built beside the others and timed at the main
// shape in turns by chip_smoke.py (NVIDIA H100 80GB HBM3 at 700 W): 64 x
// 128 x 8, 0.562 ms; 64 x 128 x 16, 0.553; 96 x 128 x 8, 0.537 (the one
// kept: two blocks, 16 warps, an SM); 128 x 128 x 16 (one block an SM),
// 0.584; 64 x 256 x 16 (16-byte bf16 loads, one block an SM), 0.625.
//
// Ragged edges: steps past T are (a, b) = (1, 0); channels past D read
// 0 (a = 1, b = 0) and are not written; rows of B are independent chains.
// Without 16-byte alignment (D % 8 != 0 or an offset pointer) the loads
// and stores go one element at a time.
//
// The gates use the fast intrinsics (__expf, __fdividef, sqrt.approx):
// their errors, a few ulp, stay far inside the kernel's tolerance (1e-4
// of the largest |y|, chip_smoke.py). softplus(lam) is computed once per
// thread and channel with the precise functions.
//
// Scratch (`rglru_scan_scratch_bytes`): per tile an aggregate (2 f32) and
// an inclusive h (1 f32) per channel and one flag: 12 bytes per (tile,
// channel), 0.125 bytes per element at L = 96 against the 8 of bf16
// input and output.
//
// Training launches this kernel as it is. Its backward (rglru_scan_bwd.cu)
// needs the f32 h_{t-1} of every step, which under bf16 compute y does not
// hold; rather than write h (4 more bytes an element each way), the
// wrapper keeps this scratch, whose inclusive h of each tile is the h
// entering the next, and B6-bwd recomputes h inside each tile from it.
// The helpers and the tile are shared with it (rglru_tiles.cuh).

#include "rglru_tiles.cuh"

using namespace rglru;

namespace {

// One tile of L = WARPS x R steps by C = 32 V channels (module note). The
// (a, b) of its elements wait in dynamic shared memory for step 5.
template <typename TX, typename TL, bool VEC>
__global__ void __launch_bounds__(TILE_WARPS * 32, TILE_MINB)
rglru_scan_kernel(const TX* __restrict__ wa, const TX* __restrict__ wx,
                  const TX* __restrict__ x, const TL* __restrict__ lam,
                  const float* __restrict__ h0, TX* __restrict__ y,
                  float* __restrict__ h_last, float2* agg, float* inc,
                  int* flags, int* counter, int B, int T, int D, int nDC) {
  constexpr int WARPS = TILE_WARPS, R = TILE_R, V = TILE_V, L = TILE_L,
                C = TILE_C;
  static_assert(WARPS * 32 >= C, "one thread per channel of the tile");
  extern __shared__ float2 ab[];    // [R][WARPS][C]: (a, b) of each element
  __shared__ float2 seg[WARPS][C];  // segment maps, then exclusive prefixes
  __shared__ float s_hin[C];        // the tile's incoming h per channel
  __shared__ int s_tile, s_n, s_done;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(counter, 1);
  {
    // While the counter answers: the rows of tile blockIdx.x to L2. Blocks
    // start about in index order, so that tile's owner, whichever block
    // it is, starts about now; a hint only, correctness never rests on it.
    constexpr int LANES_A_LINE = 128 / (V * (int)sizeof(TX));
    const int id = blockIdx.x;
    const int pb = (id / nDC) % B;
    const int pt0 = id / nDC / B * L + warp * R;
    const int pc0 = id % nDC * C + lane * V;
    if (lane % LANES_A_LINE == 0 && pc0 < D) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (pt0 + r < T) {
          const int64_t i = ((int64_t)pb * T + pt0 + r) * D + pc0;
          asm volatile("prefetch.global.L2 [%0];" :: "l"(wa + i));
          asm volatile("prefetch.global.L2 [%0];" :: "l"(wx + i));
          asm volatile("prefetch.global.L2 [%0];" :: "l"(x + i));
        }
      }
    }
  }
  __syncthreads();
  const int tile = s_tile;
  const int dc = tile % nDC;
  const int b = (tile / nDC) % B;
  const int tt = tile / nDC / B;
  const int c0 = dc * C + lane * V;  // this thread's first channel
  const int nch = D - c0;            // how many of its V exist
  const int t0 = tt * L + warp * R;  // its first step

  // 2. Loads, gates, and the warp's segment scanned from 0.
  Raw<TX, V> ra[R], rx[R], rv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int t = t0 + r;
    const int n = t < T ? nch : 0;
    const int64_t i = ((int64_t)b * T + t) * D + c0;
    ra[r] = load_raw<VEC, TX, V>(wa, i, n);
    rx[r] = load_raw<VEC, TX, V>(wx, i, n);
    rv[r] = load_raw<VEC, TX, V>(x, i, n);
  }
  float k[V];  // -8 softplus(lam); 0 past D, so that a = 1 and b = 0 there
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float l = j < nch ? load_lam(lam, c0 + j) : 0.0f;
    k[j] = j < nch ? -8.0f * (fmaxf(l, 0.0f) + log1pf(expf(-fabsf(l))))
                   : 0.0f;
  }
  float P[V], H[V];
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
  // Slot s = j * 32 + lane of a tile holds channel dc * C + lane * V + j.
#pragma unroll
  for (int j = 0; j < V; ++j) seg[warp][j * 32 + lane] = make_float2(P[j], H[j]);
  __syncthreads();

  // 3. Each warp's exclusive prefix and the tile's aggregate, per slot.
  const int s = tid;
  const bool slot = s < C;
  Map tot = {1.0f, 0.0f};
  if (slot) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float2 m = seg[w][s];
      seg[w][s] = make_float2(tot.A, tot.H);
      tot.H = fmaf(m.x, tot.H, m.y);
      tot.A *= m.x;
    }
  }

  // 4. Publish, look back, publish the inclusive h. Tile id = (tt * B +
  // b) * nDC + dc, so the t-tiles of one chain are `stride` apart.
  const int64_t row = (int64_t)b * nDC + dc;
  const int64_t stride = (int64_t)B * nDC;
  float hin = 0.0f;
  if (tt == 0) {
    const int ch = dc * C + (s & 31) * V + (s >> 5);
    if (slot && h0 && ch < D) hin = h0[(int64_t)b * D + ch];
  } else {
    if (slot) __stcg(agg + (int64_t)tile * C + s, make_float2(tot.A, tot.H));
    __syncthreads();
    if (tid == 0) st_release(flags + tile, AGG);
    Map acc = {1.0f, 0.0f};  // the tiles between the nearest INC and this
    int hi = tt - 1;         // nearest t-tile not yet composed
    for (;;) {
      if (warp == 0) {
        const int j = hi - lane;
        const int* f = flags + (row + (int64_t)j * stride);
        int n, done;
        for (;;) {
          const int st = j >= 0 ? ld_acquire(f) : 0;
          const unsigned incs = __ballot_sync(~0u, j >= 0 && st == INC);
          const unsigned none = __ballot_sync(~0u, j >= 0 && st == 0);
          if (incs) {
            const int first = __ffs(incs) - 1;
            if (!(none & ((1u << first) - 1u))) {
              n = first;
              done = 1;
              break;
            }
          } else if (!none) {
            n = 32;  // 32 AGGs and no INC (hi >= 32: tile 0 is never AGG)
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
          for (int q = 0; q < 8; ++q)
            g[q] = q0 + q < n
                       ? __ldcg(agg + (row + (int64_t)(hi - q0 - q) * stride) * C + s)
                       : make_float2(1.0f, 0.0f);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            acc.H = fmaf(acc.A, g[q].y, acc.H);
            acc.A *= g[q].x;
          }
        }
        if (done)
          hin = fmaf(acc.A,
                     __ldcg(inc + (row + (int64_t)(hi - n) * stride) * C + s),
                     acc.H);
      }
      if (done) break;
      hi -= n;
      __syncthreads();  // every thread has read s_n before warp 0 rewrites it
    }
  }
  if (slot) {
    s_hin[s] = hin;
    __stcg(inc + (int64_t)tile * C + s, fmaf(tot.A, hin, tot.H));
  }
  __syncthreads();
  if (tid == 0) st_release(flags + tile, INC);

  // 5. Each warp's steps from its incoming h; y and h_last.
  float h[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int sj = j * 32 + lane;
    const float2 e = seg[warp][sj];
    h[j] = fmaf(e.x, s_hin[sj], e.y);
  }
  const int last = T - 1 - t0;  // row of step T - 1 in this thread, if any
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float2 e = ab[(r * WARPS + warp) * C + j * 32 + lane];
      h[j] = fmaf(e.x, h[j], e.y);
    }
    const int t = t0 + r;
    if (t < T) store_row<VEC, V>(y, ((int64_t)b * T + t) * D + c0, nch, h);
    if (r == last) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (j < nch) h_last[(int64_t)b * D + c0 + j] = h[j];
    }
  }
}

template <typename TX, typename TL>
cudaError_t launch(const void* wa, const void* wx, const void* x,
                   const void* lam, const float* h0, void* y, float* h_last,
                   void* scratch, int B, int T, int D, bool vec,
                   cudaStream_t s) {
  constexpr size_t smem = (size_t)TILE_L * TILE_C * sizeof(float2);
  const int64_t ntiles = tiles(B, T, D);
  float2* agg = (float2*)scratch;
  float* inc = (float*)(agg + ntiles * TILE_C);
  int* flags = (int*)(inc + ntiles * TILE_C);
  cudaError_t err =
      cudaMemsetAsync(flags, 0, (ntiles + 1) * sizeof(int), s);
  if (err != cudaSuccess) return err;
  auto kernel = vec ? rglru_scan_kernel<TX, TL, true>
                    : rglru_scan_kernel<TX, TL, false>;
  // Static and dynamic shared memory together may pass the default 48 KB.
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  kernel<<<(unsigned)ntiles, TILE_WARPS * 32, smem, s>>>(
      (const TX*)wa, (const TX*)wx, (const TX*)x, (const TL*)lam, h0,
      (TX*)y, h_last, agg, inc, flags, flags + ntiles, B, T, D,
      (D + TILE_C - 1) / TILE_C);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch a (B, T, D) launch needs.
extern "C" int64_t rglru_scan_scratch_bytes(int B, int T, int D) {
  return tiles(B, T, D) * ((int64_t)TILE_C * 12 + 4) + 4;
}

// dtype codes: 0 float32, 1 bfloat16 (x_dtype for wa / wx / x / y, lam_dtype
// for lam). h0 may be null (zeros). scratch: `rglru_scan_scratch_bytes(B,
// T, D)` bytes, any contents.
extern "C" int rglru_scan_launch(const void* wa, const void* wx,
                                 const void* x, const void* lam,
                                 const void* h0, void* y, void* h_last,
                                 void* scratch, int B, int T, int D,
                                 int x_dtype, int lam_dtype, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0) return 0;
  if (tiles(B, T, D) >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* h = (const float*)h0;
  float* hl = (float*)h_last;
  const bool vec = D % 8 == 0 && aligned16(wa) && aligned16(wx) &&
                   aligned16(x) && aligned16(y);
  if (x_dtype == 0 && lam_dtype == 0)
    return (int)launch<float, float>(
        wa, wx, x, lam, h, y, hl, scratch, B, T, D, vec, s);
  if (x_dtype == 0 && lam_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(
        wa, wx, x, lam, h, y, hl, scratch, B, T, D, vec, s);
  if (x_dtype == 1 && lam_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(
        wa, wx, x, lam, h, y, hl, scratch, B, T, D, vec, s);
  if (x_dtype == 1 && lam_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        wa, wx, x, lam, h, y, hl, scratch, B, T, D, vec, s);
  return (int)cudaErrorInvalidValue;
}
