// Chunkwise mLSTM (B7) as three chunk-parallel passes, for sm_90a.
//
// Replaces the chunk loop of `mlstm_chunkwise` in src/repro/models/xlstm.py
// (a `lax.scan` of `chunk_step` over chunks, `cummax` inside). Per (b,
// head) a carried state C (D x D), n (D), m; per chunk of L steps, with
// b = cumsum(f~), w = i~ - b, g = cummax(w), M_r = max(m, g_r):
//
//   P[r,s]  = (s <= r) exp(w_s - M_r) (q_r . k_s)
//   h~_r    = exp(m - M_r) (q_r C) + sum_s P[r,s] v_s
//   dot_r   = exp(m - M_r) (n . q_r) + sum_s P[r,s]
//   h_r     = h~_r / max(|dot_r|, exp(-(b_r + M_r)))
//   C' = exp(m - M_c) C + sum_s exp(w_s - M_c) k_s v_s^T,  n' likewise,
//   m' = b_last + M_c,  M_c = max(m, G),  G = max_s w_s.
//
// The recurrence carries only (C, n, m), and a chunk's own inputs enter it
// through G, b_last and sum_s exp(w_s - G) k_s v_s^T alone. So only a
// cheap elementwise scan stays serial:
//
//   1. chunk states (`mlstm_chunk_states_kernel`), one block per (64 rows
//      of dC, b, head, chunk): dC = sum_s exp(w_s - G) k_s v_s^T, dn =
//      sum_s exp(w_s - G) k_s, b_last and G, into a scratch the wrapper
//      allocates;
//   2. inter-chunk scan (`mlstm_state_scan_kernel`), one thread per four
//      elements of (C, n) of a (b, head), serial over chunks: the scalar m
//      recurrence in the reference's float operations (M_c = max(m, G),
//      exp(m - M_c), m' = b_last + M_c), then C = exp(m - M_c) C +
//      exp(G - M_c) dC in place, so that the scratch ends holding each
//      chunk's incoming (C, n, m); the final state goes to C1, n1, m1;
//   3. chunk outputs (`mlstm_chunk_outputs_kernel`), one block per (b,
//      head, chunk): the formulas above from the chunk's q, k, v, gates and
//      its incoming state.
//
// The one reassociation of the reference's state update is exp(w_s - M_c)
// = exp(w_s - G) exp(G - M_c) (both factors <= 1); dot_r reassociates
// (sum_s Dw[r,s] k_s) . q_r as sum_s Dw[r,s] (k_s . q_r), reusing P, as
// the first design did. Everything at f32 accuracy, the products on bf16
// pieces (below).
//
// Layout. The scratch holds per (b, head, chunk) D + 1 rows of DP floats
// (DP = D rounded up to 64): rows 0..D-1 are dC then the incoming C, row D
// is dn then the incoming n, zero past column D; and four scalars (b_last,
// G, incoming m, unused). At xlstm-125m's 1 x 4 heads x 512 chunks x D 192
// that is 303.6 MB, written once by pass 1, read and written once by pass
// 2 and read once by pass 3. B7-bwd reads it as it is.
//
// Products: bf16 wgmma on three pieces an f32 operand. Each f32 operand x
// is cut as it is staged into shared memory: x1 = bf16(x), x2 = bf16(x -
// x1), x3 = bf16(x - x1 - x2), all rounded to nearest, the remainders exact
// and x1 + x2 + x3 == x (for |x| >= 2^-110); a product is the six piece
// products a_i b_j with i + j <= 2 (0-based) of each 16 rows of K, the
// small terms first, into one f32 accumulator (the f32 attention
// backward's recipe, kernels/local_attention/csrc/flash_tf32x3_bwd.cu;
// B7-bwd's on mma.sync). The three dropped products are below 2^-23
// |a||b| each, so every product keeps f32 accuracy. Why not tf32 hi + lo:
// tf32 wgmma takes only K-major operands from shared memory, and four of
// the five products here read an operand MN-major (C_in and v in pass 3,
// (a k)^T and v in pass 1), which bf16 wgmma takes through its transpose
// bits from the same tiles; and a tf32 hi + lo split keeps 22 bits, which
// in B7-bwd's emulation strayed from the f64 result at the extreme gates
// at D 192 further than the CPU test allows
// (tests/test_torch_mlstm_bwd_split.py). Six bf16 products issue as long
// as three tf32 ones. Every tile is kept as 64-column chunks of 128-byte
// rows with the 128-byte swizzle (`smem_desc` of flash_hopper.cuh, whose
// wgmma shapes these kernels share).
//
//   1. chunk states: one warpgroup a block, a block per (64 rows of dC,
//      chunk, b * head): v's pieces (64 s x DP, MN-major B) and those of
//      a_s k_s over the block's 64 columns of d (64 s x 64, MN-major A: the
//      transpose by the descriptor, not by a copy; all loads issued at
//      once, the gate scan between them and their use), then dC rows = (a
//      k)^T v, M 64, N DP, K = 64 in k16 steps (rows past L are zero); dn
//      from each thread's column sums of a k on the FMA units while the
//      products run. Shared memory at D 192: 24,576 + 73,728 bytes and 2.8
//      KB of vectors, two blocks an SM.
//   2. the inter-chunk scan: unchanged, on the FMA units.
//   3. chunk outputs: one block per (chunk, b * head) of two warpgroups.
//      Warpgroup 0 stages q's pieces (64 x DP, K-major; a warp a row, eight
//      rows' loads in flight) with n . q_r on the FMA units, warpgroup 1
//      k's; warp 0 scans the gates. Warpgroup 1 then streams C_in's DP / 16
//      slices (rows past D zero) and v's four (rows past L zero) of 16 rows
//      x DP into a four-stage ring on mbarriers (MN-major B), one slice
//      ahead in its registers, each cut into pieces on its way. Warpgroup
//      0 forms S = q k^T (m64n64, K = DP), P = mask exp(w_s - M_r) S and
//      its row sums in f32, and cuts P into pieces in registers: the A
//      operands of P v (the register form; the accumulator layout is the A
//      layout). It adds q C_in over the C slices (m64nDP), scales its rows
//      by exp(m - M_r) and adds P v over the v slices into the same
//      accumulator, one slice's products in flight while the next slice's
//      issue; within a 64-row tile no k16 step lies wholly above the
//      causal diagonal (P is exactly zero there). Its waits on the ring
//      keep their loop inside one asm block: a branch between wgmma groups
//      in flight makes the compiler serialize them. dot_r, the
//      denominator's reciprocal and h stay f32 on the FMA units. Shared
//      memory at D 192: q and k 2 x 73,728, the ring 4 x 18,432, 2.7 KB of
//      vectors and barriers: 224,848 bytes, one block an SM; at D 256 the
//      ring takes k's place once S is formed.
//
// What the card showed (H100, xlstm-125m's prefill shape; PERF.md §6):
// the products are a tenth of pass 3's time; staging and streaming the
// operands (f32 loads, the cut into pieces, the stores to shared memory)
// and h's stores take the rest. Tried and slower: a persistent pass 3
// (one block an SM walking the chunks, every operand streamed in 16-row
// jobs by two producer warpgroups, through TMA landing slots or registers,
// k in the ring as m64n16 tiles): each job's fixed cost of issue and
// handoff outweighed the overlap it bought.
//
// For training, `mlstm_chunk_outputs_launch` given a `dot` also writes
// each row's dot_r (B, H, T), from which B7-bwd (mlstm_chunk_bwd.cu)
// recomputes the denominator and the branch that won it; with a null
// `dot` it is the serving paths' launch (a template flag, no runtime
// branch). The gate scan is shared with B7-bwd through mlstm_tiles.cuh.
// Without 16-byte rows (D % 4 != 0, or pointers or strides off 16 bytes)
// the staging reads one float at a time.
//
// What bounds it on an H100: bytes. Per chunk and (b, head) the products
// are pass 1's 2 L D^2 and pass 3's 2 L^2 D + 2 L D^2 + L (L + 1) D; at the
// TF32 peak (494.7 TFLOP/s) they take less time than the bytes do at 3.35
// TB/s (q, k, v, gates, h and the scratch: 4 x (D + 1) x DP x 4 bytes a
// chunk), so every pass is bound by bytes (`kernels/work.py`). The six
// piece products issue as fast as three tf32 ones, at most half the
// tensor cores' bf16 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "../../kernels/local_attention/csrc/flash_hopper.cuh"
#include "mlstm_tiles.cuh"

namespace {

using namespace mt;

constexpr int NP = 3;            // bf16 pieces of an f32 operand
constexpr int KS = 16;           // rows of K a wgmma step (and a ring slice)
constexpr int SMEM_MAX = 232448;  // shared memory a block may have
constexpr int WG = 128;          // threads of a warpgroup

// Byte offset of element (row, col) in a bf16 tile of `rows` rows kept as
// 64-column chunks of 128-byte rows, one chunk after the other, with the
// 128-byte swizzle: the 16-byte unit u of row r sits at unit u ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int rows, int row, int col) {
  return (col >> 6) * rows * ROW_BYTES + row * ROW_BYTES +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// The pieces of four consecutive values (column % 4 == 0, byte offset `o`
// in a plane, from `swz`) into the three planes of a tile, `plane` bytes
// apart.
__device__ __forceinline__ void put4(uint8_t* tile, int plane, uint32_t o,
                                     float4 x) {
  uint32_t a[NP], b[NP];
  split3(x.x, x.y, a[0], a[1], a[2]);
  split3(x.z, x.w, b[0], b[1], b[2]);
#pragma unroll
  for (int p = 0; p < NP; ++p)
    *reinterpret_cast<uint2*>(tile + p * plane + o) = make_uint2(a[p], b[p]);
}

// Values col..col+3 of a row, zero from column n on; `vec`: rows and
// columns lie on 16 bytes.
__device__ __forceinline__ float4 ld4(const float* row, int col, int n,
                                      bool vec) {
  if (col >= n) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) return *reinterpret_cast<const float4*>(row + col);
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = col + j < n ? row[col + j] : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// wgmma descriptors of a tile of `rows` rows (128-byte swizzle): K-major
// (rows of M or N, K along the chunks), k-step kk; MN-major (rows of K, M or
// N along the chunks), the 16 rows from row k0.
__device__ __forceinline__ uint64_t desc_k(uint32_t plane, int rows, int kk) {
  return smem_desc(plane + (kk >> 2) * rows * ROW_BYTES + (kk & 3) * 32, 16,
                   1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t plane, int rows,
                                            int k0) {
  return smem_desc(plane + k0 * ROW_BYTES, rows * ROW_BYTES, 1024);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Wait for the phase of parity `parity` of the barrier, the loop inside
// one asm block, so that the compiler sees no branch between the wgmma
// groups in flight around it (a branch there makes it serialize them).
// Like `mbar_wait`, a wait of 2^34 cycles traps.
__device__ __forceinline__ void mbar_wait_flat(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 P1, t1, 17179869184;\n"
      "@P1 trap;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// Wait until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}



// ---- pass 1: chunk states --------------------------------------------

template <int NJ>
struct States {
  static constexpr int DP = 64 * NJ;
  static constexpr int A_PLANE = LMAX * ROW_BYTES;  // (a k)^T: 64 s x 64 d
  static constexpr int V_PLANE = LMAX * DP * 2;     // v: 64 s x DP
  static constexpr int SMEM = 1024 + NP * (A_PLANE + V_PLANE)
                              + (3 * LMAX + 8 * 64) * 4;
  static_assert(SMEM <= SMEM_MAX, "a block's shared memory");
};

// One block (a warpgroup) per (64 rows of dC, chunk, b * head).
template <int NJ>
__global__ void __launch_bounds__(WG)
mlstm_chunk_states_kernel(const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ ig,
                          const float* __restrict__ fg,
                          float* __restrict__ work, float* __restrict__ scal,
                          int H, int T, int D, int L, Strides st, int vec) {
  using C = States<NJ>;
  constexpr int DP = C::DP;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_ak = (raw + 1023u) & ~1023u;  // [piece][s][64 d]
  const uint32_t s_v = s_ak + NP * C::A_PLANE;   // [piece][s][DP]
  uint8_t* const ak = smem_raw + (s_ak - raw);
  uint8_t* const vp = smem_raw + (s_v - raw);
  float* const av = reinterpret_cast<float*>(vp + NP * C::V_PLANE);  // [LMAX]
  float* const iv = av + LMAX;
  float* const fv = iv + LMAX;
  float* const red = fv + LMAX;                  // [8][64]: dn's partials
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = blockIdx.x % NJ, c = blockIdx.x / NJ, bh = blockIdx.y;
  const int nc = gridDim.x / NJ, d0 = 64 * mt;
  const int h = bh % H, b = bh / H, t0 = c * L;
  const int64_t off = b * st.qs_b + h * st.qs_h + t0 * st.qs_t;

  // The gates; then v's pieces (MN-major B: rows s, columns d) and the
  // pieces of a_s k_s over this block's 64 columns of d (MN-major A: rows
  // s, columns d), rows past L and columns past D zero: every load issued
  // at once, the first sixteen of v stored while warp 0 waits for the
  // gates, the rest of v and k after its scan; each thread's column sums
  // of its 8 rows of a k for dn.
  for (int s = tid; s < L; s += WG) {
    const int64_t g = b * st.gs_b + h * st.gs_h + (t0 + s) * st.gs_t;
    iv[s] = ig[g];
    fv[s] = fg[g];
  }
  constexpr int V4 = LMAX * DP / 4 / WG;   // v's float4 a thread: 8 NJ
  constexpr int R1 = V4 < 16 ? V4 : 16;    // v's in the first round
  auto v_at = [&](int i, float4& x, int& s, int& col) {
    const int idx = tid + WG * i;
    s = idx / (DP / 4);
    col = 4 * (idx % (DP / 4));
    x = s < L ? ld4(v + off + (int64_t)s * st.qs_t, col, D, vec)
              : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float4 x1[R1], x[V4 - R1 + 8];
  int s1[R1], col1[R1], s2[V4 - R1 + 8], col2[V4 - R1 + 8];
#pragma unroll
  for (int i = 0; i < R1; ++i) v_at(i, x1[i], s1[i], col1[i]);
#pragma unroll
  for (int i = 0; i < V4 - R1; ++i) v_at(R1 + i, x[i], s2[i], col2[i]);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = tid / 16 + 8 * i;
    x[V4 - R1 + i] = s < L ? ld4(k + off + (int64_t)s * st.qs_t + d0,
                                 4 * (tid % 16), D - d0, vec)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < R1; ++i) put4(vp, C::V_PLANE, swz(LMAX, s1[i], col1[i]),
                                    x1[i]);
  __syncthreads();
  if (warp == 0) {
    const GateScan r = gate_scan(iv, fv, L, lane);
    float G = fmaxf(r.w0, r.w1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) G = fmaxf(G, __shfl_xor_sync(FULL, G, o));
    if (2 * lane < L) av[2 * lane] = expf(r.w0 - G);
    if (2 * lane + 1 < L) av[2 * lane + 1] = expf(r.w1 - G);
    const float b_last = __shfl_sync(FULL, (L - 1) % 2 ? r.b1 : r.b0,
                                     (L - 1) / 2);
    if (mt == 0 && lane == 0) {
      float* sc = scal + ((int64_t)bh * nc + c) * 4;
      sc[0] = b_last;
      sc[1] = G;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < V4 - R1; ++i) put4(vp, C::V_PLANE,
                                         swz(LMAX, s2[i], col2[i]), x[i]);
  float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = tid / 16 + 8 * i;
    const float a = s < L ? av[s] : 0.f;
    const float4 xi = x[V4 - R1 + i];
    const float4 y = make_float4(a * xi.x, a * xi.y, a * xi.z, a * xi.w);
    cs.x += y.x;
    cs.y += y.y;
    cs.z += y.z;
    cs.w += y.w;
    put4(ak, C::A_PLANE, swz(LMAX, s, 4 * (tid % 16)), y);
  }
  *reinterpret_cast<float4*>(red + (tid / 16) * 64 + 4 * (tid % 16)) = cs;
  fence_async_smem();
  __syncthreads();

  // dC rows [d0, d0 + 64) = (a k)^T v: M 64, N DP, K = L in k16 steps.
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < LMAX / KS; ++kk)   // rows past L are zero
#pragma unroll
      for (int t = 0; t < 6; ++t)
        wgmma_sst<DP, 1, 1>(
            acc, desc_mn(s_ak + piece_a(t) * C::A_PLANE, LMAX, kk * KS),
            desc_mn(s_v + piece_b(t) * C::V_PLANE, LMAX, kk * KS));
  wgmma_commit();
  // dn = sum_s a_s k_s (row D), the partials in order, while the products run.
  float* const slot = work + ((int64_t)bh * nc + c) * (D + 1) * DP;
  if (tid < 64) {
    float dn = 0.f;
#pragma unroll
    for (int g = 0; g < 8; ++g) dn += red[g * 64 + tid];
    slot[(int64_t)D * DP + d0 + tid] = dn;
  }
  wgmma_wait_all();
  fence_regs(acc);
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int d = d0 + r0 + 8 * hh;
    if (d < D)
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
        *reinterpret_cast<float2*>(slot + (int64_t)d * DP + 8 * j + c0) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

// ---- pass 2: the inter-chunk scan -------------------------------------

__global__ void __launch_bounds__(THREADS)
mlstm_state_scan_kernel(float* __restrict__ work, float* __restrict__ scal,
                        const float* __restrict__ C0,
                        const float* __restrict__ n0,
                        const float* __restrict__ m0, float* __restrict__ C1,
                        float* __restrict__ n1, float* __restrict__ m1,
                        int nc, int D, int DP) {
  const int bh = blockIdx.y;
  const int x = blockIdx.x * THREADS + threadIdx.x;   // float4 of a slot
  const int row = 4 * x / DP, col = 4 * x % DP;
  const bool live = row <= D;
  const int64_t slot = (int64_t)(D + 1) * DP;
  float4* base = reinterpret_cast<float4*>(work + (int64_t)bh * nc * slot) + x;
  // (b_last, G) of each chunk; the incoming m goes to the other half.
  const float2* sc =
      reinterpret_cast<const float2*>(scal) + 2 * (int64_t)bh * nc;

  float cv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cc = col + j;
    cv[j] = !live || cc >= D ? 0.0f
            : row < D ? C0[((int64_t)bh * D + row) * D + cc]
                      : n0[(int64_t)bh * D + cc];
  }
  float m = m0[bh];
  const bool writes_m = x == 0;
  constexpr int U = 4;   // chunks whose loads are issued together
  for (int c0 = 0; c0 < nc; c0 += U) {
    float4 dv[U];
    float2 s2[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u < nc) {
        s2[u] = sc[2 * (c0 + u)];
        if (live) dv[u] = base[(int64_t)(c0 + u) * (slot / 4)];
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u >= nc) break;
      const float G = s2[u].y;
      const float M = fmaxf(m, G);
      const float alpha = expf(m - M), beta = expf(G - M);
      if (live) {
        base[(int64_t)(c0 + u) * (slot / 4)] =
            make_float4(cv[0], cv[1], cv[2], cv[3]);
        cv[0] = alpha * cv[0] + beta * dv[u].x;
        cv[1] = alpha * cv[1] + beta * dv[u].y;
        cv[2] = alpha * cv[2] + beta * dv[u].z;
        cv[3] = alpha * cv[3] + beta * dv[u].w;
      }
      if (writes_m) scal[((int64_t)bh * nc + c0 + u) * 4 + 2] = m;
      m = s2[u].x + M;
    }
  }
  if (live)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = col + j;
      if (cc >= D) break;
      if (row < D)
        C1[((int64_t)bh * D + row) * D + cc] = cv[j];
      else
        n1[(int64_t)bh * D + cc] = cv[j];
    }
  if (writes_m) m1[bh] = m;
}

// ---- pass 3: chunk outputs --------------------------------------------

template <int NJ>
struct Outputs {
  static constexpr int DP = 64 * NJ;
  static constexpr int NC = DP / KS;        // slices of C_in (rows past D 0)
  static constexpr int NV = LMAX / KS;      // slices of v (rows past L 0)
  static constexpr int OP = LMAX * DP * 2;  // a piece of q or k: 64 x DP
  static constexpr int SL = KS * DP * 2;    // a piece of a slice: 16 x DP
  static constexpr int STAGES = 4;
  static constexpr int VEC = (DP + 7 * LMAX) * 4;  // n, gates, row vectors
  static constexpr int BARS = 8 * (2 * STAGES + 2);
  static constexpr int APART = 1024 + 2 * NP * OP + STAGES * NP * SL + VEC
                               + BARS;
  // The ring has room of its own up to D 192; at D 256 it takes k's place
  // once S is formed.
  static constexpr bool RING_APART = APART <= SMEM_MAX;
  static constexpr int SMEM = RING_APART ? APART : APART - STAGES * NP * SL;
  static_assert(SMEM <= SMEM_MAX, "a block's shared memory");
  static_assert(RING_APART || STAGES * SL <= OP, "the ring in k's place");
};

// One block per (chunk, b * head) of two warpgroups: all eight warps stage
// q and k; then warpgroup 1 streams the slices of C_in and v into the ring
// and warpgroup 0 issues the products and writes h.
template <int NJ, bool DOT>
__global__ void __launch_bounds__(2 * WG, 1)
mlstm_chunk_outputs_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ ig,
                           const float* __restrict__ fg,
                           const float* __restrict__ work,
                           const float* __restrict__ scal,
                           float* __restrict__ hout,
                           float* __restrict__ dot_out, int H, int T, int D,
                           int L, Strides st, int vec) {
  using C = Outputs<NJ>;
  constexpr int DP = C::DP, NC = C::NC, NV = C::NV, S = C::STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023u) & ~1023u;   // [piece][r][DP], K-major
  const uint32_t s_k = s_q + NP * C::OP;         // [piece][s][DP], K-major
  const uint32_t s_ring = C::RING_APART ? s_k + NP * C::OP : s_k;
  const uint32_t s_vec = s_k + NP * C::OP
                         + (C::RING_APART ? S * NP * C::SL : 0);
  uint8_t* const gq = smem_raw + (s_q - raw);
  uint8_t* const gk = smem_raw + (s_k - raw);
  uint8_t* const gring = smem_raw + (s_ring - raw);  // [stage][piece][16][DP]
  float* const nv = reinterpret_cast<float*>(smem_raw + (s_vec - raw));
  float* const iv = nv + DP;            // [LMAX] each below
  float* const fv = iv + LMAX;
  float* const bvec = fv + LMAX;
  float* const wvec = bvec + LMAX;
  float* const Mvec = wvec + LMAX;
  float* const scale = Mvec + LMAX;
  float* const qn = scale + LMAX;
  const uint32_t bars = s_vec + C::VEC;
  auto full = [&](int i) { return bars + 8u * i; };
  auto empty = [&](int i) { return bars + 8u * (S + i); };
  const uint32_t kfree = bars + 8u * 2 * S, kready = kfree + 8u;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, bh = blockIdx.y, nc = gridDim.x;
  const int h = bh % H, b = bh / H, t0 = c * L;
  const int64_t off = b * st.qs_b + h * st.qs_h + t0 * st.qs_t;
  const float* const slot = work + ((int64_t)bh * nc + c) * (D + 1) * DP;
  const float m_in = scal[((int64_t)bh * nc + c) * 4 + 2];

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full(i), WG);
      mbar_init(empty(i), WG);
    }
    mbar_init(kfree, WG);
    mbar_init(kready, WG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int d = tid; d < DP; d += 2 * WG) nv[d] = slot[(int64_t)D * DP + d];
  for (int s = tid; s < L; s += 2 * WG) {
    const int64_t g = b * st.gs_b + h * st.gs_h + (t0 + s) * st.gs_t;
    iv[s] = ig[g];
    fv[s] = fg[g];
  }
  __syncthreads();
  if (warp == 0) {
    const GateScan r = gate_scan(iv, fv, L, lane);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = 2 * lane + u;
      if (s < L) {
        const float M = fmaxf(m_in, u ? r.g1 : r.g0);
        bvec[s] = u ? r.b1 : r.b0;
        wvec[s] = u ? r.w1 : r.w0;
        Mvec[s] = M;
        scale[s] = expf(m_in - M);
      }
    }
  }
  // Warpgroup 0 stages q, warpgroup 1 k, into their pieces: a warp a row,
  // rows past L and columns past D zero, eight rows' loads in flight;
  // with q, n . q_r on the FMA units (each lane's columns in order, then
  // the lanes by shuffles).
  {
    constexpr int R4 = (DP / 4 + 31) / 32;
    const bool is_q = warp < 4;
    const float* const src = is_q ? q : k;
    uint8_t* const tile = is_q ? gq : gk;
#pragma unroll 1
    for (int i0 = 0; i0 < LMAX / 4; i0 += 8) {
      float4 x[8][R4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (warp & 3) + 4 * (i0 + i);
#pragma unroll
        for (int u = 0; u < R4; ++u) {
          const int col = 4 * (lane + 32 * u);
          x[i][u] = r < L && col < DP
                        ? ld4(src + off + (int64_t)r * st.qs_t, col, D, vec)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (warp & 3) + 4 * (i0 + i);
        float acc = 0.f;
#pragma unroll
        for (int u = 0; u < R4; ++u) {
          const int col = 4 * (lane + 32 * u);
          if (col < DP) {
            put4(tile, C::OP, swz(LMAX, r, col), x[i][u]);
            if (is_q) {
              const float4 n4 = *reinterpret_cast<const float4*>(nv + col);
              acc = fmaf(n4.x, x[i][u].x, acc);
              acc = fmaf(n4.y, x[i][u].y, acc);
              acc = fmaf(n4.z, x[i][u].z, acc);
              acc = fmaf(n4.w, x[i][u].w, acc);
            }
          }
        }
        if (is_q) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            acc += __shfl_xor_sync(FULL, acc, o);
          if (lane == 0) qn[r] = acc;
        }
      }
    }
    fence_async_smem();
  }

  if (warp >= 4) {
    // ---- producer: the NC slices of C_in, then the NV of v, each 16 rows
    // x DP, loaded one slice ahead into registers and cut into pieces into
    // the ring (MN-major B: rows of K, columns of N).
    const int ptid = tid - WG;
    constexpr int F = KS * DP / 4 / WG;   // float4 a thread a slice
    int row[F], col[F];
    uint32_t o[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int idx = ptid + WG * f;
      row[f] = idx / (DP / 4);
      col[f] = 4 * (idx % (DP / 4));
      o[f] = swz(KS, row[f], col[f]);
    }
    auto load = [&](int i, float4 (&x)[F]) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        x[f] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < NC) {
          const int d = i * KS + row[f];
          if (d < D)
            x[f] = *reinterpret_cast<const float4*>(slot + (int64_t)d * DP
                                                    + col[f]);
        } else {
          const int s = (i - NC) * KS + row[f];
          if (s < L)
            x[f] = ld4(v + off + (int64_t)s * st.qs_t, col[f], D, vec);
        }
      }
    };
    float4 cur[F], nxt[F];
    load(0, cur);
    mbar_arrive(kready);   // k's pieces are in place
    if (!C::RING_APART) mbar_wait(kfree, 0);
#pragma unroll 1
    for (int i = 0; i < NC + NV; ++i) {
      if (i + 1 < NC + NV) load(i + 1, nxt);
      const int sg = i % S, use = i / S;
      if (use > 0) mbar_wait(empty(sg), (use - 1) & 1);
      uint8_t* const dst = gring + sg * NP * C::SL;
#pragma unroll
      for (int f = 0; f < F; ++f) put4(dst, C::SL, o[f], cur[f]);
      fence_async_smem();
      mbar_arrive(full(sg));
#pragma unroll
      for (int f = 0; f < F; ++f) cur[f] = nxt[f];
    }
    return;
  }

  // ---- consumer: this thread's rows r0 and r0 + 8 of the chunk, columns
  // 8 j + c0 and + 1 of each accumulator. Its warps' q and row vectors,
  // then the producers' k.
  named_bar(1, WG);
  mbar_wait_flat(kready, 0);
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  // Ring slice i: wait for it; once the next slice's products are issued,
  // free it when its own are done.
  auto ring_in = [&](int i) { mbar_wait_flat(full(i % S), (i / S) & 1); };
  auto ring_prev = [&](int i) {
    wgmma_wait<1>();
    mbar_arrive(empty((i - 1) % S));
  };

  // S = q k^T: 64 x 64 over K = DP (columns past D are zero).
  float sacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
  fence_regs(sacc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / KS; ++kk)
#pragma unroll
    for (int t = 0; t < 6; ++t)
      wgmma_sst<64, 0, 0>(sacc, desc_k(s_q + piece_a(t) * C::OP, LMAX, kk),
                          desc_k(s_k + piece_b(t) * C::OP, LMAX, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sacc);
  if (!C::RING_APART) mbar_arrive(kfree);

  // P = mask exp(w_s - M_r) S, its row sums, and its pieces as the A
  // operands of P v: k-step kq takes columns [16 kq, 16 kq + 16).
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = 8 * jj + c0 + (e & 1), r = r0 + 8 * (e >> 1);
      float p = 0.f;
      if (r < L && s <= r) p = expf(wvec[s] - Mvec[r]) * sacc[4 * jj + e];
      sacc[4 * jj + e] = p;
      rs[e >> 1] += p;
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rs[hh] += __shfl_xor_sync(FULL, rs[hh], 1);
    rs[hh] += __shfl_xor_sync(FULL, rs[hh], 2);
  }
  uint32_t pa[NV][NP][4];
#pragma unroll
  for (int kq = 0; kq < NV; ++kq)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split3(sacc[8 * kq + 2 * r], sacc[8 * kq + 2 * r + 1], pa[kq][0][r],
             pa[kq][1][r], pa[kq][2][r]);

  // q C_in over C_in's slices; one slice's products stay in flight while
  // the next slice's issue.
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int sl = 0; sl < NC; ++sl) {
    const int sg = sl % S;
    ring_in(sl);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 6; ++t)
      wgmma_sst<DP, 0, 1>(
          acc, desc_k(s_q + piece_a(t) * C::OP, LMAX, sl),
          desc_mn(s_ring + (sg * NP + piece_b(t)) * C::SL, KS, 0));
    wgmma_commit();
    if (sl > 0) ring_prev(sl);
  }
  wgmma_wait<0>();
  mbar_arrive(empty((NC - 1) % S));
  fence_regs(acc);
  // h~ = scale_r (q C_in) + P v over v's slices (rows past L are zero).
#pragma unroll
  for (int jj = 0; jj < DP / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[4 * jj + e] *= scale[r0 + 8 * (e >> 1)];
  fence_regs(pa);
#pragma unroll
  for (int kq = 0; kq < NV; ++kq) {
    const int i = NC + kq, sg = i % S;
    ring_in(i);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 6; ++t)
      wgmma_rs<DP>(acc, pa[kq][piece_a(t)],
                   desc_mn(s_ring + (sg * NP + piece_b(t)) * C::SL, KS, 0));
    wgmma_commit();
    if (kq > 0) ring_prev(i);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(pa);

  const int64_t HD = (int64_t)H * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= L) continue;
    const float dot = scale[r] * qn[r] + rs[hh];
    const float rden =
        1.f / fmaxf(fabsf(dot), expf(-(bvec[r] + Mvec[r])));
    if (DOT && (lane & 3) == 0) dot_out[(int64_t)bh * T + t0 + r] = dot;
    float* const out = hout + ((int64_t)b * T + t0 + r) * HD
                       + (int64_t)h * D;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      const int col = 8 * jj + c0;
      const float x0 = acc[4 * jj + 2 * hh] * rden;
      const float x1 = acc[4 * jj + 2 * hh + 1] * rden;
      if (col + 1 < D && !(D & 1)) {
        *reinterpret_cast<float2*>(out + col) = make_float2(x0, x1);
      } else {
        if (col < D) out[col] = x0;
        if (col + 1 < D) out[col + 1] = x1;
      }
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Whether rows of q, k, v may be read as float4: 16-byte pointers and
// strides, D a multiple of 4.
bool rows16(std::initializer_list<const void*> ptrs, int D, const Strides& st) {
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16) return false;
  return D % 4 == 0 && st.qs_b % 4 == 0 && st.qs_h % 4 == 0 &&
         st.qs_t % 4 == 0;
}

}  // namespace

// Pass 1. k, v: f32 with element (b, h, t, d) at b*qs_b + h*qs_h + t*qs_t
// + d; it, ft: f32 at b*gs_b + h*gs_h + t*gs_t. work (B, H, T/L, D+1, DP)
// f32 and scal (B, H, T/L, 4) f32 out (DP = D rounded up to 64). T % L ==
// 0, L <= 64, D <= 256.
extern "C" int mlstm_chunk_states_launch(
    const void* k, const void* v, const void* it, const void* ft,
    void* work, void* scal, int B, int H, int T, int D, int L, int qs_b,
    int qs_h, int qs_t, int gs_b, int gs_h, int gs_t, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (!shape_ok(B, H, T, D, L)) return (int)cudaErrorInvalidValue;
  const int NJ = (D + 63) / 64;
  const Strides st{qs_b, qs_h, qs_t, gs_b, gs_h, gs_t};
  const dim3 grid(NJ * (T / L), B * H);
  const int vec = rows16({k, v}, D, st);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  auto run = [&](auto kernel, size_t bytes) {
    err = set_smem(kernel, bytes);
    if (err == cudaSuccess)
      kernel<<<grid, WG, bytes, s>>>(
          (const float*)k, (const float*)v, (const float*)it,
          (const float*)ft, (float*)work, (float*)scal, H, T, D, L, st, vec);
  };
  switch (NJ) {
    case 1: run(mlstm_chunk_states_kernel<1>, States<1>::SMEM); break;
    case 2: run(mlstm_chunk_states_kernel<2>, States<2>::SMEM); break;
    case 3: run(mlstm_chunk_states_kernel<3>, States<3>::SMEM); break;
    default: run(mlstm_chunk_states_kernel<4>, States<4>::SMEM); break;
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Pass 2. work / scal as pass 1 left them, rewritten in place to each
// chunk's incoming (C, n) and m (scal[..., 2]); state C0 (B,H,D,D), n0
// (B,H,D), m0 (B,H) in, C1 / n1 / m1 out.
extern "C" int mlstm_state_scan_launch(void* work, void* scal, const void* C0,
                                       const void* n0, const void* m0,
                                       void* C1, void* n1, void* m1, int B,
                                       int H, int nc, int D, void* stream) {
  if (B <= 0 || nc <= 0) return 0;
  if (D <= 0 || D > 256 || H <= 0 || (int64_t)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const int DP = (D + 63) / 64 * 64;
  const int n4 = (D + 1) * DP / 4;
  const dim3 grid((n4 + THREADS - 1) / THREADS, B * H);
  mlstm_state_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (float*)work, (float*)scal, (const float*)C0, (const float*)n0,
      (const float*)m0, (float*)C1, (float*)n1, (float*)m1, nc, D, DP);
  return (int)cudaGetLastError();
}

namespace {

cudaError_t outputs(const void* q, const void* k, const void* v,
                    const void* it, const void* ft, const void* work,
                    const void* scal, void* h, void* dot, int B, int H,
                    int T, int D, int L, int qs_b, int qs_h, int qs_t,
                    int gs_b, int gs_h, int gs_t, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (!shape_ok(B, H, T, D, L)) return cudaErrorInvalidValue;
  const int NJ = (D + 63) / 64;
  const Strides st{qs_b, qs_h, qs_t, gs_b, gs_h, gs_t};
  const dim3 grid(T / L, B * H);
  const int vec = rows16({q, k, v}, D, st);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  auto run = [&](auto kernel, size_t bytes) {
    err = set_smem(kernel, bytes);
    if (err == cudaSuccess)
      kernel<<<grid, 2 * WG, bytes, s>>>(
          (const float*)q, (const float*)k, (const float*)v,
          (const float*)it, (const float*)ft, (const float*)work,
          (const float*)scal, (float*)h, (float*)dot, H, T, D, L, st, vec);
  };
  // dot is a template parameter, so that the serving launch compiles to
  // the kernel it was before dot existed.
  auto pick = [&](auto with_dot) {
    constexpr bool D_ = decltype(with_dot)::value;
    switch (NJ) {
      case 1:
        run(mlstm_chunk_outputs_kernel<1, D_>, Outputs<1>::SMEM);
        break;
      case 2:
        run(mlstm_chunk_outputs_kernel<2, D_>, Outputs<2>::SMEM);
        break;
      case 3:
        run(mlstm_chunk_outputs_kernel<3, D_>, Outputs<3>::SMEM);
        break;
      default:
        run(mlstm_chunk_outputs_kernel<4, D_>, Outputs<4>::SMEM);
        break;
    }
  };
  if (dot)
    pick(std::true_type{});
  else
    pick(std::false_type{});
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace



// Pass 3. q, k, v, it, ft as pass 1 (q with k's strides); work / scal as
// pass 2 left them; h (B, T, H*D) f32 out; dot: null, or each row's
// normaliser dot_r = n_r . q_r (B, H, T) f32 out, which B7-bwd reads.
extern "C" int mlstm_chunk_outputs_launch(
    const void* q, const void* k, const void* v, const void* it,
    const void* ft, const void* work, const void* scal, void* h, void* dot,
    int B, int H, int T, int D, int L, int qs_b, int qs_h, int qs_t,
    int gs_b, int gs_h, int gs_t, void* stream) {
  return (int)outputs(q, k, v, it, ft, work, scal, h, dot, B, H, T, D, L,
                      qs_b, qs_h, qs_t, gs_b, gs_h, gs_t, stream);
}
