// Banded (causal sliding-window) flash attention with GQA on Hopper's tensor
// cores, for sm_90a: bf16 q, k, v at D in {64, 128, 256}.
//
// Replaces, for these inputs, the TPU kernel `_flash_kernel` (wrapper
// `flash_attention_pallas`) of src/repro/kernels/local_attention/
// local_attention.py. The FMA kernel of csrc/local_attention.cu keeps the
// f32 inputs and the other head sizes. Same function: the mask is
// (k_pos <= q_pos) & (k_pos > q_pos - W), masked probabilities are 0, a row
// whose normaliser stayed 0 divides by 1, q head h reads kv head
// h / (Hq / Hkv), W = T is full causal.
//
// What bounds it on an H100: 4*D FLOP per live (query, key) pair, far above
// the bytes of q, k, v and o, so the tensor cores (989 TFLOP/s bf16). The
// design:
//
//   * one block per (batch * q head, 128-row query tile), query tiles
//     issued last-first across all heads (blockIdx.y is the tile counted
//     from the end, blockIdx.x the head), so the long rows of a causal pass
//     start first. The block visits exactly the key tiles that meet
//     [q_lo - W + 1, q_hi], from the diagonal down.
//   * three warpgroups. The producer (warpgroup 0, 24 registers after
//     setmaxnreg) has one thread issue TMA loads: q once, then K and V
//     tiles into a 2-stage ring, each on its own mbarrier (V may land
//     while the scores are computed); the consumers free a stage through
//     an "empty" mbarrier. Two consumer warpgroups (240 registers) own 64
//     query rows each.
//   * shared memory holds bf16 tiles in 64-column (128-byte) chunks with
//     the 128-byte swizzle that TMA writes and wgmma reads: Q 128 x D, and
//     per stage K and V BK x D (BK = 128, or 64 at D = 256): 160 KB at
//     D = 128. A 3-D tensor map (D, T, B*H) per input makes TMA zero-fill
//     rows past T within a head instead of reading the next head's rows;
//     o is written with plain stores of rows < T only.
//   * S = Q K^T: wgmma m64nBKk16, both operands K-major from shared memory,
//     f32 accumulation. 1/sqrt(D) and log2(e) are applied in f32 to the
//     accumulator inside the exponent (exp2); the plain version scales q
//     after the upcast: a few f32 ulps apart.
//   * online softmax in registers on the accumulator fragment: a row lives
//     in the 4 threads of a quad, joined by two xor shuffles. Only tiles
//     that cross the diagonal or the window's lower edge are masked
//     (masked scores -inf, a fully masked row so far keeps its running
//     max at -inf and is shifted by 0 so that every p is 0).
//   * P V, exact split: each f32 p becomes p_hi = bf16(p) and p_lo =
//     bf16(p - p_hi) in registers (the accumulator layout is the A-operand
//     layout of the next product), and O += p_hi V + p_lo V by two wgmma
//     m64nDk16 with A from registers and V MN-major (transposed B) from
//     shared memory. p_hi + p_lo is p within 2^-18 p, and bf16 x bf16
//     products are exact in f32, so the result stays within one bf16 ulp
//     of the f32 plain version. One bf16 P would err by up to 2^-9 of
//     sum(p|v|)/l: many ulps at the output's magnitude. The split costs
//     6*D FLOP per live pair instead of 4*D; the bound counts 4*D.
//   * the normaliser l is summed from the f32 p; O / l in f32, rounded to
//     bf16 and written once.
//   * optionally (a second instantiation, launched when the caller passes a
//     non-null `lse`, i.e. under autograd) the per-row log-sum-exp of the
//     scaled scores in natural-log units, lse = (m + log2 l) ln 2 with m
//     the running max in log2 units, so that P = exp(s * scale - lse) for
//     the backward (csrc/flash_tc_bwd.cu); a row with l = 0 (only at
//     W = 0) gets +inf, for which every P of the backward is exactly 0.
//     Without it the kernel is the prefill's, unchanged.
//
// Later work (ROADMAP): overlap of one warpgroup's softmax with its own
// next QK^T (two score buffers), a persistent grid, and a single-bf16-P
// variant under a looser tolerance.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int THREADS = 384;        // producer + two consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int CHUNK = 64;           // bf16 columns in one 128-byte chunk
constexpr int ROW_BYTES = 128;      // one chunk row in shared memory

template <int D>
struct TcTile {
  static constexpr int BQ = 128;                // query rows per block
  static constexpr int BK = D > 128 ? 64 : 128;  // keys per tile
  static constexpr int NCH = D / CHUNK;         // chunks per row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;   // one K or V stage
  static constexpr int STAGES = 2;
  // 1 KB to align the tiles to the swizzle's 1024-byte period, then Q,
  // K[STAGES], V[STAGES] and 7 mbarriers.
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. No
// wait of this kernel lasts more than a tile's work; one that lasts 2^34
// cycles (seconds) is a deadlock, and traps — a launch error — rather than
// hold the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One TMA box of a 3-D tensor map (column, row, batch*head) into shared
// memory, completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// byte offset (K-major: unused; MN-major: stride between 64-column
// chunks) and stride byte offset (between groups of 8 rows: 1024 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers that an asynchronous wgmma reads or writes, so that the
// compiler neither reads them early nor reuses them before the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The exact split of two f32 probabilities into bf16 (hi, lo) pairs.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// D(64 x 64) (+)= A(64 x 16) * B(64 x 16)^T, A and B K-major in
// shared memory (128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 128) (+)= A(64 x 16) * B(128 x 16)^T, A and B K-major in
// shared memory (128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 64) += A(64 x 16) * B(16 x 64), A in registers (the
// accumulator layout of a 64-row tile, bf16 pairs), B MN-major in shared
// memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128) += A(64 x 16) * B(16 x 128), A in registers (the
// accumulator layout of a 64-row tile, bf16 pairs), B MN-major in shared
// memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 256) += A(64 x 16) * B(16 x 256), A in registers (the
// accumulator layout of a 64-row tile, bf16 pairs), B MN-major in shared
// memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int Hq, int Hkv, int Tlen, int W, float sl2) {
  using C = TcTile<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NCH = C::NCH;
  constexpr int Q_BYTES = C::Q_BYTES, KV_BYTES = C::KV_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023u) & ~1023u;
  const uint32_t s_k = s_q + Q_BYTES;                 // [STAGES][KV_BYTES]
  const uint32_t s_v = s_k + C::STAGES * KV_BYTES;
  const uint32_t bars = s_v + C::STAGES * KV_BYTES;
  const uint32_t bar_q = bars;
  auto bar_k = [&](int st) { return bars + 8u * (1 + st); };
  auto bar_v = [&](int st) { return bars + 8u * (3 + st); };
  auto bar_free = [&](int st) { return bars + 8u * (5 + st); };

  const int nq = (Tlen + BQ - 1) / BQ;
  const int q_lo = (nq - 1 - (int)blockIdx.y) * BQ;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int bkv = b * Hkv + h / (Hq / Hkv);
  const int q_hi = min(q_lo + BQ, Tlen) - 1;
  const int kt_lo = max(q_lo - W + 1, 0) / BK;
  const int kt_hi = q_hi / BK;
  const int n_tiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(bar_k(st), 1);
      mbar_init(bar_v(st), 1);
      mbar_init(bar_free(st), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        tma_load(s_q + c * BQ * ROW_BYTES, &tm_q, c * CHUNK, q_lo, bh, bar_q);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1, use = it >> 1;
        if (use > 0) mbar_wait(bar_free(st), (use - 1) & 1);
        const int k_lo = (kt_hi - it) * BK;
        mbar_expect_tx(bar_k(st), KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(s_k + st * KV_BYTES + c * BK * ROW_BYTES, &tm_k,
                   c * CHUNK, k_lo, bkv, bar_k(st));
        mbar_expect_tx(bar_v(st), KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load(s_v + st * KV_BYTES + c * BK * ROW_BYTES, &tm_v,
                   c * CHUNK, k_lo, bkv, bar_v(st));
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows [64 cw, 64 cw + 64) ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row_a = q_lo + cw * 64 + warp * 16 + lane / 4;  // and row_a + 8
    const int row_b = row_a + 8;
    const int col0 = 2 * (lane % 4);
    const uint32_t s_qw = s_q + cw * 64 * ROW_BYTES;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY;  // running max, scaled by sl2
    float l_a = 0.f, l_b = 0.f;              // this thread's share of l

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it & 1, ph = (it >> 1) & 1;
      const int k_lo = (kt_hi - it) * BK;
      const uint32_t s_kt = s_k + st * KV_BYTES, s_vt = s_v + st * KV_BYTES;

      // S = Q K^T (unscaled), 64 x BK per warpgroup.
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      mbar_wait(bar_k(st), ph);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes
        wgmma_ss<BK>(s,
                     smem_desc(s_qw + (kk / 4) * BQ * ROW_BYTES + off, 16,
                               1024),
                     smem_desc(s_kt + (kk / 4) * BK * ROW_BYTES + off, 16,
                               1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // Mask the tiles that cross the diagonal or the window's lower edge.
      if (k_lo + BK - 1 > q_lo || k_lo <= q_hi - W) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k_lo + 8 * j + col0 + e;
            if (!(kp <= row_a && kp > row_a - W)) s[4 * j + e] = -INFINITY;
            if (!(kp <= row_b && kp > row_b - W)) s[4 * j + 2 + e] = -INFINITY;
          }
      }

      // Online softmax on rows a and b.
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a) * sl2);
      const float mn_b = fmaxf(m_b, quad_max(mx_b) * sl2);
      // A row with no live key yet shifts by 0: every p and alpha is 0.
      const float sh_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float sh_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float alpha_a = ex2(m_a - sh_a), alpha_b = ex2(m_b - sh_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], sl2, -sh_a));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sl2, -sh_a));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sl2, -sh_b));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sl2, -sh_b));
        sum_a += s[4 * j] + s[4 * j + 1];
        sum_b += s[4 * j + 2] + s[4 * j + 3];
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha_a;
        acc[4 * j + 1] *= alpha_a;
        acc[4 * j + 2] *= alpha_b;
        acc[4 * j + 3] *= alpha_b;
      }

      // P as the A operand of the next product, split into bf16 hi + lo:
      // k-step kk takes score columns [16 kk, 16 kk + 16).
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], p_hi[kk][r],
                 p_lo[kk][r]);

      // O += P_hi V + P_lo V; V's k-step kk is 16 key rows of 128 bytes.
      mbar_wait(bar_v(st), ph);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv =
            smem_desc(s_vt + kk * 16 * ROW_BYTES, BK * ROW_BYTES, 1024);
        wgmma_rs<D>(acc, p_hi[kk], dv);
        wgmma_rs<D>(acc, p_lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      mbar_arrive(bar_free(st));
    }

    // O / l, rounded to bf16; rows past T are not written.
    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    const float den_a = l_a == 0.f ? 1.f : l_a;
    const float den_b = l_b == 0.f ? 1.f : l_b;
    __nv_bfloat16* out = o + (long long)bh * Tlen * D + col0;
    if (row_a < Tlen) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + (long long)row_a * D + 8 * j) =
            pack_bf16(acc[4 * j] / den_a, acc[4 * j + 1] / den_a);
    }
    if (row_b < Tlen) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + (long long)row_b * D + 8 * j) =
            pack_bf16(acc[4 * j + 2] / den_b, acc[4 * j + 3] / den_b);
    }
    if constexpr (LSE) {
      if (lane % 4 == 0) {
        constexpr float LN2 = 0.6931471805599453f;
        float* out_lse = lse + (long long)bh * Tlen;
        if (row_a < Tlen)
          out_lse[row_a] = l_a == 0.f ? INFINITY : (m_a + log2f(l_a)) * LN2;
        if (row_b < Tlen)
          out_lse[row_b] = l_b == 0.f ? INFINITY : (m_b + log2f(l_b)) * LN2;
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against the driver.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (D, T, B*H) bf16 tensor map read in boxes of 64 columns x `rows` rows
// of one head, 128-byte swizzle; rows past T read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int D, int T, int BH,
              int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)CHUNK, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool LSE>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Hq, int Hkv, int T, int W,
                   cudaStream_t stream) {
  using C = TcTile<D>;
  const int nq = (T + C::BQ - 1) / C::BQ;
  if (nq > 65535) return cudaErrorInvalidValue;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, D, T, B * Hq, C::BQ) ||
      !make_map(&tm_k, k, D, T, B * Hkv, C::BK) ||
      !make_map(&tm_v, v, D, T, B * Hkv, C::BK))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<D, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (e != cudaSuccess) return e;
  const float sl2 = (float)(1.4426950408889634 / sqrt((double)D));
  const dim3 grid(B * Hq, nq);
  flash_tc_kernel<D, LSE><<<grid, THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, (__nv_bfloat16*)o, lse, Hq, Hkv, T, W, sl2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int Hq, int Hkv, int T, int W,
                     cudaStream_t s) {
  return lse == nullptr ? launch<D, false>(q, k, v, o, lse, B, Hq, Hkv, T, W, s)
                        : launch<D, true>(q, k, v, o, lse, B, Hq, Hkv, T, W, s);
}

}  // namespace

// Launches the tensor-core banded flash attention on `stream`: bf16 q
// (B, Hq, T, D), k and v (B, Hkv, T, D), o like q, all contiguous with
// 16-byte aligned bases, D in {64, 128, 256}; W is the window (T for full
// causal). `lse`, if not null, is f32 (B, Hq, T) and receives each row's
// log-sum-exp of the scaled scores (natural log). Returns the CUDA error
// code of the launch (0 = success). Allocates nothing and does not
// synchronise.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int B, int Hq, int Hkv, int T, int D,
                                         int W, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  switch (D) {
    case 64: return (int)launch_d<64>(q, k, v, o, l, B, Hq, Hkv, T, W, s);
    case 128: return (int)launch_d<128>(q, k, v, o, l, B, Hq, Hkv, T, W, s);
    case 256: return (int)launch_d<256>(q, k, v, o, l, B, Hq, Hkv, T, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
