// One-way exchange between the blocks of a thread-block cluster, for
// sm_90a: a producer stores into a peer's shared memory with `st.async`,
// which completes bytes on an mbarrier in that peer's shared memory; the
// peer waits on its own barrier's phase. No cluster-wide barrier.
//
// Used by the sLSTM kernel B8 (slstm.cu) and by its exchange probe
// (slstm_probe.cu).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `addr` (a shared::cta address of this
// block) in the block of cluster rank `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the whole cluster; a
// cluster barrier must follow before any peer stores into them.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also adds `bytes` to the phase's expected transfer.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed, with
// acquire semantics at cluster scope (the peers' stores are visible
// after). Each `try_wait` may suspend the thread until the phase
// completes or a time limit of the hardware passes. No hang guard (a
// counted loop lengthens B8's step): the callers' phases always complete,
// since every peer reaches the stores that complete them.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        " .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// Stores 4 bytes at `remote` (a shared::cluster address) and completes 4
// bytes on the barrier at `remote_bar` in the same block.
__device__ __forceinline__ void st_async(uint32_t remote, float v,
                                         uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];"
      :: "r"(remote), "r"(__float_as_uint(v)), "r"(remote_bar) : "memory");
}

// Cluster-wide barrier with release / acquire semantics.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// Launches `kernel` on a grid of (cluster x grid_y) blocks, in clusters of
// `cluster` blocks along x (above 8 with the non-portable attribute, which
// only the probe asks for).
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), int cluster,
                             int grid_y, int threads, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, grid_y, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace cx
