// Thread-block cluster helpers shared by the port's kernels (K1 scd.cu,
// K2 quant.cu, K4 topk.cu): the cluster barrier, a CTA's rank, reads of a
// peer's shared memory (distributed shared memory, `mapa` and
// `ld.shared::cluster`), stores into it that complete on the peer's
// mbarrier (`st.async`), the mbarrier waits, and a launch configuration
// with a cluster dimension for cudaLaunchKernelEx.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cluster {

constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Every thread of every CTA of the cluster arrives and waits; the writes
// to shared memory before it are visible to the whole cluster after it.
__device__ __forceinline__ void sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// The two halves of sync(), for a rendezvous whose wait can come later
// than its arrival: work between them overlaps the peers' arrivals.
__device__ __forceinline__ void arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p` in the CTA of rank `r`.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t r) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_addr(p)), "r"(r));
  return out;
}

__device__ __forceinline__ unsigned long long ld_u64(uint32_t addr) {
  unsigned long long v;
  asm volatile("ld.shared::cluster.u64 %0, [%1];\n"
               : "=l"(v) : "r"(addr) : "memory");
  return v;
}

// -- mbarriers in shared memory, and stores into a peer's shared memory
// that complete their bytes on the peer's mbarrier --------------------------

constexpr long long kWaitCycles = 1LL << 34;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Make this CTA's mbarrier initialisations visible to the cluster (the
// peers may complete bytes on them after the next rendezvous).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t a, uint32_t parity) {
  uint32_t done;
  asm volatile("{\n\t.reg .pred p;\n\t"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
               "selp.u32 %0, 1, 0, p;\n\t}\n"
               : "=r"(done) : "r"(a), "r"(parity) : "memory");
  return done != 0;
}

// The same, acquiring at cluster scope: the bytes behind the phase were
// stored by the peers of the cluster.
__device__ __forceinline__ bool mbar_try_cluster(uint32_t a,
                                                 uint32_t parity) {
  uint32_t done;
  asm volatile("{\n\t.reg .pred p;\n\t"
               "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
               "p, [%1], %2;\n\t"
               "selp.u32 %0, 1, 0, p;\n\t}\n"
               : "=r"(done) : "r"(a), "r"(parity) : "memory");
  return done != 0;
}

// Spin until the phase of `bar` with parity `parity` has completed. A wait
// that lasts kWaitCycles (seconds; no kernel here waits that long) is a
// fault: it traps, so that the launch fails instead of hanging.
template <bool CLUSTER>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (CLUSTER ? mbar_try_cluster(a, parity) : mbar_try(a, parity)) return;
  const long long t0 = clock64();
  while (!(CLUSTER ? mbar_try_cluster(a, parity) : mbar_try(a, parity)))
    if (clock64() - t0 > kWaitCycles) __trap();
}

// Store 4 bytes into a peer's shared memory (`addr` from peer_addr) and
// complete them on the peer's mbarrier `bar` (also from peer_addr).
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t v,
                                         uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
               "[%0], %1, [%2];\n"
               :: "r"(addr), "r"(v), "r"(bar) : "memory");
}

// The same for 16 bytes (`addr` 16-byte aligned).
__device__ __forceinline__ void st_async(uint32_t addr, uint4 v,
                                         uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes"
               ".v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w),
                  "r"(bar) : "memory");
}

// `grid` CTAs of `block` threads in clusters of `size` along x; `attr`
// holds the cluster attribute and must outlive the launch call.
inline cudaLaunchConfig_t config(int grid, int block, int size, size_t smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid, 1, 1);
  cfg.blockDim = dim3((unsigned)block, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Let `Kernel` take clusters of 16 and `smem` bytes of dynamic shared
// memory on the current device. The attributes are set once per device,
// and the shared-memory one again only when a launch needs more than
// any before it, so a steady stream of launches makes no runtime call
// here but cudaGetDevice.
template <auto Kernel>
cudaError_t allow(size_t smem) {
  static size_t granted[kMaxDevices] = {};   // 1 + the bytes set so far
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (granted[dev] == 0) {
    e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    granted[dev] = 1;
  }
  if (smem + 1 > granted[dev]) {
    e = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted[dev] = smem + 1;
  }
  return cudaSuccess;
}

}  // namespace cluster
