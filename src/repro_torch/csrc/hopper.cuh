// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers
// (arrivals on another block's too), TMA tensor loads (multicast to a
// cluster too) and stores, 1-D bulk loads, cp.async, wgmma and its
// shared-memory descriptors, named barriers, the cluster barrier and
// bulk copies into another block's shared memory, and the host-side
// encoding of a TMA tensor map.
//
// The tensor map is encoded by libcuda's cuTensorMapEncodeTiled, looked
// up through the runtime (cudaGetDriverEntryPoint), so the libraries link
// nothing but the CUDA runtime. A map is passed to its kernel by value as a
// `const __grid_constant__ CUtensorMap`, so a launch captured in a CUDA
// graph records it with the other parameters.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Cycles after which a wait gives up (about 10 s at 1.98 GHz): a barrier
// that never completes is a fault, and a trap reports it to the host as
// a launch failure instead of leaving the card hung.
constexpr long long kWaitCycles = 20000000000LL;

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - start > kWaitCycles) __trap();
  }
}

// --- TMA ------------------------------------------------------------------
// Coordinates are in elements, innermost first; the box's innermost start
// must lie on a 16-byte boundary. Elements of the box that fall outside
// the tensor are filled with zeros; the barrier is still told the whole
// box's bytes.

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The same box loaded once and written into the shared memory of every
// block of the cluster in `mask` (bit r: rank r), at dst's offset in
// each; each such block's mbarrier at bar's offset counts the box's bytes.
__device__ __forceinline__ void tma_load_3d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int c0,
                                                      int c1, int c2,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

// Stores a box from shared memory into the tensor (elements outside it are
// not written), as one bulk group of this thread.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until all but the newest `N` of this thread's committed store
// groups have read their shared memory (their buffers may be written
// again).
template <int N = 0>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// 1-D bulk copy (no tensor map) from global to shared memory, reporting
// its bytes to `bar`: `bytes` a multiple of 16, both addresses 16-byte
// aligned.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A 4-byte copy from global to shared memory by this thread (cp.async),
// and an arrival on `bar` once every earlier such copy of this thread has
// landed (not counted in the barrier's pending count: its init count
// includes the arriving threads).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src))
               : "memory");
}
// The same copy where `ok`, else 4 zero bytes (a source size of 0: nothing
// is read from `src`, which must still be a global address).
__device__ __forceinline__ void cp_async_4_or_zero(void* dst, const void* src,
                                                   bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Orders this thread's generic shared-memory writes before later async
// proxy (TMA) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- named barriers (a subset of the block's warps) -------------------------

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- thread-block clusters -------------------------------------------------
// A cluster's blocks run at once on neighbouring SMs and copy into each
// other's shared memory (distributed shared memory) through
// shared::cluster addresses.

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier in two halves: every thread of the cluster arrives
// (relaxed: it orders none of the thread's memory operations; mbarriers
// initialised before it are published by mbar_fence_init) and later
// waits for all the others; a thread waits before it arrives again.
// Arriving right after the set-up and waiting just before the first copy
// into another block keeps the barrier off the critical path.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
// An arrival that orders this thread's earlier memory operations (its
// arrivals on other blocks' mbarriers among them) before the others'
// cluster_wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

// The shared::cluster address of the variable at `p` (in this block's
// shared memory) in the block of rank `rank`.
__device__ __forceinline__ uint32_t cluster_map(const void* p,
                                                uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// One arrival on the mbarrier at shared::cluster address `bar` (this or
// another block's, from cluster_map).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// A bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from this block's shared memory into the shared memory of a
// block of the cluster at shared::cluster address `dst`, counted as
// transaction bytes on that block's mbarrier at shared::cluster address
// `bar`. Only the receiver learns when it has landed: the source stays
// untouched until then.
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst,
                                                  const void* src,
                                                  uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx"
      "::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// --- wgmma ------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a tile written by TMA with 128-byte
// swizzle (layout type 1). `lbo` and `sbo` are the leading and stride byte
// offsets: for a K-major operand sbo is the distance between 8-row groups
// (lbo unused); for an MN-major operand lbo is the distance between
// 64-element (128-byte) column blocks and sbo between 8-row groups of K.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFFull) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFFu) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFFu) >> 4) << 32) |
         (1ull << 62);
}

// --- host: tensor maps ------------------------------------------------------

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// libcuda's cuTensorMapEncodeTiled, looked up once (nullptr where it is
// missing).
inline EncodeTiled encode_tiled_fn() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tiled tensor map over `rank` dimensions (innermost first): `dims` in
// elements, `strides` in bytes for dimensions 1..rank-1 (each a multiple
// of 16), `box` in elements. Returns false if the encoding is refused.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type,
                       uint32_t rank, const void* base, const uint64_t* dims,
                       const uint64_t* strides, const uint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  uint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
