// Hopper building blocks shared by the TMA + wgmma kernels (K1, K3, K4):
// shared-memory addresses, mbarriers, TMA loads, wgmma operand descriptors
// and ordering, and the host-side tensor-map encoding.
//
// The tensor maps are encoded with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint(ByVersion), so the library links no libcuda
// (cuda.h is included for the types only).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace slam {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// spins until the barrier's phase differs from parity; a wait of more than
// ~10 s (a broken pipeline) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  do {
    if (clock64() - t0 > 20000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6, %7}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// a contiguous run of bytes (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// wgmma operand descriptors for tiles that TMA wrote with the 128-byte
// swizzle: rows of 128 bytes, the swizzle atom is 8 rows (1024 bytes, and
// the tile base is 1024-byte aligned).
//
// K-major (the contraction dimension contiguous): 8-row groups 1024 bytes
// apart (SBO); LBO is unused for this layout. A step of 16 bf16 (32 bytes)
// along K adds 32 bytes to the address.
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  const uint32_t addr = smem_u32(p);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// MN-major (the output dimension contiguous, the operand read through the
// transpose bit): each row holds 64 bf16 along MN for one K index; groups
// of 8 K rows are 1024 bytes apart (SBO), and the next 64 along MN lies
// `mn_stride` bytes on (LBO). A step of 16 along K adds 2048 bytes.
__device__ __forceinline__ uint64_t desc_mnmajor(const void* p, uint32_t mn_stride) {
  const uint32_t addr = smem_u32(p);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((mn_stride >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ties registers that an asynchronous wgmma reads or writes to the
// program order around it: place after wgmma_wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// shared memory written by threads (the generic proxy), made visible to
// wgmma and TMA (the async proxy)
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// a named barrier over `threads` threads (ids 1-15; 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a rank-`rank` tensor, dims innermost first, strides in bytes of dims 1..,
// loaded as boxes of `box` elements under the 128-byte swizzle; reads past
// the tensor's edge fill zeros
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapL2promotion l2 = CU_TENSOR_MAP_L2_PROMOTION_L2_256B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, l2, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// a kernel's dynamic shared-memory limit, set once per device (one bit each
// in `done`); call outside any stream capture
template <typename Kernel>
cudaError_t configure_smem(Kernel kernel, int smem_bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> dev & 1ull)) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess) done |= 1ull << dev;
  return err;
}

}  // namespace slam
