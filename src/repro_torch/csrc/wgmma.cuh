// Building blocks of the Hopper (sm_90a) tensor-core kernels under csrc/:
// shared-memory addresses, the 128-byte swizzled tile layout, cp.async,
// wgmma shared-memory descriptors and the m64nNk16 bf16 products; and, on
// the host, the once-per-device opt-in to more than 48 KB of shared memory
// (which the RG-LRU scan uses too).
//
// Layout.  A bf16 tile of `rows` rows is stored as column blocks of 64
// columns (one 128-byte row each); 16-byte chunk c of row r sits at chunk
// position c ^ (r % 8) of its row.  With the base aligned to 1024 bytes this
// is the layout wgmma's 128-byte swizzle reads: K-major (rows are M or N,
// the k-step moves the start address 32 bytes inside the atom; descriptor
// LBO 16, SBO 1024) and MN-major (rows are K, a k16 step is 16 rows;
// LBO = SBO = 1024, one 64-column block per product).
//
// The accumulator of a warpgroup's m64nN product: thread (warp w, lane
// 4g + t) holds, for each 8-column chunk j, d[4j + 2e + i] = (row 16w + g +
// 8e, column 8j + 2t + i).  Its pairs are the A fragments of the
// register-A form: k-step kk takes d[8kk .. 8kk + 7] packed in pairs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace hopper {

constexpr int ROW = 128;  // bytes in one row of a column block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the byte offset of 16-byte chunk c of row r in a tile of `rows` rows
__device__ __forceinline__ uint32_t swizzled(int rows, int r, int c) {
  return (c / 8) * (rows * ROW) + r * ROW + (((c ^ r) & 7) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// makes this thread's shared-memory writes visible to the tensor cores
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (in 16-byte units), layout B128
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
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
// keeps the compiler from moving reads or writes of r across the wgmma
// fence and wait, which it does not know touch r
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F8(i) F4(i), F4(i + 4)
#define F16(i) F8(i), F8(i + 8)
#define F32(i) F16(i), F16(i + 16)

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F32(0)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x N] += A[64 x 16] B[16 x N], A in registers, B MN-major in shared
// memory (scale-d is a predicate, set to 1: always accumulate)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<8>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : F4(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F32
#undef F16
#undef F8
#undef F4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x, the low half, is lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Above 48 KB a block's dynamic shared memory must be allowed explicitly.
// The attribute belongs to the device, so a launcher keeps one of these as a
// static and sets it once per device (a bit each for devices 0-63; others
// set it on every launch).  Two threads may both set it the first time:
// setting it twice is harmless.  A `carveout` other than the default
// (cudaSharedmemCarveoutDefault, -1) also sets the kernel's preferred share
// of the SM's L1 / shared memory, in percent.
class SmemOptIn {
 public:
  cudaError_t operator()(const void* kernel, size_t bytes, int carveout = cudaSharedmemCarveoutDefault) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (bit & done_.load(std::memory_order_acquire)) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess && carveout != cudaSharedmemCarveoutDefault)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
    if (err == cudaSuccess) done_.fetch_or(bit, std::memory_order_release);
    return err;
  }

 private:
  std::atomic<unsigned long long> done_{0};
};

}  // namespace hopper
