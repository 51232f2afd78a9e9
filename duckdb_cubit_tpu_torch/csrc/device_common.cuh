// Device helpers shared by the port's kernels for NVIDIA Hopper (sm_90a):
// loads of data read once, asynchronous copies into shared memory, and the
// one-atomic finish of a count summed over a grid.  Each kernel source
// includes this header; `ops/cuda_build.py` rebuilds a kernel when this
// file is newer than its library.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// An L2 policy that makes the lines a load brings in the first to evict.
// Data read once should not push out what else the L2 holds: lines that
// other work left dirty would otherwise be written back during the kernel,
// on the memory it streams from.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
      : "=l"(policy));
  return policy;
}

// 16 B through the read-only path, under `policy`
__device__ __forceinline__ int4 load_once(const int4* p, uint64_t policy) {
  int4 v;
  asm("ld.global.nc.L2::cache_hint.v4.s32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

// 16 B from global to shared memory without registers (cp.async, bypassing
// L1); both addresses 16-B aligned
__device__ __forceinline__ void copy16_async(int32_t* dst,
                                             const int32_t* src) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(src) : "memory");
}

// until this thread's cp.async copies have landed
__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// A count summed over the grid with one atomic per block and no memset:
// `scratch` is a 64-bit word whose bits 48..63 count the blocks that have
// added and bits 0..47 sum their counts.  The block whose add completes the
// block count writes the sum (modulo 2**32) to `out` and zeroes the word
// for the next launch.  Every thread of the block calls this with its own
// count; `s_part` holds one word per warp of shared memory that no thread
// reads any more.  The grid has at most kMaxCountBlocks blocks and the
// counts sum to less than 2**48.
constexpr int kCountBlockShift = 48;
constexpr int kMaxCountBlocks = (1 << (64 - kCountBlockShift)) - 1;

__device__ __forceinline__ void finish_count(uint32_t count, uint32_t* s_part,
                                             unsigned long long* scratch,
                                             int32_t* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0) s_part[warp] = count;
  __syncthreads();
  if (warp == 0) {
    const uint32_t part = __reduce_add_sync(
        0xffffffffu, lane < warps ? s_part[lane] : 0u);
    if (lane == 0) {
      const unsigned long long add = (1ull << kCountBlockShift) + part;
      const unsigned long long total = atomicAdd(scratch, add) + add;
      if ((total >> kCountBlockShift) == gridDim.x) {
        *out = (int32_t)(uint32_t)total;
        atomicExch(scratch, 0ull);
      }
    }
  }
}

}  // namespace
