// Q6 mask-sum with int32 hi/lo partials, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `pallas_m8_kernel` behind `pallas_m8` in
// benchmarks/q6bench.py.  For rows r in [0, n), with m = int32(mask[r]) for
// any int8 value (the TPU kernel multiplies whatever byte it is given):
//   prod = int32(a[r] * m * b[r])            (wraps modulo 2**32)
//   out[0] = sum of (prod >> 16)             (arithmetic shift)
//   out[1] = sum of (prod & 0xFFFF)
// each sum taken modulo 2**32, as the TPU kernel's int32 accumulators take
// it (see q6_words_i32.cu: the wrap is kept, it is the kernel's function).
//
// What bounds it on this card: device-memory bandwidth, 9 B/row (a one-byte
// mask and two int32 payloads) against 3.35 TB/s on an H100 SXM.
//
// Design: one thread per row in a grid-stride loop, so mask and payload
// loads are coalesced.  The product is formed in uint32_t (unsigned
// arithmetic wraps; multiplication modulo 2**32 is associative, so the
// order of the two products does not matter).  Both halves accumulate in
// uint32_t, then warp shuffles, a shared-memory block reduction and one
// atomicAdd per block and half replace the TPU grid's sequential carry.
// Vector (16 B) mask loads are left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
q6_mask8_i32_kernel(const int8_t* __restrict__ mask,
                    const int32_t* __restrict__ a,
                    const int32_t* __restrict__ b, long long n,
                    uint32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  uint32_t hi = 0, lo = 0;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < n;
       r += stride) {
    const uint32_t prod = (uint32_t)__ldg(a + r) *
                          (uint32_t)(int32_t)__ldg(mask + r) *
                          (uint32_t)__ldg(b + r);
    hi += (uint32_t)((int32_t)prod >> 16);
    lo += prod & 0xFFFFu;
  }
  for (int off = 16; off > 0; off >>= 1) {
    hi += __shfl_down_sync(0xffffffffu, hi, off);
    lo += __shfl_down_sync(0xffffffffu, lo, off);
  }
  __shared__ uint32_t part_hi[kWarps], part_lo[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    part_hi[warp] = hi;
    part_lo[warp] = lo;
  }
  __syncthreads();
  if (warp == 0) {
    hi = lane < kWarps ? part_hi[lane] : 0u;
    lo = lane < kWarps ? part_lo[lane] : 0u;
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      hi += __shfl_down_sync(0xffffffffu, hi, off);
      lo += __shfl_down_sync(0xffffffffu, lo, off);
    }
    if (lane == 0) {
      atomicAdd(out, hi);
      atomicAdd(out + 1, lo);
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.  `out` must hold two zeroed int32; `mask`
// holds n int8, `a` and `b` n int32.  `sm_count` is the card's
// multiprocessor count: blocks = min(one thread per row, kBlocksPerSm per
// SM).  The kernel runs on `stream` and is not synchronised; the return
// value is cudaGetLastError() right after the launch (0 = launched).
extern "C" int q6_mask8_i32_launch(const void* mask, const void* a,
                                   const void* b, long long n, void* out,
                                   int sm_count, void* stream) {
  if (n <= 0 || sm_count <= 0) return (int)cudaErrorInvalidValue;
  const long long wanted = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count * kBlocksPerSm;
  const int blocks = (int)(wanted < cap ? wanted : cap);
  q6_mask8_i32_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(mask), static_cast<const int32_t*>(a),
      static_cast<const int32_t*>(b), n, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
