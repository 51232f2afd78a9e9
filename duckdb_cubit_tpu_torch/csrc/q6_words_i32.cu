// Q6 word-sum with int32 hi/lo partials, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `q6_kernel` behind `pallas_q6` in
// benchmarks/q6bench.py.  For rows r in [0, n), with bit = bit (r & 31) of
// words[r >> 5] (the engine's bitvector order):
//   prod = int32(a[r] * bit * b[r])          (wraps modulo 2**32)
//   out[0] = sum of (prod >> 16)             (arithmetic shift)
//   out[1] = sum of (prod & 0xFFFF)
// each sum taken modulo 2**32, as the TPU kernel's int32 accumulators take
// it.  The caller combines out[0] * 65536 + out[1]; when a sum wraps (the
// low half does at SF1 for random words) that is not the true sum, and the
// kernel keeps the wrap: it is what the TPU kernel computes.
//
// What bounds it on this card: device-memory bandwidth.  A row costs 1/8 B
// of words plus 8 B of payload (8.125 B/row) against 3.35 TB/s on an H100
// SXM; the arithmetic is a few integer ops per row.
//
// Design: K1's layout.  One warp takes 32 consecutive rows, so its bits are
// exactly one word, read once (one broadcast transaction), and its payload
// loads are coalesced; a lane loads its payload only where its bit is set.
// The product is formed in uint32_t (signed overflow is undefined in C++,
// unsigned wraps), and both halves accumulate in uint32_t per thread, then
// by warp shuffles and a shared-memory block reduction.  Addition modulo
// 2**32 does not depend on order, so one atomicAdd per block and half stands
// in for the TPU grid's sequential carry and the result is bit-equal to it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ void block_add(uint32_t hi, uint32_t lo,
                                          uint32_t* out) {
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

__global__ void __launch_bounds__(kThreads)
q6_words_i32_kernel(const uint32_t* __restrict__ words,
                    const int32_t* __restrict__ a,
                    const int32_t* __restrict__ b, long long n_words,
                    uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long total_warps = (long long)gridDim.x * kWarps;
  uint32_t hi = 0, lo = 0;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       w < n_words; w += total_warps) {
    const uint32_t word = __ldg(words + w);
    if ((word >> lane) & 1u) {
      const long long row = w * 32 + lane;
      const uint32_t prod =
          (uint32_t)__ldg(a + row) * (uint32_t)__ldg(b + row);
      hi += (uint32_t)((int32_t)prod >> 16);
      lo += prod & 0xFFFFu;
    }
  }
  block_add(hi, lo, out);
}

}  // namespace

// Plain C entry point for ctypes.  `out` must hold two zeroed int32; `a` and
// `b` hold 32 * n_words int32.  `sm_count` is the card's multiprocessor
// count: blocks = min(one warp per word, kBlocksPerSm per SM).  The kernel
// runs on `stream` and is not synchronised; the return value is
// cudaGetLastError() right after the launch (0 = launched).
extern "C" int q6_words_i32_launch(const void* words, const void* a,
                                   const void* b, long long n_words,
                                   void* out, int sm_count, void* stream) {
  if (n_words <= 0 || sm_count <= 0) return (int)cudaErrorInvalidValue;
  const long long wanted = (n_words + kWarps - 1) / kWarps;
  const long long cap = (long long)sm_count * kBlocksPerSm;
  const int blocks = (int)(wanted < cap ? wanted : cap);
  q6_words_i32_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(a),
      static_cast<const int32_t*>(b), n_words, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
