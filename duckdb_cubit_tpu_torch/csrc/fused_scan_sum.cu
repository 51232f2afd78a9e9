// Fused CUBIT bitmap scan + exact int64 SUM, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` built by `_build_call` behind
// `fused_scan_sum` in duckdb_cubit_tpu/ops/pallas_kernels.py.  It computes the
// same value: the exact sum, over the rows whose predicate bit is set, of
//   mode 0: a[r]
//   mode 1: a[r] * b[r]
//   mode 2: (p & 0xFFFFFF) * ((p >> 24) & 0xFF), p = a[r]  (one packed column)
// with `words` in the engine's bitvector order (bit r & 31 of word r >> 5 is
// row r), not the TPU's bit-plane order.
//
// What bounds it on this card: device-memory bandwidth.  A row costs 1/8 B
// of predicate plus 4 B of packed payload (4.125 B/row) or 8 B for two
// columns (8.125 B/row), against 3.35 TB/s on an H100 SXM; arithmetic is a
// few integer ops per row.
//
// Design: one warp takes 32 consecutive rows, so its 32 bits are exactly one
// word, read once (same address in every lane, one broadcast transaction),
// and its payload loads are coalesced.  A lane loads its payload only where
// its bit is set, so 32-byte sectors with no selected row are not fetched.
// Each thread keeps an int64 sum; a warp shuffle reduction, a shared-memory
// block reduction and one 64-bit atomicAdd per block finish it.  Two's-
// complement addition is exact and independent of order, so the result is
// bit-exact from run to run.  int64 accumulation makes the TPU kernel's
// hi/lo split and its split search unnecessary.  The ragged tail (n not a
// multiple of 32) is masked.  TMA and vector loads are left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
fused_scan_sum_kernel(const uint32_t* __restrict__ words,
                      const int32_t* __restrict__ a,
                      const int32_t* __restrict__ b,
                      long long n, long long n_words,
                      unsigned long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long total_warps = (long long)gridDim.x * kWarps;
  long long acc = 0;
  for (long long w = (long long)blockIdx.x * kWarps + warp; w < n_words;
       w += total_warps) {
    const uint32_t word = __ldg(words + w);
    const long long row = w * 32 + lane;
    if (((word >> lane) & 1u) && row < n) {
      if (kMode == 0) {
        acc += (long long)__ldg(a + row);
      } else if (kMode == 1) {
        acc += (long long)__ldg(a + row) * (long long)__ldg(b + row);
      } else {
        const int32_t p = __ldg(a + row);
        acc += (long long)(p & 0xFFFFFF) * (long long)((p >> 24) & 0xFF);
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ long long partial[kWarps];
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? partial[lane] : 0;
    for (int off = kWarps / 2; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) atomicAdd(out, (unsigned long long)acc);
  }
}

}  // namespace

// Plain C entry point for ctypes.  `out` must hold one zeroed int64;
// `sm_count` is the card's multiprocessor count, from which the launch shape
// is chosen here: enough blocks to give every word a warp, at most
// kBlocksPerSm per SM.  The kernel runs on `stream` and is not synchronised;
// the return value is cudaGetLastError() right after the launch
// (0 = launched).
extern "C" int fused_scan_sum_launch(const void* words, const void* a,
                                     const void* b, long long n, int mode,
                                     void* out, int sm_count, void* stream) {
  const long long n_words = (n + 31) / 32;
  const long long wanted = (n_words + kWarps - 1) / kWarps;
  const long long cap = (long long)sm_count * kBlocksPerSm;
  const int blocks = (int)(wanted < 1 ? 1 : (wanted < cap ? wanted : cap));
  auto* w = static_cast<const uint32_t*>(words);
  auto* pa = static_cast<const int32_t*>(a);
  auto* pb = static_cast<const int32_t*>(b);
  auto* o = static_cast<unsigned long long*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    fused_scan_sum_kernel<0><<<blocks, kThreads, 0, s>>>(w, pa, pb, n, n_words, o);
  else if (mode == 1)
    fused_scan_sum_kernel<1><<<blocks, kThreads, 0, s>>>(w, pa, pb, n, n_words, o);
  else if (mode == 2)
    fused_scan_sum_kernel<2><<<blocks, kThreads, 0, s>>>(w, pa, pb, n, n_words, o);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
