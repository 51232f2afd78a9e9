// Monotone direct-address gather (the PK-FK join probe), for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_kernel` built by `_build_call` behind
// `monotone_gather` in duckdb_cubit_tpu/ops/pallas_probe.py.  It computes
//   out[i] = lut[keys[i]]
// for int32 keys that should be non-decreasing and lie in [0, lut_size).
// `overflow` counts the keys that break that precondition: a key outside
// [0, lut_size), or a key smaller than keys[i - 1].  Such a key gets
// out[i] = -1 and is counted, so a caller that mislabels a column as sorted
// sees a non-zero count, never a silent wrong row.
//
// What bounds it on this card: device-memory traffic.  A key costs 4 B read,
// 4 B written and one 4 B lut read.  Sorted keys make neighbouring threads
// read neighbouring lut slots, so a warp's lut reads fall into one or a few
// 32-byte sectors when the keys are dense (an FK column against its PK lut).
//
// Design: one thread per key; key loads and output stores are coalesced;
// the lut is read through the read-only cache (__ldg).  The predecessor
// key is read again by the next thread (same cache line).  One warp vote and
// one atomicAdd per warp with a bad key accumulate `overflow`.  The TPU
// kernel's (1024, 128) blocks, lut windows and candidate-row picks exist only
// because Mosaic has no per-element gather; none of that is needed here, and
// no padding of the keys either.  A shared-memory lut window, vector loads
// and fetching several value luts in one pass are left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
monotone_gather_kernel(const int32_t* __restrict__ lut, long long lut_size,
                       const int32_t* __restrict__ keys, long long n,
                       int32_t* __restrict__ out,
                       int32_t* __restrict__ overflow) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  bool bad = false;
  if (i < n) {
    const int32_t k = __ldg(keys + i);
    bad = k < 0 || (long long)k >= lut_size ||
          (i > 0 && k < __ldg(keys + i - 1));
    out[i] = bad ? -1 : __ldg(lut + k);
  }
  // every lane of the warp reaches the vote, the tail lanes with bad = false
  const unsigned votes = __ballot_sync(0xffffffffu, bad);
  if ((threadIdx.x & 31) == 0 && votes != 0u)
    atomicAdd(overflow, __popc(votes));
}

}  // namespace

// Plain C entry point for ctypes.  `overflow` must hold one zeroed int32;
// `out` holds n int32.  The kernel runs on `stream` and is not synchronised;
// the return value is cudaGetLastError() right after the launch
// (0 = launched).  n must be positive.
extern "C" int monotone_gather_launch(const void* lut, long long lut_size,
                                      const void* keys, long long n,
                                      void* out, void* overflow,
                                      void* stream) {
  if (n <= 0 || lut_size <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  monotone_gather_kernel<<<(unsigned)blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lut), lut_size,
      static_cast<const int32_t*>(keys), n, static_cast<int32_t*>(out),
      static_cast<int32_t*>(overflow));
  return (int)cudaGetLastError();
}
