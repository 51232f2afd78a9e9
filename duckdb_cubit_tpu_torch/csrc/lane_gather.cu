// Gather within 128-wide rows, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `kB` of `try_kernel` in
// benchmarks/pallas_gather_probe.py (`take_along_axis` along the lanes of a
// tiled table).  For a (rows, 128) int32 table and (R, 128) int32 lane
// indices in [0, 128):
//   out[r, c] = tab[r % rows, lane_idx[r, c]]
// An index outside [0, 128) is counted in `bad` and gives 0.
//
// What bounds it on this card: device-memory traffic, 8 B a row (the lane
// index read and the output write); the table row is 512 B and stays in L1.
//
// Design: the TPU gathers within a vector register's lanes; the closest
// Hopper counterpart is a gather within a warp's registers.  One warp takes
// one 128-wide row: lane l holds tab[r % rows, l + 32k] for k = 0..3 in four
// registers (coalesced loads).  Element j is register j / 32 of lane j % 32,
// so each output takes four __shfl_sync (one per register) and keeps the
// one that j / 32 selects.  Index loads and output stores are coalesced.
// Warps walk the rows in a grid-stride loop; all lanes of a warp share its
// row, so the shuffles and the vote always see the whole warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;
constexpr int kWidth = 128;

__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const int32_t* __restrict__ tab, int table_rows,
                   const int32_t* __restrict__ lane_idx, long long n_rows,
                   int32_t* __restrict__ out, int32_t* __restrict__ bad) {
  const int lane = threadIdx.x & 31;
  const long long total_warps = (long long)gridDim.x * kWarps;
  int n_bad = 0;
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       r < n_rows; r += total_warps) {
    const int32_t* trow = tab + (r % table_rows) * kWidth;
    const int32_t t0 = __ldg(trow + lane), t1 = __ldg(trow + lane + 32),
                  t2 = __ldg(trow + lane + 64), t3 = __ldg(trow + lane + 96);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long at = r * kWidth + lane + 32 * k;
      const int32_t j = __ldg(lane_idx + at);
      const int src = j & 31;
      const int32_t v0 = __shfl_sync(0xffffffffu, t0, src);
      const int32_t v1 = __shfl_sync(0xffffffffu, t1, src);
      const int32_t v2 = __shfl_sync(0xffffffffu, t2, src);
      const int32_t v3 = __shfl_sync(0xffffffffu, t3, src);
      const bool ok = j >= 0 && j < kWidth;
      const int reg = j >> 5;
      out[at] = !ok ? 0 : reg == 0 ? v0 : reg == 1 ? v1 : reg == 2 ? v2 : v3;
      n_bad += !ok;
    }
  }
  if (n_bad) atomicAdd(bad, n_bad);
}

}  // namespace

// Plain C entry point for ctypes.  `out` holds n_rows * 128 int32, `bad` one
// zeroed int32.  `sm_count` is the card's multiprocessor count: blocks =
// min(one warp per row, kBlocksPerSm per SM).  The kernel runs on `stream`
// and is not synchronised; the return value is cudaGetLastError() right
// after the launch (0 = launched).
extern "C" int lane_gather_launch(const void* tab, long long table_rows,
                                  const void* lane_idx, long long n_rows,
                                  void* out, void* bad, int sm_count,
                                  void* stream) {
  if (n_rows <= 0 || table_rows <= 0 || table_rows > 0x7fffffffLL ||
      sm_count <= 0)
    return (int)cudaErrorInvalidValue;
  const long long wanted = (n_rows + kWarps - 1) / kWarps;
  const long long cap = (long long)sm_count * kBlocksPerSm;
  const int blocks = (int)(wanted < cap ? wanted : cap);
  lane_gather_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tab), (int)table_rows,
      static_cast<const int32_t*>(lane_idx), n_rows,
      static_cast<int32_t*>(out), static_cast<int32_t*>(bad));
  return (int)cudaGetLastError();
}
