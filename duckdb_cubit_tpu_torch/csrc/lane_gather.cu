// Gather within 128-wide rows, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `kB` of `try_kernel` in
// benchmarks/pallas_gather_probe.py (`take_along_axis` along the lanes of a
// tiled table).  For a (rows, 128) int32 table and (R, 128) int32 lane
// indices in [0, 128):
//   out[r, c] = tab[r % rows, lane_idx[r, c]]
// An index outside [0, 128) is never read: it gives 0 and is counted in
// `bad`.
//
// What bounds it on this card: device-memory traffic, 8 B an element (the
// lane index read and the output write) plus the table once, against
// 3.35 TB/s on an H100 SXM.
//
// Design (the rows kernel, for tables of up to 96 rows, 48 KB):
//  - The whole table sits in shared memory, so an output is one
//    shared-memory read at row (r % rows) * 128 + j: no table row is
//    reloaded per output row, and no shuffles select among registers.
//  - One persistent block of 1024 threads per SM; the table is copied by
//    cp.async (16 B at a time, no registers) while every thread's first
//    index loads are already in flight, as in table_gather.cu.
//  - A warp takes whole rows: lane l loads columns 4 l .. 4 l + 3 of row r
//    as one int4 (one coalesced 512-B span a warp) under an L2 evict-first
//    policy and stores the four outputs as one streaming int4.  Warp w takes
//    rows w, w + W, w + 2 W, ... (W warps in the grid), four rows in
//    flight (64 KB an SM), the next trip's loads issued before the current
//    trip is gathered.
//  - r % rows is stepped, not divided: row r + W has remainder
//    (m + W % rows) mod rows.  Where rows divides W (64 rows at the
//    script's shapes) the step is 0 and a warp reads one table row.
//  - `bad`: per thread, per warp, per block, then one add per block into a
//    scratch word that counts the blocks; the last block writes `bad` and
//    zeroes the word, as in table_gather.cu.
//
// Larger tables, and indices or outputs that do not start on a 16-B
// boundary, go to the plain kernel below: one element a thread, the table
// read through the read-only cache.

#include "device_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kWidth = 128;
constexpr int kQuads = kWidth / 4;   // int4s a row: one a lane
constexpr int kUnroll = 4;           // rows a warp has in flight
constexpr long long kMaxTable = 48 * 1024 / 4;
constexpr long long kMaxRows = (1LL << 47) / kWidth;   // `bad` below 2**48

// trow[j], or 0 (counted) when j is outside [0, 128)
__device__ __forceinline__ int32_t pick(const int32_t* trow, int32_t j,
                                        uint32_t& n_bad) {
  const bool ok = (uint32_t)j < (uint32_t)kWidth;
  n_bad += !ok;
  const int32_t v = trow[ok ? j : 0];
  return ok ? v : 0;
}

__global__ void __launch_bounds__(kThreads, 1)
lane_gather_rows_kernel(const int32_t* __restrict__ tab, int table_rows,
                        const int32_t* __restrict__ lane_idx,
                        long long n_rows, int32_t* __restrict__ out,
                        unsigned long long* __restrict__ scratch,
                        int32_t* __restrict__ bad) {
  extern __shared__ int4 s_raw[];
  int32_t* s_tab = reinterpret_cast<int32_t*>(s_raw);
  const int table_size = table_rows * kWidth;

  int copied = 0;
  if (((uintptr_t)tab & 15) == 0) {
    copied = table_size;
    for (int t = 4 * threadIdx.x; t < copied; t += 4 * kThreads)
      copy16_async(s_tab + t, tab + t);
  }
  for (int t = copied + threadIdx.x; t < table_size; t += kThreads)
    s_tab[t] = __ldg(tab + t);

  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long warps = (long long)gridDim.x * kWarps;
  const int4* qidx = reinterpret_cast<const int4*>(lane_idx) + lane;
  int4* qout = reinterpret_cast<int4*>(out) + lane;
  const uint32_t rows = (uint32_t)table_rows;
  const uint32_t step = (uint32_t)(warps % rows);
  uint32_t m = (uint32_t)(warp % rows);    // r % rows of the warp's row r
  const uint64_t policy = evict_first_policy();
  const int4 zero = make_int4(0, 0, 0, 0);

  int4 next[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long r = warp + u * warps;
    next[u] = r < n_rows ? load_once(qidx + r * kQuads, policy) : zero;
  }
  wait_async_copies();
  __syncthreads();

  uint32_t n_bad = 0;
  for (long long r0 = warp; r0 < n_rows; r0 += kUnroll * warps) {
    int4 cur[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = next[u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + (kUnroll + u) * warps;
      next[u] = r < n_rows ? load_once(qidx + r * kQuads, policy) : zero;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * warps;
      const int32_t* trow = s_tab + m * kWidth;
      if (r < n_rows)
        __stcs(qout + r * kQuads,
               make_int4(pick(trow, cur[u].x, n_bad),
                         pick(trow, cur[u].y, n_bad),
                         pick(trow, cur[u].z, n_bad),
                         pick(trow, cur[u].w, n_bad)));
      m += step;
      if (m >= rows) m -= rows;
    }
  }

  __syncthreads();
  finish_count(n_bad, reinterpret_cast<uint32_t*>(s_raw), scratch, bad);
}

// Any table size and any alignment: one element a thread, the table row
// read through the read-only cache.
__global__ void __launch_bounds__(kThreads)
lane_gather_plain_kernel(const int32_t* __restrict__ tab, long long table_rows,
                         const int32_t* __restrict__ lane_idx,
                         long long n_rows, int32_t* __restrict__ out,
                         unsigned long long* __restrict__ scratch,
                         int32_t* __restrict__ bad) {
  __shared__ uint32_t s_part[kWarps];
  const long long n = n_rows * kWidth;
  const long long stride = (long long)gridDim.x * kThreads;
  uint32_t n_bad = 0;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int32_t* trow = tab + ((i / kWidth) % table_rows) * kWidth;
    const int32_t j = __ldg(lane_idx + i);
    const bool ok = (uint32_t)j < (uint32_t)kWidth;
    n_bad += !ok;
    const int32_t v = __ldg(trow + (ok ? j : 0));
    out[i] = ok ? v : 0;
  }
  finish_count(n_bad, s_part, scratch, bad);
}

}  // namespace

// Plain C entry point for ctypes.  `out` holds n_rows * 128 int32; `bad`
// (one int32) is written by the kernel.  `scratch` (one int64) must be zero
// and is zero again when the kernel ends, so launches that share it must
// run in turn (one scratch per stream).  Tables of up to 96 rows with
// `lane_idx` and `out` 16-B aligned take the rows kernel (blocks = min(one
// per SM, one per 32 rows), the table in rows * 512 B of shared memory);
// anything else takes the plain kernel.  `sm_count` is the card's
// multiprocessor count.  The kernel runs on `stream` and is not
// synchronised; the return value is cudaGetLastError() right after the
// launch (0 = launched).
extern "C" int lane_gather_launch(const void* tab, long long table_rows,
                                  const void* lane_idx, long long n_rows,
                                  void* out, void* scratch, void* bad,
                                  int sm_count, void* stream) {
  if (n_rows <= 0 || n_rows >= kMaxRows || table_rows <= 0 ||
      table_rows > 0x7fffffffLL || sm_count <= 0)
    return (int)cudaErrorInvalidValue;
  const long long cap =
      sm_count < kMaxCountBlocks ? sm_count : kMaxCountBlocks;
  const auto* t = static_cast<const int32_t*>(tab);
  const auto* li = static_cast<const int32_t*>(lane_idx);
  auto* o = static_cast<int32_t*>(out);
  auto* s = static_cast<unsigned long long*>(scratch);
  auto* b = static_cast<int32_t*>(bad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (table_rows * kWidth <= kMaxTable &&
      (((uintptr_t)lane_idx | (uintptr_t)out) & 15) == 0) {
    const long long wanted = (n_rows + kWarps - 1) / kWarps;
    const int blocks = (int)(wanted < cap ? wanted : cap);
    lane_gather_rows_kernel<<<blocks, kThreads,
                              (size_t)table_rows * kWidth * 4, st>>>(
        t, (int)table_rows, li, n_rows, o, s, b);
  } else {
    const long long wanted = (n_rows * kWidth + kThreads - 1) / kThreads;
    const long long most =
        2 * cap < kMaxCountBlocks ? 2 * cap : kMaxCountBlocks;
    const int blocks = (int)(wanted < most ? wanted : most);
    lane_gather_plain_kernel<<<blocks, kThreads, 0, st>>>(
        t, table_rows, li, n_rows, o, s, b);
  }
  return (int)cudaGetLastError();
}
