// Gather from a small on-chip table, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels `kA`, `kA2` and `kC` of `try_kernel` in
// benchmarks/pallas_gather_probe.py, three Mosaic forms of one function:
//   out[i] = tab[idx[i]]
// for a table of at most 12,288 int32 (48 KB, the static shared-memory
// limit; the script's 8,192 entries are 32 KB).  `kA` gathers from a 1-D
// table, `kA2` from its (T/128, 128) reshape and `kC` through a one-hot
// compare / select / sum, Mosaic's way to a gather without a gather
// instruction; on the card all three are the same contiguous memory and one
// gather from shared memory, so one kernel serves them.  An index outside
// [0, T) is never read: its output is 0 and it is counted in `bad`.
//
// What bounds it on this card: device-memory traffic, 8 B a row (the index
// read and the output write); the table is read once per block from L2.
//
// Design: each block first copies the whole table into shared memory (one
// cooperative, coalesced load), then walks the rows in a grid-stride loop:
// coalesced index loads and output stores, the gather itself a shared-memory
// read (random indices make bank conflicts; 32 KB stays on the SM).  One
// warp vote and one atomicAdd per warp with a bad index count `bad`.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 4;
constexpr long long kMaxTable = 48 * 1024 / 4;

__global__ void __launch_bounds__(kThreads)
table_gather_kernel(const int32_t* __restrict__ tab, int table_size,
                    const int32_t* __restrict__ idx, long long n,
                    int32_t* __restrict__ out, int32_t* __restrict__ bad) {
  extern __shared__ int32_t s_tab[];
  for (int t = threadIdx.x; t < table_size; t += kThreads)
    s_tab[t] = __ldg(tab + t);
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  // every lane runs the same trip count, so the vote sees whole warps
  const long long start = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long trips = (n + stride - 1) / stride;
  for (long long k = 0; k < trips; ++k) {
    const long long i = start + k * stride;
    bool is_bad = false;
    if (i < n) {
      const int32_t j = __ldg(idx + i);
      is_bad = j < 0 || j >= table_size;
      out[i] = is_bad ? 0 : s_tab[j];
    }
    const unsigned votes = __ballot_sync(0xffffffffu, is_bad);
    if ((threadIdx.x & 31) == 0 && votes != 0u) atomicAdd(bad, __popc(votes));
  }
}

}  // namespace

// Plain C entry point for ctypes.  `out` holds n int32, `bad` one zeroed
// int32.  `sm_count` is the card's multiprocessor count: blocks = min(one
// thread per row, kBlocksPerSm per SM), each with table_size * 4 bytes of
// shared memory.  The kernel runs on `stream` and is not synchronised; the
// return value is cudaGetLastError() right after the launch (0 = launched).
extern "C" int table_gather_launch(const void* tab, long long table_size,
                                   const void* idx, long long n, void* out,
                                   void* bad, int sm_count, void* stream) {
  if (n <= 0 || table_size <= 0 || table_size > kMaxTable || sm_count <= 0)
    return (int)cudaErrorInvalidValue;
  const long long wanted = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count * kBlocksPerSm;
  const int blocks = (int)(wanted < cap ? wanted : cap);
  table_gather_kernel<<<blocks, kThreads, (size_t)table_size * 4,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tab), (int)table_size,
      static_cast<const int32_t*>(idx), n, static_cast<int32_t*>(out),
      static_cast<int32_t*>(bad));
  return (int)cudaGetLastError();
}
