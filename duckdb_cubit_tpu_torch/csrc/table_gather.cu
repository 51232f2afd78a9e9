// Gather from a small on-chip table, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels `kA`, `kA2` and `kC` of `try_kernel` in
// benchmarks/pallas_gather_probe.py, three Mosaic forms of one function:
//   out[i] = tab[idx[i]]
// for a table of at most 12,288 int32 (48 KB of shared memory; the script's
// 8,192 entries are 32 KB).  `kA` gathers from a 1-D table, `kA2` from its
// (T/128, 128) reshape and `kC` through a one-hot compare / select / sum,
// Mosaic's way to a gather without a gather instruction; on the card all
// three are the same contiguous memory and one gather from shared memory,
// so one kernel serves them.  An index outside [0, T) is never read: its
// output is 0 and it is counted in `bad`.
//
// What bounds it on this card: device-memory traffic, 8 B a row (the index
// read and the output write) plus the table once, against 3.35 TB/s on an
// H100 SXM.  To stream at that rate the card needs about 20 KB in flight
// per SM.
//
// Design:
//  - One persistent block of 1024 threads per SM, so the table is copied
//    132 times (4.3 MB of L2 reads for 32 KB), not once per small block.
//  - The copy is asynchronous: cp.async moves 16 B at a time from global to
//    shared memory without registers, and every thread issues its first
//    index loads before it waits for the table, so the two overlap.
//  - Indices are loaded 16 B at a time under an L2 evict-first policy (they
//    are read once, as in q6_words_i32.cu), four int4 a thread in flight
//    (64 KB an SM): the next trip's loads are issued before the current
//    trip is gathered.  In a study on an H100 four beat two and three by
//    4%, and two blocks of 512 threads an SM did no better than one of
//    1024.  Outputs are stored 16 B at a time as streaming stores
//    (st.global.cs).
//  - The gather is a shared-memory read; random indices make bank
//    conflicts (about 1k warp reads an SM at the script's shapes), which do
//    not bound it.  An out-of-range index reads entry 0 and selects 0, so
//    no address outside the table is formed.
//  - A view that does not start on a 16-B boundary (`idx[1:]`) runs its
//    first 1-3 indices scalar, then int4s; a ragged tail of 1-3 indices
//    runs scalar.  The int4 stores need `out` at the same offset from a
//    16-B boundary as `idx` (the wrapper allocates it so); where it is not,
//    every index runs scalar.
//  - `bad` is summed per thread, reduced per warp and per block, and added
//    once per block into a 64-bit scratch word that also counts the blocks:
//    the block whose add completes the count writes `bad` and zeroes the
//    word for the next launch (`finish_count` in device_common.cuh), so
//    no memset or fill precedes the launch.

#include "device_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;    // int4 index loads a thread has in flight
constexpr long long kMaxTable = 48 * 1024 / 4;
constexpr long long kMaxRows = 1LL << 47;   // `bad` sums below 2**48

// tab[j], or 0 (counted) when j is outside [0, size)
__device__ __forceinline__ int32_t pick(const int32_t* s_tab, uint32_t size,
                                        int32_t j, uint32_t& n_bad) {
  const bool ok = (uint32_t)j < size;
  n_bad += !ok;
  const int32_t v = s_tab[ok ? j : 0];
  return ok ? v : 0;
}

__device__ __forceinline__ int4 pick4(const int32_t* s_tab, uint32_t size,
                                      int4 j, uint32_t& n_bad) {
  return make_int4(pick(s_tab, size, j.x, n_bad),
                   pick(s_tab, size, j.y, n_bad),
                   pick(s_tab, size, j.z, n_bad),
                   pick(s_tab, size, j.w, n_bad));
}

__global__ void __launch_bounds__(kThreads, 1)
table_gather_kernel(const int32_t* __restrict__ tab, int table_size,
                    const int32_t* __restrict__ idx, long long n,
                    int32_t* __restrict__ out,
                    unsigned long long* __restrict__ scratch,
                    int32_t* __restrict__ bad) {
  extern __shared__ int4 s_raw[];
  int32_t* s_tab = reinterpret_cast<int32_t*>(s_raw);
  const uint32_t size = (uint32_t)table_size;

  // 1. start the table copy: int4s by cp.async where `tab` is 16-B aligned,
  //    the rest entry by entry
  int copied = 0;
  if (((uintptr_t)tab & 15) == 0) {
    copied = table_size & ~3;
    for (int t = 4 * threadIdx.x; t < copied; t += 4 * kThreads)
      copy16_async(s_tab + t, tab + t);
  }
  for (int t = copied + threadIdx.x; t < table_size; t += kThreads)
    s_tab[t] = __ldg(tab + t);

  // 2. geometry: scalar head up to idx's first 16-B boundary, int4 body,
  //    scalar tail (all scalar when idx and out sit differently)
  const bool vec = (((uintptr_t)idx ^ (uintptr_t)out) & 15) == 0;
  const long long mis = (long long)(((uintptr_t)idx & 15) >> 2);
  long long head = !vec ? n : (mis ? 4 - mis : 0);
  if (head > n) head = n;
  const long long n_quads = (n - head) >> 2;
  const long long body_end = head + 4 * n_quads;
  const int4* qidx = reinterpret_cast<const int4*>(idx + head);
  int4* qout = reinterpret_cast<int4*>(out + head);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  const uint64_t policy = evict_first_policy();
  const int4 zero = make_int4(0, 0, 0, 0);

  // 3. the first trip's index loads, in flight while the table arrives
  int4 next[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long q = tid + u * stride;
    next[u] = q < n_quads ? load_once(qidx + q, policy) : zero;
  }
  wait_async_copies();
  __syncthreads();

  uint32_t n_bad = 0;
  for (long long q0 = tid; q0 < n_quads; q0 += kUnroll * stride) {
    int4 cur[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = next[u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + (kUnroll + u) * stride;
      next[u] = q < n_quads ? load_once(qidx + q, policy) : zero;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + u * stride;
      if (q < n_quads) __stcs(qout + q, pick4(s_tab, size, cur[u], n_bad));
    }
  }
  // the scalar head and tail: at most 6 indices (all n when not vec)
  const long long n_scalar = head + (n - body_end);
  for (long long k = tid; k < n_scalar; k += stride) {
    const long long i = k < head ? k : body_end + (k - head);
    out[i] = pick(s_tab, size, __ldg(idx + i), n_bad);
  }

  // 4. finish, in the table's shared memory once every thread is done
  __syncthreads();
  finish_count(n_bad, reinterpret_cast<uint32_t*>(s_raw), scratch, bad);
}

}  // namespace

// Plain C entry point for ctypes.  `out` holds n int32 and should start at
// the same offset from a 16-B boundary as `idx` (else every index runs
// scalar); `bad` (one int32) is written by the kernel.  `scratch` (one
// int64) must be zero and is zero again when the kernel ends, so launches
// that share it must run in turn (one scratch per stream).  `sm_count` is
// the card's multiprocessor count: blocks = min(one per SM, one per 1024
// int4s), each with max(table_size, 32) * 4 bytes of shared memory.  The
// kernel runs on `stream` and is not synchronised; the return value is
// cudaGetLastError() right after the launch (0 = launched).
extern "C" int table_gather_launch(const void* tab, long long table_size,
                                   const void* idx, long long n, void* out,
                                   void* scratch, void* bad, int sm_count,
                                   void* stream) {
  if (n <= 0 || n >= kMaxRows || table_size <= 0 ||
      table_size > kMaxTable || sm_count <= 0)
    return (int)cudaErrorInvalidValue;
  const long long wanted = (n / 4 + kThreads - 1) / kThreads;
  const long long cap =
      sm_count < kMaxCountBlocks ? sm_count : kMaxCountBlocks;
  const int blocks = (int)(wanted < 1 ? 1 : wanted < cap ? wanted : cap);
  const long long words = table_size > kWarps ? table_size : kWarps;
  const size_t smem = (size_t)((words + 3) & ~3LL) * 4;
  table_gather_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tab), (int)table_size,
      static_cast<const int32_t*>(idx), n, static_cast<int32_t*>(out),
      static_cast<unsigned long long*>(scratch), static_cast<int32_t*>(bad));
  return (int)cudaGetLastError();
}
