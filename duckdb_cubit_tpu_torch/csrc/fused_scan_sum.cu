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
// What bounds it on this card: the bytes it must move are the words (1/8 B
// a row) and the 32-B payload sectors that hold a selected row.  Q6 selects
// about 2% of the rows, so about 4 MB at SF1, 1.2 us at 3.35 TB/s.  Two
// things keep it above that on an H100: a fixed cost of launch, zeroing
// and one pass over the words (chip_smoke.py times it with all-zero
// words), and the scattered sectors, which device memory serves far below
// its streaming rate.
//
// Design:
//  - A warp takes a tile of 32 consecutive words, one per lane, in one
//    coalesced 128-B load, and loads the next tile's words (double
//    buffering in registers) before it works on the current one.
//  - A ballot of the nonzero words gives the warp its work list, so a zero
//    word (about half of Q6's) costs no payload instruction at all.  The
//    warp walks the list kGroup words at a time: each word is broadcast by
//    __shfl_sync, each lane loads the payload of its row of that word where
//    the bit is set (32 lanes: one coalesced 128-B row span), and the
//    kGroup loads are issued before any of them is added.  Groups of 8
//    ran faster than 16 or 32 at Q6's density: a group's unused slots
//    still cost their shuffles.
//  - Tile width: 32 words, so the word load is one full 128-B line per
//    warp.  At SF1 that is 5,864 tiles, fewer than the H100's 8,448
//    resident warps: every tile then runs at once in a single wave, and the
//    time is about one word round trip plus a few payload round trips.
//    Narrower tiles would need a second wave for no more bytes in flight;
//    at SF10 (58,600 tiles) the grid-stride loop and the prefetch keep each
//    warp's next words in flight.
//  - A persistent grid: SMs x resident blocks (from the occupancy API).
//  - The bits of the last word past row n - 1 are masked when it is
//    loaded; tiles past the last word load nothing.
//  - Each thread keeps an int64 sum; warp shuffles, a shared-memory block
//    reduction and one 64-bit atomicAdd per block finish it, into an output
//    the launcher zeroes on the stream.  Two's-complement addition is exact
//    and independent of order, so the result is bit-exact from run to run.
//    int64 accumulation makes the TPU kernel's hi/lo split and its split
//    search unnecessary.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // words a warp takes at once, one per lane
constexpr int kGroup = 8;   // nonzero words whose payloads are in flight

// lane's word of tile t (0 past the last word; bits past row n - 1 cleared)
__device__ __forceinline__ uint32_t tile_word(const uint32_t* words,
                                              long long t, int lane,
                                              long long n_words,
                                              uint32_t last_mask) {
  const long long w = t * kTile + lane;
  if (w >= n_words) return 0u;
  const uint32_t word = __ldg(words + w);
  return w == n_words - 1 ? word & last_mask : word;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
fused_scan_sum_kernel(const uint32_t* __restrict__ words,
                      const int32_t* __restrict__ a,
                      const int32_t* __restrict__ b,
                      long long n_words, uint32_t last_mask,
                      long long n_tiles,
                      unsigned long long* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * kWarps;
  long long acc = 0;
  long long t = (long long)blockIdx.x * kWarps + warp;
  uint32_t next = tile_word(words, t, lane, n_words, last_mask);
  for (; t < n_tiles; t += stride) {
    const uint32_t word = next;
    next = tile_word(words, t + stride, lane, n_words, last_mask);
    unsigned todo = __ballot_sync(0xffffffffu, word != 0u);
    // row of this lane in word j of the tile: base + 32 * j
    const long long base = t * (kTile * 32) + lane;
    while (todo) {
      int32_t va[kGroup], vb[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int j = __ffs(todo) - 1;  // -1 once the list is used up
        todo &= todo - 1;
        const uint32_t w = __shfl_sync(0xffffffffu, word, j & 31);
        const bool take = j >= 0 && ((w >> lane) & 1u);
        const long long row = base + 32LL * (j & 31);
        va[g] = take ? __ldg(a + row) : 0;
        vb[g] = (kMode == 1 && take) ? __ldg(b + row) : 0;
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (kMode == 0) {
          acc += va[g];
        } else if (kMode == 1) {
          acc += (long long)va[g] * vb[g];
        } else {
          // both factors are below 2**24 and 2**8: the product fits 32 bits
          acc += (long long)((uint32_t)(va[g] & 0xFFFFFF) *
                             (uint32_t)((va[g] >> 24) & 0xFF));
        }
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
    if (lane == 0 && acc != 0) atomicAdd(out, (unsigned long long)acc);
  }
}

template <int kMode>
cudaError_t launch(const uint32_t* words, const int32_t* a, const int32_t* b,
                   long long n_words, uint32_t last_mask,
                   unsigned long long* out, int sm_count,
                   cudaStream_t stream) {
  // resident blocks per SM for this instantiation, asked once
  static int resident = 0;
  if (resident == 0) {
    cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, fused_scan_sum_kernel<kMode>, kThreads, 0);
    if (rc != cudaSuccess) return rc;
    if (resident < 1) resident = 1;
  }
  const long long n_tiles = (n_words + kTile - 1) / kTile;
  const long long wanted = (n_tiles + kWarps - 1) / kWarps;
  const long long cap = (long long)sm_count * resident;
  const int blocks = (int)(wanted < cap ? wanted : cap);
  fused_scan_sum_kernel<kMode><<<blocks, kThreads, 0, stream>>>(
      words, a, b, n_words, last_mask, n_tiles, out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  `out` (one int64) is zeroed here on
// `stream`; `sm_count` is the card's multiprocessor count, from which the
// launch shape is chosen.  The kernel runs on `stream` and is not
// synchronised; the return value is cudaGetLastError() right after the
// launch (0 = launched).
extern "C" int fused_scan_sum_launch(const void* words, const void* a,
                                     const void* b, long long n, int mode,
                                     void* out, int sm_count, void* stream) {
  if (n < 0 || mode < 0 || mode > 2 || sm_count < 1)
    return (int)cudaErrorInvalidValue;
  auto* o = static_cast<unsigned long long*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(o, 0, sizeof(unsigned long long), s);
  if (rc != cudaSuccess || n == 0) return (int)rc;
  const long long n_words = (n + 31) / 32;
  const uint32_t last_mask = (n & 31) ? (1u << (n & 31)) - 1u : 0xffffffffu;
  auto* w = static_cast<const uint32_t*>(words);
  auto* pa = static_cast<const int32_t*>(a);
  auto* pb = static_cast<const int32_t*>(b);
  if (mode == 0)
    rc = launch<0>(w, pa, pb, n_words, last_mask, o, sm_count, s);
  else if (mode == 1)
    rc = launch<1>(w, pa, pb, n_words, last_mask, o, sm_count, s);
  else
    rc = launch<2>(w, pa, pb, n_words, last_mask, o, sm_count, s);
  return (int)rc;
}
