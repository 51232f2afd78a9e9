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
// SXM; the arithmetic is a few integer ops per row.  To stream at that rate
// the card needs about 20 KB in flight per SM at device-memory latency.
//
// Design:
//  - A warp takes a tile of 32 consecutive words (1024 rows), one per lane,
//    in one coalesced 128-B load, and loads the next tile's words before it
//    works on the current one.  A tile whose words are all zero costs no
//    payload instruction (a ballot skips it).
//  - A warp step covers 4 words, 128 rows: each lane loads 16 B of `a` and
//    16 B of `b` (an int4, 4 rows: rows 128 s + 4 lane .. + 3 of the tile),
//    so each load instruction is one coalesced 512-B span.  The lane's 4
//    bits come from word 4 s + lane / 8 of the tile by __shfl_sync.
//  - kInFlight steps' loads are issued before any of them is used: 8 int4
//    loads, 128 B a lane and 4 KB a warp, so a few resident warps keep well
//    over 20 KB in flight per SM.
//  - A lane whose 4 bits are all zero loads nothing for that step, so
//    sparse words pay only for the sectors that hold a selected row.
//  - The payload loads carry an L2 evict-first policy: read once, they
//    should not evict the L2's other lines.  In a study on an H100 this
//    made a call the size of the L2 (SF1) faster when earlier writes had
//    left the L2 dirty, changed nothing with a clean L2, and made a call
//    ten times the L2 (SF10) a few percent slower.
//  - A persistent grid: SMs x resident blocks (from the occupancy API).
//  - The product is formed in uint32_t (signed overflow is undefined in
//    C++, unsigned wraps); both halves accumulate in uint32_t per thread,
//    then by warp shuffles and a shared-memory block reduction; one 64-bit
//    atomicAdd per block and half into a scratch word that also counts the
//    blocks, so the last block writes `out` and leaves the scratch zero:
//    no memset before the launch, and one atomic round trip at the end (a
//    ticket taken after a fence would cost three).  Addition modulo 2**32
//    does not depend on order, so the result is bit-equal to the TPU
//    grid's sequential carry from run to run.
//  - The 16-B loads need `a` and `b` 16-B aligned; the launcher refuses
//    other pointers (the wrapper checks first and raises).

#include "device_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // words a warp takes at once, one per lane
constexpr int kStepWords = 4;    // words a warp step covers: 4 rows a lane
constexpr int kSteps = kTile / kStepWords;
constexpr int kInFlight = 4;     // steps whose loads are issued together

// lane's word of tile t (0 past the last word)
__device__ __forceinline__ uint32_t tile_word(const uint32_t* words,
                                              long long t, int lane,
                                              long long n_words) {
  const long long w = t * kTile + lane;
  return w < n_words ? __ldg(words + w) : 0u;
}

// the products of 4 rows; row j counts where bit j of `bits` is set
__device__ __forceinline__ void add4(int4 a, int4 b, uint32_t bits,
                                     uint32_t& hi, uint32_t& lo) {
  const uint32_t p[4] = {(uint32_t)a.x * (uint32_t)b.x,
                         (uint32_t)a.y * (uint32_t)b.y,
                         (uint32_t)a.z * (uint32_t)b.z,
                         (uint32_t)a.w * (uint32_t)b.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t prod = p[j] & (0u - ((bits >> j) & 1u));
    hi += (uint32_t)((int32_t)prod >> 16);
    lo += prod & 0xFFFFu;
  }
}

// Each half of the output has a 64-bit scratch word: bits 53..63 count the
// blocks that have added to it, bits 0..52 hold the sum of their partials
// (each below 2**32, so at most kMaxBlocks of them fit).  The block whose
// add completes the count writes that half of `out` (the sum modulo 2**32)
// and zeroes the word for the next launch: one atomic round trip at the
// end, no fence and no memset before the launch.
constexpr int kCountShift = 53;
constexpr int kMaxBlocks = (1 << (64 - kCountShift)) - 1;

__device__ __forceinline__ void finish_half(unsigned long long* acc,
                                            uint32_t part, uint32_t* out) {
  const unsigned long long add = (1ull << kCountShift) + part;
  const unsigned long long total = atomicAdd(acc, add) + add;
  if ((total >> kCountShift) == gridDim.x) {
    *out = (uint32_t)total;
    atomicExch(acc, 0ull);
  }
}

__device__ __forceinline__ void block_finish(uint32_t hi, uint32_t lo,
                                             unsigned long long* scratch,
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
    // lane 0 holds both sums; its two adds are in flight together
    if (lane == 0) {
      finish_half(scratch, hi, out);
      finish_half(scratch + 1, lo, out + 1);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
q6_words_i32_kernel(const uint32_t* __restrict__ words,
                    const int4* __restrict__ a, const int4* __restrict__ b,
                    long long n_words, long long n_tiles,
                    unsigned long long* __restrict__ scratch,
                    uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  // bit offset of the lane's 4 rows in their word
  const int shift = (lane & 7) * 4;
  const uint64_t policy = evict_first_policy();
  uint32_t hi = 0, lo = 0;
  long long t = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  uint32_t next = tile_word(words, t, lane, n_words);
  for (; t < n_tiles; t += stride) {
    const uint32_t word = next;
    next = tile_word(words, t + stride, lane, n_words);
    if (__ballot_sync(0xffffffffu, word != 0u) == 0u) continue;
    // the lane's int4 of step s is int4 base + 32 s (row 4 x that)
    const long long base = t * (kTile * 32 / 4) + lane;
#pragma unroll
    for (int s0 = 0; s0 < kSteps; s0 += kInFlight) {
      int4 va[kInFlight], vb[kInFlight];
      uint32_t bits[kInFlight];
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        const int s = s0 + i;
        bits[i] = (__shfl_sync(0xffffffffu, word,
                               s * kStepWords + (lane >> 3)) >> shift) & 0xFu;
        const long long q = base + 32LL * s;
        const int4 zero = make_int4(0, 0, 0, 0);
        va[i] = bits[i] ? load_once(a + q, policy) : zero;
        vb[i] = bits[i] ? load_once(b + q, policy) : zero;
      }
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) add4(va[i], vb[i], bits[i], hi, lo);
    }
  }
  block_finish(hi, lo, scratch, out);
}

}  // namespace

// Plain C entry point for ctypes.  `out` (two int32) is written by the
// kernel; `scratch` (two int64) must be zero and is zero again when the
// kernel ends, so launches that share it must run in turn (one scratch per
// stream).  `a` and `b` hold 32 * n_words int32 and start 16-B aligned.
// `sm_count` is the card's multiprocessor count: blocks = min(one warp per
// 32-word tile, SMs x resident blocks).  The kernel runs on `stream` and is
// not synchronised; the return value is cudaGetLastError() right after the
// launch (0 = launched).
extern "C" int q6_words_i32_launch(const void* words, const void* a,
                                   const void* b, long long n_words,
                                   void* scratch, void* out, int sm_count,
                                   void* stream) {
  if (n_words <= 0 || sm_count < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)a | (uintptr_t)b) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  // resident blocks per SM, asked once
  static int resident = 0;
  if (resident == 0) {
    const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, q6_words_i32_kernel, kThreads, 0);
    if (rc != cudaSuccess) return (int)rc;
    if (resident < 1) resident = 1;
  }
  const long long n_tiles = (n_words + kTile - 1) / kTile;
  const long long wanted = (n_tiles + kWarps - 1) / kWarps;
  const long long cap = (long long)sm_count * resident;
  const long long most = cap < kMaxBlocks ? cap : kMaxBlocks;
  const int blocks = (int)(wanted < most ? wanted : most);
  q6_words_i32_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int4*>(a),
      static_cast<const int4*>(b), n_words, n_tiles,
      static_cast<unsigned long long*>(scratch), static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
