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
// Design:
//  - A warp step covers 512 rows, 16 a lane.  Each lane loads 16 B of mask
//    (rows 16 lane .. + 15 of the step: one coalesced 512-B span a warp)
//    and four int4 each of `a` and `b`, 9 loads of 16 B.  The payload int4
//    q (0..3) of lane l holds rows 128 q + 4 l .. + 3, so each payload load
//    instruction is one coalesced 512-B span too.
//  - The mask bytes of those rows sit in another lane's 16-B load: group
//    l + 32 q of 4 rows is component l % 4 of lane l / 4 + 8 q's int4.
//    Four __shfl_sync move them: in shuffle k, lane s sends its component
//    (k - s / 8) % 4 and lane l reads lane l / 4 + 8 q', q' = (k - l) % 4,
//    which is exactly the component it needs.  Lane l then takes group q's
//    word from shuffle (q + l) % 4 by a select, so that load instruction q
//    of every lane reads the same 512-B span (loading group q' in
//    instruction k instead would spread each instruction over 16 lines).
//  - The next step's mask is loaded before the current step's payloads, so
//    the payload loads issue at once; with them 4.5 KB a warp are in flight.
//  - A lane whose 4 mask bytes of a group are all zero loads no payload
//    for that group, so sparse masks pay only for the sectors that hold a
//    selected row.
//  - The payload loads carry an L2 evict-first policy, as in
//    q6_words_i32.cu.  It needs the coalesced loads above: in a study
//    with each load instruction spread over 16 lines the policy made the
//    kernel far slower, presumably because lines were evicted between the
//    instructions that share them.
//  - The mask bytes are sign-extended ((int32_t)(int8_t) of each byte): a
//    plain shift-and-mask unpack would turn -1 into 255.
//  - Rows past the last full 512-row step (fewer than 512) run scalar, one
//    row a thread.
//  - A persistent grid: SMs x resident blocks (from the occupancy API).
//  - The product is formed in uint32_t (unsigned arithmetic wraps;
//    multiplication modulo 2**32 is associative, so the order of the two
//    products does not matter).  Both halves accumulate in uint32_t, then
//    warp shuffles, a shared-memory block reduction and one 64-bit
//    atomicAdd per block and half into a scratch word that also counts the
//    blocks, so the last block writes `out` and leaves the scratch zero, as
//    in q6_words_i32.cu.
//  - The 16-B loads need `mask`, `a` and `b` 16-B aligned; the launcher
//    refuses other pointers (the wrapper checks first and raises).

#include "device_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStepRows = 512;   // rows a warp step covers, 16 a lane

// v[i] for i in 0..3 known only at run time, by selects (an index into a
// register array that is not a constant would put the array in memory)
__device__ __forceinline__ uint32_t pick(uint32_t v0, uint32_t v1,
                                         uint32_t v2, uint32_t v3, int i) {
  const uint32_t lo = i & 1 ? v1 : v0;
  const uint32_t hi = i & 1 ? v3 : v2;
  return i & 2 ? hi : lo;
}

// the products of 4 rows, row j multiplied by the signed byte j of `m`
__device__ __forceinline__ void add4(int4 a, int4 b, uint32_t m,
                                     uint32_t& hi, uint32_t& lo) {
  const uint32_t av[4] = {(uint32_t)a.x, (uint32_t)a.y, (uint32_t)a.z,
                          (uint32_t)a.w};
  const uint32_t bv[4] = {(uint32_t)b.x, (uint32_t)b.y, (uint32_t)b.z,
                          (uint32_t)b.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t mj = (uint32_t)(int32_t)(int8_t)(m >> (8 * j));
    const uint32_t prod = av[j] * mj * bv[j];
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
q6_mask8_i32_kernel(const int4* __restrict__ mask,
                    const int4* __restrict__ a, const int4* __restrict__ b,
                    long long n_steps, long long n,
                    unsigned long long* __restrict__ scratch,
                    uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long stride = (long long)gridDim.x * kWarps;
  const int4 zero = make_int4(0, 0, 0, 0);
  const uint64_t policy = evict_first_policy();
  uint32_t hi = 0, lo = 0;
  long long st = (long long)blockIdx.x * kWarps + warp;
  // a step's mask is 32 int4 and each payload 128 int4
  int4 next = st < n_steps ? __ldg(mask + st * 32 + lane) : zero;
  for (; st < n_steps; st += stride) {
    const int4 m = next;
    next = st + stride < n_steps ? __ldg(mask + (st + stride) * 32 + lane)
                                 : zero;
    // shuffle k brings the word of group lane + 32 ((k - lane) % 4)
    uint32_t got[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      got[k] = __shfl_sync(0xffffffffu,
                           pick(m.x, m.y, m.z, m.w, (k - (lane >> 3)) & 3),
                           (lane >> 2) + 8 * ((k - lane) & 3));
    const long long base = st * 128 + lane;
    uint32_t g[4];
    int4 va[4], vb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      g[q] = pick(got[0], got[1], got[2], got[3], (q + lane) & 3);
      va[q] = g[q] ? load_once(a + base + 32 * q, policy) : zero;
      vb[q] = g[q] ? load_once(b + base + 32 * q, policy) : zero;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) add4(va[q], vb[q], g[q], hi, lo);
  }
  // the ragged tail, one row a thread
  const auto* m8 = reinterpret_cast<const int8_t*>(mask);
  const auto* a32 = reinterpret_cast<const int32_t*>(a);
  const auto* b32 = reinterpret_cast<const int32_t*>(b);
  for (long long r = n_steps * kStepRows +
                     (long long)blockIdx.x * kThreads + threadIdx.x;
       r < n; r += (long long)gridDim.x * kThreads) {
    const uint32_t prod = (uint32_t)__ldg(a32 + r) *
                          (uint32_t)(int32_t)__ldg(m8 + r) *
                          (uint32_t)__ldg(b32 + r);
    hi += (uint32_t)((int32_t)prod >> 16);
    lo += prod & 0xFFFFu;
  }
  block_finish(hi, lo, scratch, out);
}

}  // namespace

// Plain C entry point for ctypes.  `out` (two int32) is written by the
// kernel; `scratch` (two int64) must be zero and is zero again when the
// kernel ends, so launches that share it must run in turn (one scratch per
// stream).  `mask` holds n int8, `a` and `b` n int32, each starting 16-B
// aligned.  `sm_count` is the card's multiprocessor count: blocks = min(one
// warp per 512-row step, SMs x resident blocks).  The kernel runs on
// `stream` and is not synchronised; the return value is cudaGetLastError()
// right after the launch (0 = launched).
extern "C" int q6_mask8_i32_launch(const void* mask, const void* a,
                                   const void* b, long long n,
                                   void* scratch, void* out, int sm_count,
                                   void* stream) {
  if (n <= 0 || sm_count < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)mask | (uintptr_t)a | (uintptr_t)b) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  // resident blocks per SM, asked once
  static int resident = 0;
  if (resident == 0) {
    const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, q6_mask8_i32_kernel, kThreads, 0);
    if (rc != cudaSuccess) return (int)rc;
    if (resident < 1) resident = 1;
  }
  const long long n_steps = n / kStepRows;
  // at least one block, for the tail of a mask shorter than one step
  const long long wanted =
      n_steps > kWarps ? (n_steps + kWarps - 1) / kWarps : 1;
  const long long cap = (long long)sm_count * resident;
  const long long most = cap < kMaxBlocks ? cap : kMaxBlocks;
  const int blocks = (int)(wanted < most ? wanted : most);
  q6_mask8_i32_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(mask), static_cast<const int4*>(a),
      static_cast<const int4*>(b), n_steps, n,
      static_cast<unsigned long long*>(scratch), static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
