// Stream compaction of a bool mask into the ascending ids of its set rows
// (K7), for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel, but the sort in `mask_to_indices`
// (duckdb_cubit_tpu/ops/kernels.py:233): the JAX package compacts a mask by
// a stable sort of the inverted mask, because jnp.nonzero's sized lowering
// was slow on the TPU, and the port's plain body keeps that sort.  On the
// card it is a radix sort of (int32 key, int64 index) pairs over every row:
// four onesweep passes of about 24 B a row, some 11.5 GB at 120M rows,
// where the answer needs one read of the mask.
//
// Contract (`ops/compact.py`): for a mask of n bytes (n < 2**31) and a
// capacity, out[capacity] int64 holds the ids of the set rows in ascending
// order, the first `capacity` of them; `count` (int64) is the number of set
// rows, even when it exceeds the capacity; the slots from min(count,
// capacity) to capacity hold n.  A byte is set when it is nonzero.
//
// What bounds it on this card: device-memory bytes, n read and 8 * capacity
// written (SSB's fact table at SF20: 120 MB of mask and 32 MB of ids at
// Q1.1's capacity of 4M slots, 0.045 ms at 3.35 TB/s).  The design reads the
// mask once, in 16-B loads, and writes every slot of `out` once.
//
// Design:
//  - Single pass with decoupled look-back.  A block takes a tile of 16 KB
//    of mask: each of its 8 warps a 2 KB segment, read as 4 rounds of one
//    coalesced 16-B load a lane, all issued before any is used.  The tile's
//    number comes from an atomic counter, so every tile before it has a
//    block running and the look-back below always ends.
//  - A lane turns its 16 bytes into a 16-bit mask with a few integer ops a
//    word (no byte loop), ranks its rows with a popcount and a warp scan of
//    the lanes' counts, and writes each set row's offset in the segment
//    (< 2048, 16 bits) to the warp's part of shared memory at its rank.  A
//    mask that does not start on a 16-B boundary is read from the boundary
//    below it, the bytes before its start cleared; the partial 16 B at its
//    end have their bytes past the end cleared (that load stays within the
//    16-B chunk that holds the last byte).
//  - The warps' counts are scanned in shared memory; the tile publishes
//    its count in its status word (flag "aggregate"), then warp 0 looks
//    back over the 32 tiles before it at a time: each lane waits for its
//    tile's word, and the nearest tile flagged "prefix" (its inclusive
//    count) ends the walk.  The tile then publishes its own inclusive
//    count (flag "prefix").  A status word is flag and count in one 64-bit
//    store, so no fence orders anything.
//  - Each warp then writes its ids from shared memory to `out` at its
//    offset: consecutive lanes write consecutive slots, whatever the
//    density, and only slots below the capacity.  The tile numbered last
//    writes the count.
//  - A second small kernel on the same stream writes n to the slots from
//    min(count, capacity) on, reading the count the first one left: it
//    touches only the padding.  The launcher zeroes the status words (the
//    wrapper allocates them); the kernels allocate nothing.

#include "device_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;                       // 16-B loads a lane
constexpr int kSegBytes = kRounds * 32 * 16;     // a warp's 2 KB
constexpr int kTileBytes = kWarps * kSegBytes;   // a block's 16 KB
constexpr int kFlagShift = 62;
constexpr unsigned long long kAggregate = 1ull << kFlagShift;
constexpr unsigned long long kPrefix = 2ull << kFlagShift;
constexpr unsigned long long kValueMask = (1ull << kFlagShift) - 1;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// bit b set where byte b of the 16 is nonzero
__device__ __forceinline__ uint32_t nonzero_bytes(int4 v) {
  const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                         (uint32_t)v.w};
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // 0x80 in each nonzero byte of the word
    const uint32_t hi =
        (((w[k] & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w[k]) & 0x80808080u;
    // bits 0, 8, 16, 24 times 1 + 2^7 + 2^14 + 2^21: the sixteen shifted
    // copies land on distinct bits (no carries), the flags on bits 21..24
    m |= ((((hi >> 7) * 0x00204081u) >> 21) & 0xfu) << (4 * k);
  }
  return m;
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The set rows of every tile before `tile` (warp 0 of its block): lane l
// reads the status of tile first - l, 32 tiles a step.  A sum of one step
// stays below 2**32: at most one inclusive count (< 2**31) and 31 tile
// counts (<= kTileBytes each).
__device__ long long look_back(const unsigned long long* status, int tile,
                               int lane) {
  long long before = 0;
  for (int first = tile - 1;; first -= 32) {
    const int t = first - lane;
    unsigned long long s = kPrefix;  // before tile 0: an inclusive count 0
    if (t >= 0) {
      do {
        s = peek(status + t);
      } while ((s >> kFlagShift) == 0);
    }
    const unsigned prefix = __ballot_sync(kFull, s >= kPrefix);
    const unsigned value = (unsigned)(s & kValueMask);
    if (prefix) {
      const int stop = __ffs(prefix) - 1;
      return before + __reduce_add_sync(kFull, lane <= stop ? value : 0u);
    }
    before += __reduce_add_sync(kFull, value);
  }
}

// `mask` is the 16-B boundary at or below the mask's start; the mask's
// bytes are [head, span) from there
__global__ void __launch_bounds__(kThreads)
    stream_compact_kernel(const int4* __restrict__ mask, long long span,
                          int head, long long capacity,
                          long long* __restrict__ out,
                          unsigned long long* status,
                          long long* __restrict__ count, int n_tiles) {
  __shared__ uint16_t s_rows[kWarps][kSegBytes];
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile;
  __shared__ long long s_before;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(status + n_tiles, 1ull);
  __syncthreads();
  const int tile = s_tile;
  const long long seg =
      (long long)tile * kTileBytes + (long long)warp * kSegBytes;

  const uint64_t policy = evict_first_policy();
  int4 v[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long at = seg + r * 512 + lane * 16;
    v[r] = at < span ? load_once(mask + at / 16, policy) : make_int4(0, 0, 0, 0);
  }
  int total = 0;  // the warp's set rows in the rounds so far
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long at = seg + r * 512 + lane * 16;
    uint32_t m = nonzero_bytes(v[r]);
    if (at < head) m &= 0xffffu << (head - at);  // only the first 16 B
    if (at + 16 > span) m &= span > at ? (1u << (span - at)) - 1u : 0u;
    const int c = __popc(m);
    const int incl = warp_inclusive_sum(c, lane);
    int pos = total + incl - c;
    const int local = r * 512 + lane * 16;
    while (m) {
      s_rows[warp][pos++] = (uint16_t)(local + __ffs(m) - 1);
      m &= m - 1;
    }
    total += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) s_warp[warp] = total;
  __syncthreads();

  if (warp == 0) {
    const int t = lane < kWarps ? s_warp[lane] : 0;
    const int incl = warp_inclusive_sum(t, lane);
    const int agg = __shfl_sync(kFull, incl, 31);
    if (lane < kWarps) s_warp[lane] = incl - t;  // the warps' offsets
    long long before = 0;
    if (tile > 0) {
      if (lane == 0) publish(status + tile, kAggregate | (unsigned)agg);
      before = look_back(status, tile, lane);
    }
    if (lane == 0) {
      publish(status + tile, kPrefix | (unsigned long long)(before + agg));
      s_before = before;
      if (tile == n_tiles - 1) *count = before + agg;
    }
  }
  __syncthreads();

  const long long base = s_before + s_warp[warp];
  const long long room = capacity - base;
  const int take = room < total ? (int)(room > 0 ? room : 0) : total;
  const long long row0 = seg - head;
  for (int i = lane; i < take; i += 32) out[base + i] = row0 + s_rows[warp][i];
}

// out[i] = n for i in [min(count, capacity), capacity)
__global__ void pad_kernel(long long* __restrict__ out, long long capacity,
                           long long n, const long long* __restrict__ count) {
  const long long c = *count;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (c < capacity ? c : capacity) +
                     (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < capacity; i += step)
    out[i] = n;
}

}  // namespace

// `status` holds `status_words` int64 words (at least the tiles + 1), which
// the launch zeroes; `count` one int64.  Returns cudaGetLastError() after
// the launches.
extern "C" int stream_compact_launch(const void* mask, long long n,
                                     long long capacity, void* out,
                                     void* status, long long status_words,
                                     void* count, int sm_count, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(mask);
  const int head = (int)(addr & 15u);
  const long long span = head + n;
  const long long n_tiles = (span + kTileBytes - 1) / kTileBytes;
  if (n <= 0 || n >= (1ll << 31) || capacity < 0 || sm_count < 1 ||
      status_words < n_tiles + 1 || (capacity > 0 && out == nullptr))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* st = static_cast<unsigned long long*>(status);
  cudaError_t rc = cudaMemsetAsync(st, 0, (n_tiles + 1) * sizeof(*st), s);
  if (rc != cudaSuccess) return (int)rc;
  auto* o = static_cast<long long*>(out);
  auto* c = static_cast<long long*>(count);
  stream_compact_kernel<<<(unsigned)n_tiles, kThreads, 0, s>>>(
      reinterpret_cast<const int4*>(addr - head), span, head, capacity, o, st,
      c, (int)n_tiles);
  rc = cudaGetLastError();
  if (rc != cudaSuccess || capacity == 0) return (int)rc;
  const long long blocks = (capacity + kThreads - 1) / kThreads;
  const long long most = 4ll * sm_count;
  pad_kernel<<<(unsigned)(blocks < most ? blocks : most), kThreads, 0, s>>>(
      o, capacity, n, c);
  return (int)cudaGetLastError();
}
