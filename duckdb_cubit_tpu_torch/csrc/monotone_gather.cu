// Monotone direct-address gather over up to 8 luts in one pass (the PK-FK
// join probe and the value fetches of the same join), for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_kernel` built by `_build_call` behind
// `monotone_gather` in duckdb_cubit_tpu/ops/pallas_probe.py.  For every lut
// j < n_luts (all of one length) and key i < n it computes
//   out[j][i] = luts[j][keys[i]]
// for int32 keys that should be non-decreasing and lie in [0, lut_size).
// `overflow` counts the keys that break that precondition: a key outside
// [0, lut_size), or a key smaller than keys[i - 1].  Such a key gets
// out[j][i] = -1 in every output and is counted once, so a caller that
// mislabels a column as sorted sees a non-zero count, never a silent wrong
// row.
//
// What bounds it on this card: device-memory bytes.  A key costs 4 B read
// and 4 B written per lut, plus the lut sectors the sorted keys touch (TPC-H
// order keys fill 8 of every 32 slots, so one 32-B sector per 8 distinct
// keys and lut).  At SF1 that is about 60 MB for the row lut alone, 18 us at
// 3.35 TB/s.
//
// Design:
//  - One pass for a join's row lut and its value luts: the keys are read,
//    checked and counted once, whatever the number of luts.  The lut
//    pointers travel in a struct passed by value; the lut count is a
//    template parameter, so each thread's 4 x n_luts values are registers.
//  - Each thread owns a quad: 4 consecutive keys that start on a 16-B
//    boundary of the keys' memory, read with one 16-B load.  The key index
//    of quad q is 4q - skew, where skew places the first 16-B boundary, so
//    a view that starts anywhere (keys[1:]) is read aligned; the wrapper
//    gives every output row the keys' alignment modulo 16, so whole quads
//    are written with 16-B stores.  The partial quads at either end are read
//    and written key by key.
//  - The predecessor of a quad's first key is the previous lane's last key
//    (__shfl_up_sync); lane 0 reads the one key before its warp's span.  The
//    other three checks run in registers.
//  - A thread loads the keys of its next quad before it gathers for the
//    current one, so a key round trip overlaps the lut round trip.
//  - All 4 x n_luts lut loads of a thread are issued before any result is
//    stored, so they are in flight together.  The outputs, which this pass
//    never reads, go out as streaming (evict-first) stores: with 2 and 4
//    luts, where writes are most of the bytes, that ran clearly faster on
//    an H100 than default stores, which compete with the keys and lut
//    sectors for L2.
//  - A persistent grid (SMs x resident blocks) walks the quads in
//    grid-stride spans of 32 quads per warp.  Each thread counts its bad
//    keys; at the end one warp reduction and at most one atomicAdd per warp
//    add them to `overflow`, which the launcher zeroes on the stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLuts = 8;

struct Luts {
  const int32_t* p[kMaxLuts];
};

// Keys i0 .. i0 + 3 of a quad: one 16-B load when the quad lies inside
// [0, n), else key by key; `live` marks the keys inside [0, n).  `before`
// is key i0 - 1 for lane 0 (its predecessor comes from memory), else 0.
struct Quad {
  int k[4];
  bool live[4];
  bool whole;
  int before;
};

__device__ __forceinline__ Quad load_quad(const int32_t* __restrict__ keys,
                                          long long n, long long i0,
                                          int lane) {
  Quad q;
  q.whole = i0 >= 0 && i0 + 4 <= n;
  if (q.whole) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(keys + i0));
    q.k[0] = v.x; q.k[1] = v.y; q.k[2] = v.z; q.k[3] = v.w;
#pragma unroll
    for (int e = 0; e < 4; ++e) q.live[e] = true;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      q.live[e] = i0 + e >= 0 && i0 + e < n;
      q.k[e] = q.live[e] ? __ldg(keys + i0 + e) : 0;
    }
  }
  q.before = (lane == 0 && i0 > 0 && i0 <= n) ? __ldg(keys + i0 - 1) : 0;
  return q;
}

template <int kLuts>
__global__ void __launch_bounds__(kThreads)
monotone_gather_many_kernel(Luts luts, long long lut_size,
                            const int32_t* __restrict__ keys, long long n,
                            int skew, long long n_quads,
                            int32_t* __restrict__ out, long long out_stride,
                            int32_t* __restrict__ overflow) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long span = (long long)gridDim.x * kThreads;  // quads a sweep
  unsigned bad_keys = 0;
  // the quad of the next sweep is loaded while this one gathers
  Quad next = load_quad(keys, n, (warp * 32 + lane) * 4 - skew, lane);
  for (long long first = warp * 32; first < n_quads; first += span) {
    const long long i0 = (first + lane) * 4 - skew;  // the quad's first key
    const Quad cur = next;
    next = load_quad(keys, n, i0 + span * 4, lane);
    const bool whole = cur.whole;
    const int* k = cur.k;
    const bool* live = cur.live;
    // key i0 - 1: the previous lane's last key, or lane 0's own load
    int before = __shfl_up_sync(0xffffffffu, k[3], 1);
    if (lane == 0) before = cur.before;
    bool ok[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pred = e == 0 ? before : k[e - 1];
      const bool bad = k[e] < 0 || (long long)k[e] >= lut_size ||
                       (i0 + e > 0 && k[e] < pred);
      ok[e] = live[e] && !bad;
      bad_keys += live[e] && bad;
    }
    int32_t v[kLuts][4];
#pragma unroll
    for (int j = 0; j < kLuts; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[j][e] = ok[e] ? __ldg(luts.p[j] + k[e]) : -1;
#pragma unroll
    for (int j = 0; j < kLuts; ++j) {
      int32_t* row = out + j * out_stride;
      if (whole) {
        __stcs(reinterpret_cast<int4*>(row + i0),
               make_int4(v[j][0], v[j][1], v[j][2], v[j][3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (live[e]) row[i0 + e] = v[j][e];
      }
    }
  }
  // every lane of every warp gets here: the loop bounds are warp-uniform
  if (__any_sync(0xffffffffu, bad_keys != 0u)) {
    const unsigned total = __reduce_add_sync(0xffffffffu, bad_keys);
    if (lane == 0) atomicAdd(overflow, (int32_t)total);
  }
}

template <int kLuts>
cudaError_t launch(const Luts& luts, long long lut_size,
                   const int32_t* keys, long long n, int skew,
                   long long n_quads, int32_t* out, long long out_stride,
                   int32_t* overflow, int sm_count, cudaStream_t stream) {
  // resident blocks per SM for this instantiation, asked once
  static int resident = 0;
  if (resident == 0) {
    cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, monotone_gather_many_kernel<kLuts>, kThreads, 0);
    if (rc != cudaSuccess) return rc;
    if (resident < 1) resident = 1;
  }
  const long long wanted = (n_quads + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count * resident;
  const int blocks = (int)(wanted < cap ? wanted : cap);
  monotone_gather_many_kernel<kLuts><<<blocks, kThreads, 0, stream>>>(
      luts, lut_size, keys, n, skew, n_quads, out, out_stride, overflow);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes.  `luts` points to n_luts (1..8) device
// pointers to int32 luts of lut_size entries each; `out` to n_luts rows of n
// int32, row j at out + j * out_stride.  `out` must have the same address
// modulo 16 as `keys`, and out_stride must be a multiple of 4, so that
// whole quads are 16-B aligned in both.  `overflow` (one int32) is zeroed
// here on `stream`.  The kernel runs on `stream` and is not synchronised;
// the return value is cudaGetLastError() right after the launch
// (0 = launched).  n must be positive.
extern "C" int monotone_gather_many_launch(const void* const* luts,
                                           int n_luts, long long lut_size,
                                           const void* keys, long long n,
                                           void* out, long long out_stride,
                                           void* overflow, int sm_count,
                                           void* stream) {
  const uintptr_t kaddr = reinterpret_cast<uintptr_t>(keys);
  if (n <= 0 || lut_size <= 0 || n_luts < 1 || n_luts > kMaxLuts ||
      sm_count < 1 || (kaddr & 3u) != 0 || out_stride < n ||
      (out_stride & 3) != 0 ||
      ((reinterpret_cast<uintptr_t>(out) ^ kaddr) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* ovf = static_cast<int32_t*>(overflow);
  cudaError_t rc = cudaMemsetAsync(ovf, 0, sizeof(int32_t), s);
  if (rc != cudaSuccess) return (int)rc;
  Luts l = {};
  for (int j = 0; j < n_luts; ++j) l.p[j] = static_cast<const int32_t*>(luts[j]);
  const int skew = (int)((kaddr >> 2) & 3u);
  const long long n_quads = (n + skew + 3) / 4;
  auto* k = static_cast<const int32_t*>(keys);
  auto* o = static_cast<int32_t*>(out);
  switch (n_luts) {
    case 1: rc = launch<1>(l, lut_size, k, n, skew, n_quads, o, out_stride, ovf, sm_count, s); break;
    case 2: rc = launch<2>(l, lut_size, k, n, skew, n_quads, o, out_stride, ovf, sm_count, s); break;
    case 3: rc = launch<3>(l, lut_size, k, n, skew, n_quads, o, out_stride, ovf, sm_count, s); break;
    case 4: rc = launch<4>(l, lut_size, k, n, skew, n_quads, o, out_stride, ovf, sm_count, s); break;
    case 5: rc = launch<5>(l, lut_size, k, n, skew, n_quads, o, out_stride, ovf, sm_count, s); break;
    case 6: rc = launch<6>(l, lut_size, k, n, skew, n_quads, o, out_stride, ovf, sm_count, s); break;
    case 7: rc = launch<7>(l, lut_size, k, n, skew, n_quads, o, out_stride, ovf, sm_count, s); break;
    default: rc = launch<8>(l, lut_size, k, n, skew, n_quads, o, out_stride, ovf, sm_count, s); break;
  }
  return (int)rc;
}
