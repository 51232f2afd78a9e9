// Key-to-row probe for unsorted int32 keys, with the value fetches of the
// same join, in one pass: K8, for NVIDIA Hopper (sm_90a).
//
// Has no TPU kernel behind it: the JAX package probes a key-to-row table
// with plain array operations (`duckdb_cubit_tpu/index/pk.py`, `probe`) and
// gathers each build column by row.  The table is given as `entries`: one
// entry of W int32 words a slot, word 0 the row (-1 at an absent slot and at
// a build row that is not live) and words 1 .. n_vals that row's build
// values.  For every probe row i < n it computes
//   in       = mask[i] && 0 <= keys[i] - base < span   (in 64 bits: no key
//              wraps, INT32_MIN and INT32_MAX included)
//   e        = entries[keys[i] - base]
//   row      = in ? e[0] : -1
//   found[i] = row >= 0,  row_out[i] = row
//   out[j][i] = row >= 0 ? e[1 + j] : 0   for each value j < n_vals,
//              written 1, 2 or 4 bytes wide: the build column's own width
// A key outside the table is simply not found: there is nothing to count.
//
// What bounds it on this card: device-memory bytes, and the L2's rate of
// random sectors.  A probe row costs 4 B of key, 1 B of mask, 1 B of
// `found`, 4 B of row and 1-4 B a value.  The entries are read at random
// slots, but the star schemas' key-to-row tables (at most a few MB) live in
// the L2, so each of their sectors crosses device memory about once; what
// is left is one L2 sector a probed key.
//
// Design (as `monotone_gather.cu`, without its order check):
//  - A slot's row and values are one entry of 4, 8, 16 or 32 B, aligned to
//    its size, so a probed key costs one load (two 16-B loads of one 32-B
//    sector at W = 8) and one L2 sector, where separate luts cost 1 +
//    n_vals.  The entry width is a template parameter.
//  - Each thread owns a quad: 4 consecutive keys that start on a 16-B
//    boundary of the keys' memory, read with one 16-B load.  The key index
//    of quad q is 4q - skew, so a view that starts anywhere is read
//    aligned; the wrapper places `found`, `row_out` and every value row so
//    that element `skew` starts a 4 x element-size boundary, so a whole
//    quad is written with one store of 4 elements in each.  The mask's 4
//    bytes are one 4-B load when the mask has the same alignment, else four
//    byte loads.  Partial quads at either end go key by key.
//  - A thread loads the keys and mask of its next quad before it probes the
//    current one, so a key round trip overlaps the entry round trip.
//  - The 4 entry loads of a thread are issued before any result is stored,
//    so they are in flight together; a row outside the table or masked out
//    loads nothing.
//  - The outputs, which this pass never reads, go out as streaming
//    (evict-first) stores, so they do not push the entries out of the L2.
//  - A persistent grid (SMs x resident blocks) walks the quads in
//    grid-stride spans.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWords = 8;
constexpr int kMaxVals = kMaxWords - 1;

// The value rows: row j at p[j], elements bytes[j] wide (1, 2 or 4)
struct Outs {
  void* p[kMaxVals];
  int bytes[kMaxVals];
};

// Value v of row j at element i, at that row's width
__device__ __forceinline__ void store_one(const Outs& o, int j, long long i,
                                          int32_t v) {
  if (o.bytes[j] == 4)
    static_cast<int32_t*>(o.p[j])[i] = v;
  else if (o.bytes[j] == 2)
    static_cast<int16_t*>(o.p[j])[i] = (int16_t)v;
  else
    static_cast<int8_t*>(o.p[j])[i] = (int8_t)v;
}

// Values v[0..3] of row j at elements i0 .. i0 + 3, one aligned streaming
// store at that row's width
__device__ __forceinline__ void store_quad(const Outs& o, int j, long long i0,
                                           const int32_t* v) {
  if (o.bytes[j] == 4) {
    __stcs(reinterpret_cast<int4*>(static_cast<int32_t*>(o.p[j]) + i0),
           make_int4(v[0], v[1], v[2], v[3]));
  } else if (o.bytes[j] == 2) {
    const uint32_t lo = (uint16_t)v[0] | ((uint32_t)(uint16_t)v[1] << 16);
    const uint32_t hi = (uint16_t)v[2] | ((uint32_t)(uint16_t)v[3] << 16);
    __stcs(reinterpret_cast<uint2*>(static_cast<int16_t*>(o.p[j]) + i0),
           make_uint2(lo, hi));
  } else {
    const uint32_t w = (uint8_t)v[0] | ((uint32_t)(uint8_t)v[1] << 8) |
                       ((uint32_t)(uint8_t)v[2] << 16) |
                       ((uint32_t)(uint8_t)v[3] << 24);
    __stcs(reinterpret_cast<unsigned int*>(static_cast<int8_t*>(o.p[j]) + i0),
           w);
  }
}

// Keys and mask bytes i0 .. i0 + 3 of a quad: one 16-B key load when the
// quad lies inside [0, n), else key by key; `m[e]` is the mask of key e, 0
// outside [0, n).
struct Quad {
  int k[4];
  bool m[4];
  bool whole;
};

__device__ __forceinline__ Quad load_quad(const int32_t* __restrict__ keys,
                                          const uint8_t* __restrict__ mask,
                                          long long n, long long i0,
                                          bool mask_word) {
  Quad q;
  q.whole = i0 >= 0 && i0 + 4 <= n;
  if (q.whole) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(keys + i0));
    q.k[0] = v.x; q.k[1] = v.y; q.k[2] = v.z; q.k[3] = v.w;
    if (mask_word) {
      const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(mask + i0));
#pragma unroll
      for (int e = 0; e < 4; ++e) q.m[e] = (w >> (8 * e)) & 0xffu;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) q.m[e] = __ldg(mask + i0 + e) != 0;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool live = i0 + e >= 0 && i0 + e < n;
      q.k[e] = live ? __ldg(keys + i0 + e) : 0;
      q.m[e] = live && __ldg(mask + i0 + e) != 0;
    }
  }
  return q;
}

// The W words of entry `slot`, or the absent entry (-1, zeros) when the key
// is not probed.
template <int W>
struct Entry {
  int32_t w[W];
};

template <int W>
__device__ __forceinline__ Entry<W> load_entry(
    const int32_t* __restrict__ entries, long long slot, bool in) {
  Entry<W> e;
  if (!in) {
    e.w[0] = -1;
#pragma unroll
    for (int j = 1; j < W; ++j) e.w[j] = 0;
    return e;
  }
  const int32_t* p = entries + slot * W;
  if constexpr (W == 1) {
    e.w[0] = __ldg(p);
  } else if constexpr (W == 2) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    e.w[0] = v.x; e.w[1] = v.y;
  } else {
#pragma unroll
    for (int h = 0; h < W / 4; ++h) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p) + h);
      e.w[4 * h] = v.x; e.w[4 * h + 1] = v.y;
      e.w[4 * h + 2] = v.z; e.w[4 * h + 3] = v.w;
    }
  }
  return e;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
pk_probe_kernel(const int32_t* __restrict__ entries, long long span,
                long long base, int n_vals, const int32_t* __restrict__ keys,
                const uint8_t* __restrict__ mask, long long n, int skew,
                long long n_quads, bool mask_word,
                uint8_t* __restrict__ found, int32_t* __restrict__ row_out,
                Outs outs) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;  // quads a sweep
  Quad next = load_quad(keys, mask, n, t * 4 - skew, mask_word);
  for (long long q = t; q < n_quads; q += stride) {
    const long long i0 = q * 4 - skew;  // the quad's first key
    const Quad cur = next;
    next = load_quad(keys, mask, n, i0 + stride * 4, mask_word);
    Entry<W> ent[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long slot = (long long)cur.k[e] - base;
      ent[e] = load_entry<W>(entries, slot,
                             cur.m[e] && slot >= 0 && slot < span);
    }
    if (cur.whole) {
      uint32_t f = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f |= (uint32_t)(ent[e].w[0] >= 0) << (8 * e);
      __stcs(reinterpret_cast<unsigned int*>(found + i0), f);
      __stcs(reinterpret_cast<int4*>(row_out + i0),
             make_int4(ent[0].w[0], ent[1].w[0], ent[2].w[0], ent[3].w[0]));
#pragma unroll
      for (int j = 1; j < W; ++j) {
        if (j > n_vals) break;
        int32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = ent[e].w[0] >= 0 ? ent[e].w[j] : 0;
        store_quad(outs, j - 1, i0, v);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i0 + e < 0 || i0 + e >= n) continue;
        const int32_t row = ent[e].w[0];
        found[i0 + e] = row >= 0;
        row_out[i0 + e] = row;
#pragma unroll
        for (int j = 1; j < W; ++j)
          if (j <= n_vals)
            store_one(outs, j - 1, i0 + e, row >= 0 ? ent[e].w[j] : 0);
      }
    }
  }
}

template <int W>
cudaError_t launch(const int32_t* entries, long long span, long long base,
                   int n_vals, const int32_t* keys, const uint8_t* mask,
                   long long n, int skew, long long n_quads, bool mask_word,
                   uint8_t* found, int32_t* row_out, const Outs& outs,
                   int sm_count, cudaStream_t stream) {
  // resident blocks per SM for this instantiation, asked once
  static int resident = 0;
  if (resident == 0) {
    cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, pk_probe_kernel<W>, kThreads, 0);
    if (rc != cudaSuccess) return rc;
    if (resident < 1) resident = 1;
  }
  const long long wanted = (n_quads + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count * resident;
  const int blocks = (int)(wanted < cap ? wanted : cap);
  pk_probe_kernel<W><<<blocks, kThreads, 0, stream>>>(
      entries, span, base, n_vals, keys, mask, n, skew, n_quads, mask_word,
      found, row_out, outs);
  return cudaGetLastError();
}

// whether an output of element size b is placed as the launcher requires
bool placed(const void* p, int b, int skew) {
  return (reinterpret_cast<uintptr_t>(p) - (uintptr_t)(b * skew)) %
             (uintptr_t)(4 * b) == 0;
}

}  // namespace

// Plain C entry point for ctypes.  `entries` points to `span` entries of
// `words` int32 (1, 2, 4 or 8; the buffer aligned to 4 x words bytes),
// slot 0 holding key `base`: word 0 the row (-1 absent or dead), words 1 ..
// n_vals (n_vals < words) the values; `keys` to n int32 keys and `mask` to
// n bytes (0 = the row is not probed).  Outputs: `found` n bytes (0 / 1),
// `row_out` n int32, and `outs[j]` n values of `bytes[j]` (1, 2 or 4) bytes
// each, for j < n_vals.  With skew the keys' address / 4 modulo 4, each
// output of element size b must lie b x skew bytes past a 4b-byte
// boundary, so that whole quads are aligned in each.  The kernel runs on
// `stream` and is not synchronised; the return value is cudaGetLastError()
// right after the launch (0 = launched).  n must be positive.
extern "C" int pk_probe_launch(const void* entries, int words, long long span,
                               long long base, int n_vals, const void* keys,
                               const void* mask, long long n, void* found,
                               void* row_out, void* const* outs,
                               const int* bytes, int sm_count, void* stream) {
  const uintptr_t kaddr = reinterpret_cast<uintptr_t>(keys);
  const int skew = (int)((kaddr >> 2) & 3u);
  if (n <= 0 || span <= 0 || span >= (1ll << 31) ||
      (words != 1 && words != 2 && words != 4 && words != kMaxWords) ||
      n_vals < 0 || n_vals >= words || sm_count < 1 || (kaddr & 3u) != 0 ||
      (reinterpret_cast<uintptr_t>(entries) & (4u * words - 1)) != 0 ||
      !placed(found, 1, skew) || !placed(row_out, 4, skew))
    return (int)cudaErrorInvalidValue;
  Outs o = {};
  for (int j = 0; j < n_vals; ++j) {
    if ((bytes[j] != 1 && bytes[j] != 2 && bytes[j] != 4) ||
        !placed(outs[j], bytes[j], skew))
      return (int)cudaErrorInvalidValue;
    o.p[j] = outs[j];
    o.bytes[j] = bytes[j];
  }
  auto s = static_cast<cudaStream_t>(stream);
  const long long n_quads = (n + skew + 3) / 4;
  // the mask's 4 bytes of a whole quad are one aligned word when the mask
  // starts `skew` bytes past a 4-B boundary, as the keys start skew words
  const bool mask_word =
      (int)(reinterpret_cast<uintptr_t>(mask) & 3u) == skew;
  auto* t = static_cast<const int32_t*>(entries);
  auto* k = static_cast<const int32_t*>(keys);
  auto* m = static_cast<const uint8_t*>(mask);
  auto* f = static_cast<uint8_t*>(found);
  auto* r = static_cast<int32_t*>(row_out);
  cudaError_t rc;
  switch (words) {
    case 1: rc = launch<1>(t, span, base, n_vals, k, m, n, skew, n_quads, mask_word, f, r, o, sm_count, s); break;
    case 2: rc = launch<2>(t, span, base, n_vals, k, m, n, skew, n_quads, mask_word, f, r, o, sm_count, s); break;
    case 4: rc = launch<4>(t, span, base, n_vals, k, m, n, skew, n_quads, mask_word, f, r, o, sm_count, s); break;
    default: rc = launch<8>(t, span, base, n_vals, k, m, n, skew, n_quads, mask_word, f, r, o, sm_count, s); break;
  }
  return (int)rc;
}
