// SQL LIKE over every entry of a string dictionary (K6), for NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package evaluates LIKE on the host, one
// Python regex match per dictionary entry, and so did the port until this
// kernel.  That walk was 64% of the host time of a TPC-H power stream at
// SF1 (q13 matches 1.5M o_comment entries on every run), with the card
// idle throughout.  Here the card matches the pattern against a device copy
// of the dictionary and writes the truth table that the rows' codes gather.
//
// Input: n entries of w bytes, back to back (a numpy `|S<w>` array viewed
// as bytes).  An entry's length is its last nonzero byte + 1, as numpy
// strips trailing NULs.  The pattern comes split at `%` into segments
// (`ops/dict_like.py`): each segment's bytes, with a wildcard flag per byte
// for `_`, and two anchor flags (the first segment starts the entry, the
// last one ends it).  Output: out[i] = 1 where entry i matches, else 0.
//
// Matching: an anchored first segment sits at 0 and an anchored last one at
// len - seglen, without overlapping; each middle segment takes its leftmost
// match after the previous one.  Every segment has a fixed length (`_` is
// one byte), so the leftmost match leaves the most room for the rest and
// the greedy rule is exact.  A pattern without `%` is one segment anchored
// at both ends: the entry must be that long.
//
// What bounds it on this card: device-memory bytes, n * w read and n
// written (q13: 118.5 MB + 1.5 MB, 0.036 ms at 3.35 TB/s).  The matching
// runs a few instructions per byte position, so the design keeps the
// instructions per position few and the loads behind them wide.
//
// Design:
//  - A block of 256 threads stages a tile of 256 consecutive entries in
//    shared memory.  The tile is one contiguous byte range, so it is copied
//    with 16-B cp.async copies that need no registers; the tile's start is
//    16-B aligned only when 256 * w * blockIdx is, so the copy covers the
//    aligned window around it and moves the partial 16-B chunks at either
//    end byte by byte.  One thread then matches one entry out of shared
//    memory.  Neighbouring threads' entries lie w bytes apart, so their
//    byte reads spread over the 32 banks unless w is a multiple of a large
//    power of two (TPC-H's widths are not).
//  - The thread reads its entry as aligned 32-bit words of shared memory
//    and forms the 4-byte window at each position with a funnel shift: a
//    segment's first four bytes (its wildcards masked out) are tested at 4
//    positions for one shared-memory load, and only a position that passes
//    compares the rest byte by byte.  The entry's length (a scan back over
//    its trailing NULs, word by word) is found only where the pattern needs
//    it: an anchored last segment, a single segment, or a segment with a
//    `_` or a NUL byte.  A segment of other bytes cannot match a trailing
//    NUL, so its leftmost match over the whole width is its leftmost match
//    within the entry.
//  - Tiles are small (20 KB at w = 79) and each block loads one: with
//    eight blocks resident on an SM, the loads of some overlap the
//    matching of others, and no block carries state to the next tile.
//  - The pattern (at most kMaxBytes bytes in kMaxSegments segments) travels
//    by value in the kernel's parameters and is copied to shared memory
//    first: threads at different positions read different pattern bytes,
//    which the parameter bank would serialise.
//  - An entry too wide for a tile in 48 KB of shared memory (w above about
//    180) is matched by its thread straight from device memory.

#include "device_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegments = 64;
constexpr int kMaxBytes = 1024;
constexpr int kSmemLimit = 48 * 1024;
// slack after a tile: the last entry's words are read up to 8 bytes past
// its end
constexpr int kTileSlack = 32;
constexpr int kAnchorStart = 1, kAnchorEnd = 2;
// set by the launcher: the matcher needs each entry's length
constexpr int kNeedsLength = 4;

struct Pattern {
  int n_segs;
  int flags;       // kAnchorStart | kAnchorEnd | kNeedsLength
  int total;       // bytes over all segments
  uint32_t prefix[kMaxSegments];   // a segment's first 4 bytes, byte 0 low
  uint32_t mask[kMaxSegments];     // 0xff for each literal byte of them
  uint16_t start[kMaxSegments];
  uint16_t len[kMaxSegments];
  uint8_t bytes[kMaxBytes];
  uint8_t wild[kMaxBytes];   // 1 where the byte is `_`
};

// the pattern's shared-memory bytes: prefixes and masks, the segment table,
// then bytes and wildcards, rounded up so the tile after it starts on a
// 16-B boundary
__host__ __device__ inline int pattern_smem(int total) {
  return (12 * kMaxSegments + 2 * total + 15) & ~15;
}

// the pattern as the matcher reads it, in shared memory
struct Segments {
  const uint32_t* prefix;
  const uint32_t* mask;
  const uint16_t* start;
  const uint16_t* len;
  const uint8_t* bytes;
  const uint8_t* wild;
  int n, flags;
};

// An entry in shared memory: its byte i is byte (off + i) of the aligned
// words from `words`.
struct SharedEntry {
  const uint32_t* words;
  int off;
  __device__ __forceinline__ uint32_t word(int k) const { return words[k]; }
};

// An entry in device memory, too wide for a tile: word k holds its bytes
// 4k..4k+3, bytes past its width read as 0.
struct GlobalEntry {
  const uint8_t* e;
  int w;
  static constexpr int off = 0;
  __device__ __forceinline__ uint32_t word(int k) const {
    uint32_t v = 0;
    for (int j = 3; j >= 0; --j) {
      const int i = 4 * k + j;
      v = (v << 8) | (i < w ? __ldg(e + i) : 0u);
    }
    return v;
  }
};

// bytes i..i+3 of the entry, byte i in the low 8 bits
template <class Entry>
__device__ __forceinline__ uint32_t window(const Entry& e, int i) {
  const int q = i + e.off;
  return __funnelshift_r(e.word(q >> 2), e.word((q >> 2) + 1), 8 * (q & 3));
}

// the bytes of `v` from byte lo up to (not including) byte hi
__device__ __forceinline__ uint32_t byte_range(uint32_t v, int lo, int hi) {
  const uint32_t top = hi >= 4 ? 0xffffffffu : (1u << (8 * hi)) - 1u;
  return v & top & ~((1u << (8 * lo)) - 1u);
}

// last nonzero byte + 1 of the entry's w bytes
template <class Entry>
__device__ int entry_length(const Entry& e, int w) {
  const int end = w + e.off;
  for (int k = (end - 1) >> 2; k >= 0; --k) {
    const int lo = e.off - 4 * k, hi = end - 4 * k;
    const uint32_t v = byte_range(e.word(k), lo > 0 ? lo : 0, hi);
    if (v) return 4 * k + 4 - (__clz(v) >> 3) - e.off;
  }
  return 0;
}

// whether segment k matches the entry at position p (p + len <= width)
template <class Entry>
__device__ __forceinline__ bool segment_at(const Entry& e, int p,
                                           const Segments& g, int k) {
  if ((window(e, p) & g.mask[k]) != g.prefix[k]) return false;
  const uint8_t* s = g.bytes + g.start[k];
  const uint8_t* wc = g.wild + g.start[k];
  for (int j = 4; j < g.len[k]; ++j) {
    if (wc[j]) continue;
    const int q = p + j + e.off;
    if ((uint8_t)(e.word(q >> 2) >> (8 * (q & 3))) != s[j]) return false;
  }
  return true;
}

// the leftmost p in [lo, last] where segment k matches, or -1: four
// positions a word, their 4-byte windows tested against the prefix at once
template <class Entry>
__device__ int leftmost(const Entry& e, int lo, int last, const Segments& g,
                        int k) {
  if (lo > last) return -1;
  const uint32_t prefix = g.prefix[k], mask = g.mask[k];
  const int q_last = last + e.off;
  int q = lo + e.off;
  int word = q >> 2;
  uint32_t w0 = e.word(word);
  uint32_t ok = 0xfu << (q & 3);
  while (4 * word <= q_last) {
    const uint32_t w1 = e.word(word + 1);
    uint32_t hit = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      hit |= (uint32_t)((__funnelshift_r(w0, w1, 8 * b) & mask) == prefix)
             << b;
    const int room = q_last - 4 * word;   // positions b <= room lie in range
    if (room < 3) ok &= (2u << room) - 1u;
    hit &= ok;
    while (hit) {
      const int p = 4 * word + __ffs(hit) - 1 - e.off;
      if (g.len[k] <= 4 || segment_at(e, p, g, k)) return p;
      hit &= hit - 1;
    }
    w0 = w1;
    ++word;
    ok = 0xfu;
  }
  return -1;
}

template <class Entry>
__device__ bool matches(const Entry& e, int w, const Segments& g) {
  const int len = (g.flags & kNeedsLength) ? entry_length(e, w) : w;
  int lo = 0, hi = len, first = 0, last = g.n;
  if ((g.flags & (kAnchorStart | kAnchorEnd)) ==
          (kAnchorStart | kAnchorEnd) && g.n == 1)
    return len == g.len[0] && segment_at(e, 0, g, 0);
  if (g.flags & kAnchorStart) {
    const int L = g.len[0];
    if (L > hi || !segment_at(e, 0, g, 0)) return false;
    lo = L;
    first = 1;
  }
  if (g.flags & kAnchorEnd) {
    const int k = g.n - 1, L = g.len[k];
    if (hi - lo < L || !segment_at(e, hi - L, g, k)) return false;
    hi -= L;
    last = k;
  }
  for (int k = first; k < last; ++k) {
    const int p = leftmost(e, lo, hi - g.len[k], g, k);
    if (p < 0) return false;
    lo = p + g.len[k];
  }
  return true;
}

template <bool kTiled>
__global__ void __launch_bounds__(kThreads)
dict_like_kernel(const uint8_t* __restrict__ dict, long long n, int w,
                 const Pattern pat, uint8_t* __restrict__ out) {
  extern __shared__ int4 s_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(s_raw);
  uint32_t* s_prefix = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_mask = s_prefix + kMaxSegments;
  uint16_t* s_start = reinterpret_cast<uint16_t*>(s_mask + kMaxSegments);
  uint16_t* s_len = s_start + kMaxSegments;
  uint8_t* s_pat = smem + 12 * kMaxSegments;
  uint8_t* s_wild = s_pat + pat.total;
  uint8_t* s_tile = smem + pattern_smem(pat.total);

  const long long first = (long long)blockIdx.x * kThreads;
  const long long rest = n - first;
  const int count = rest < kThreads ? (int)rest : kThreads;
  const uint8_t* src = dict + first * w;
  // the tile's bytes lie at s_tile[pre, pre + count * w): s_tile[0] stands
  // for the 16-B aligned address at or below src
  const int pre = (int)((uintptr_t)src & 15);
  if (kTiled) {
    const uint8_t* base = src - pre;
    const long long end = pre + (long long)count * w;
    const long long c_lo = (pre + 15) >> 4;    // first whole 16-B chunk
    const long long c_hi = end >> 4;           // past the last whole chunk
    for (long long c = c_lo + threadIdx.x; c < c_hi; c += kThreads)
      copy16_async(reinterpret_cast<int32_t*>(s_tile + 16 * c),
                   reinterpret_cast<const int32_t*>(base + 16 * c));
    const long long head_end = 16 * c_lo < end ? 16 * c_lo : end;
    for (long long i = pre + threadIdx.x; i < head_end; i += kThreads)
      s_tile[i] = __ldg(base + i);
    const long long tail = 16 * (c_hi > c_lo ? c_hi : c_lo);
    for (long long i = tail + threadIdx.x; i < end; i += kThreads)
      s_tile[i] = __ldg(base + i);
  }
  for (int i = threadIdx.x; i < pat.total; i += kThreads) {
    s_pat[i] = pat.bytes[i];
    s_wild[i] = pat.wild[i];
  }
  for (int k = threadIdx.x; k < pat.n_segs; k += kThreads) {
    s_prefix[k] = pat.prefix[k];
    s_mask[k] = pat.mask[k];
    s_start[k] = pat.start[k];
    s_len[k] = pat.len[k];
  }
  if (kTiled) wait_async_copies();
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= count) return;
  const Segments g = {s_prefix, s_mask, s_start, s_len, s_pat, s_wild,
                      pat.n_segs, pat.flags};
  bool m;
  if (kTiled) {
    const int at = pre + t * w;
    const SharedEntry e = {reinterpret_cast<const uint32_t*>(s_tile) +
                               (at >> 2),
                           at & 3};
    m = matches(e, w, g);
  } else {
    const GlobalEntry e = {src + (long long)t * w, w};
    m = matches(e, w, g);
  }
  out[first + t] = m;
}

}  // namespace

// Plain C entry point for ctypes.  `dict` holds n entries of w bytes on the
// card; `seg_bytes` and `seg_wild` (host memory) hold the segments' bytes
// and wildcard flags back to back, `seg_len` (host, n_segs int32) their
// lengths, `flags` bit 0 an anchored first segment and bit 1 an anchored
// last one; `out` (n bytes on the card) receives 1 or 0 per entry.  At
// most 64 segments of 1024 bytes in all.  The pattern is copied into the
// launch, so the host buffers may go when this returns.  The kernel runs
// on `stream` and is not synchronised; the return value is
// cudaGetLastError() right after the launch (0 = launched).
extern "C" int dict_like_launch(const void* dict, long long n, int w,
                                const void* seg_bytes, const void* seg_wild,
                                const int32_t* seg_len, int n_segs, int flags,
                                void* out, void* stream) {
  if (n <= 0 || w <= 0 || n_segs < 0 || n_segs > kMaxSegments ||
      flags < 0 || flags > (kAnchorStart | kAnchorEnd) ||
      ((flags & kAnchorStart) && n_segs < 1) ||
      ((flags & kAnchorEnd) && n_segs < 1))
    return (int)cudaErrorInvalidValue;
  Pattern pat;
  pat.n_segs = n_segs;
  // an anchored last segment (a pattern without `%` included) sits at the
  // entry's length
  bool needs_length = (flags & kAnchorEnd) != 0;
  int total = 0;
  for (int k = 0; k < n_segs; ++k) {
    if (seg_len[k] < 0 || total + seg_len[k] > kMaxBytes)
      return (int)cudaErrorInvalidValue;
    pat.start[k] = (uint16_t)total;
    pat.len[k] = (uint16_t)seg_len[k];
    total += seg_len[k];
  }
  pat.total = total;
  const auto* b = static_cast<const uint8_t*>(seg_bytes);
  const auto* wc = static_cast<const uint8_t*>(seg_wild);
  for (int i = 0; i < total; ++i) {
    pat.bytes[i] = b[i];
    pat.wild[i] = wc[i] ? 1 : 0;
    // a `_` or a NUL byte can match a trailing NUL: bound the search by
    // the entry's length
    if (pat.wild[i] || b[i] == 0) needs_length = true;
  }
  for (int k = 0; k < n_segs; ++k) {
    uint32_t prefix = 0, mask = 0;
    for (int j = 0; j < 4 && j < seg_len[k]; ++j) {
      const int i = pat.start[k] + j;
      if (pat.wild[i]) continue;
      prefix |= (uint32_t)pat.bytes[i] << (8 * j);
      mask |= 0xffu << (8 * j);
    }
    pat.prefix[k] = prefix;
    pat.mask[k] = mask;
  }
  pat.flags = flags | (needs_length ? kNeedsLength : 0);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long tile = ((long long)kThreads * w + 16 + kTileSlack + 15) &
                         ~15LL;
  const long long smem = pattern_smem(total) + tile;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(dict);
  auto* o = static_cast<uint8_t*>(out);
  if (smem <= kSmemLimit) {
    // the most of the SM's 256 KB as shared memory, so that eight tiles of
    // 20 KB (w = 79) are resident
    cudaFuncSetAttribute(dict_like_kernel<true>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         (int)cudaSharedmemCarveoutMaxShared);
    dict_like_kernel<true><<<(unsigned)blocks, kThreads, (size_t)smem, s>>>(
        d, n, w, pat, o);
  } else {
    dict_like_kernel<false><<<(unsigned)blocks, kThreads,
                              (size_t)pattern_smem(total), s>>>(
        d, n, w, pat, o);
  }
  return (int)cudaGetLastError();
}
