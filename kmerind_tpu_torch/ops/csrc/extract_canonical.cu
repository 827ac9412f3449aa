// K1: canonical k-mer extraction.
//
// Replaces kmerind_tpu/ops/pallas_kernels.py::extract_canonical_pallas
// (:189; kernel body _make_kernel :103, complement _complement_expr :61).
// Same contract as ops/packing.py::extract_canonical (the plain version):
// at every window start i, the k-mer codes[i:i+k] packed big-endian into
// nwords 32-bit words (kmer.py layout: cpw = 32 / bits chars a word, the
// last word right-aligned), its reverse complement under the alphabet's
// complement table, the lexicographically smaller of the two, and was_rc
// (ties: the forward strand).  Output words are column-major [nwords, n].
// Rows past n-k are garbage; no code past codes[n-1] is read.
//
// What bounds it on the H100: bytes moved.  It reads n code bytes and
// writes n * (4 * nwords + 1) bytes: n * (1 + 4 * nwords + 1) in all (k=21
// DNA, n = 8,388,628: 83,886,280 bytes, 0.0250 ms at 3.35 TB/s).  The
// arithmetic is a few integer operations per window.  Design:
//  * rolling state (extract_rolling_kernel): when k * bits <= 128 a k-mer
//    is one integer V of k * bits bits and its reverse complement another,
//    R; "lexicographically smaller" on equal-width character strings is
//    R < V as integers.  One step right is V = ((V << bits) | c) & mask,
//    R = (R >> bits) | (comp[c] << bits * (k - 1)), and word w of the
//    output is a bit field of min(V, R).  The state is one uint64_t for
//    k * bits <= 64 (DNA k <= 32) and a pair of them up to 128 bits (DNA
//    k <= 64, DNA5/6 k <= 42, DNA16 k <= 32, ASCII k <= 16).  Each thread
//    owns kItems consecutive windows: it rolls in the k - 1 codes before
//    its first window four at a time (one shift of 4 * bits per step), then
//    one code per window, so a window costs about (k - 1) / (4 * kItems)
//    + 1 steps instead of the 2k shared-memory loads of a window packed
//    from scratch.  Codes are read from shared memory four at a time
//    (32-bit words, funnel-shifted to the thread's byte offset);
//  * wide tiles: a CTA stages kTile = kThreads * kItems windows' codes
//    plus the k - 1 halo in shared memory with 16-byte loads of the aligned
//    16-byte chunks that lie inside the codes (byte loads for the partial
//    chunks at either end, so an unaligned view, like a shard of the sorted
//    index, is read in place);
//  * wide, coalesced stores: each thread writes its windows' words four
//    windows at a time (one 16-byte chunk per word column) into shared
//    memory, XOR-swizzled so that these writes and the striped reads after
//    them are free of bank conflicts, then the CTA writes every word column
//    and was_rc with 16-byte stores (4-byte stores for a column whose start
//    w * n * 4 is not 16-byte aligned, and on the last, partial tile).
// tools/sweep_variants.py chose the shape (PERF.md §6; device time per
// call on an H100): 128 threads of 16 windows, one CTA per tile.  A
// grid-stride loop over tiles on as many CTAs as fit (the complement table
// staged once per CTA) measured up to 13 % slower, 256- and 512-thread
// tiles 3-53 % slower on the 128-bit state, 8, 20 and 32 windows a thread
// 3-40 % slower; streaming cache hints and cp.async staging moved it by
// 2 % or less; storing each thread's chunks straight from registers was
// 2.4x slower than the staged stores.
//  * wider k-mers (extract_wide_kernel, k * bits > 128, any k whose tile
//    fits shared memory: DNA k up to ~150,000): packing a window from its
//    k characters costs O(k) a window, and its strand choice a walk of up
//    to k characters with a data-dependent branch.  Instead a CTA stages
//    its kWideTile windows' codes plus the k - 1 halo once (16-byte loads
//    of the aligned chunks inside the codes) and bit-packs them twice into
//    shared memory: the forward stream and the reversed, complemented
//    stream, `bits` bits a character, big-endian.  Both strands of every
//    window are then contiguous in one stream each (the reverse complement
//    of window j starts at character span - k - j of the reversed stream),
//    so every output word is one funnel-shift extraction of nch * bits
//    bits at a bit offset (30-bit words for DNA5/6 included): O(nwords) a
//    window.  The strand choice compares the two strands word by word from
//    word 0 (numeric order of equal-width big-endian words is the
//    characters' order) and stops at the first word that differs, nearly
//    always word 0; equal strands take the forward one.  Windows are
//    striped over the threads (window s * kWideThreads + t, kWideItems of
//    them), so each word column is written with coalesced 4-byte stores: a
//    warp writes 128 whole bytes, and the 16-byte staged stores of the
//    rolling kernels would buy nothing but fewer store instructions.  A
//    thread decides all of its windows' strands first, then stores word
//    column by word column, so a tile writes each column's block at once
//    (window by window: k=1024 22 % slower, the 64 columns' blocks filled
//    a little at a time).
//    tools/sweep_variants.py chose 256 threads of 4 windows (1024-window
//    tiles, k=127: 69.0 -> 74.6 % of the bound); 8 and 16 windows a thread
//    and 128 threads measured 8-18 % slower.
// The wrapper (ops/kernels.py::extract_canonical) picks the kernel by
// k * bits alone.  The complement is a 256-entry table passed by value
// (kernel parameter space) and staged in shared memory: one code path for
// every alphabet (DNA/RNA, DNA5/6, RNA5/6, DNA16, DNA_IUPAC, ASCII).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 16;                  // windows per thread
constexpr int kTile = kThreads * kItems;    // windows per tile
constexpr int kQuads = kItems / 4;          // 16-byte chunks per thread and column
constexpr int kChunks = kTile / 4;          // 16-byte chunks per column and tile
constexpr int kMaxHalo = 63;                // k - 1 of a 128-bit state (bits >= 2)
constexpr int kFront = 16;                  // zero bytes before the tile's codes
// codes: kFront, then the 16-byte chunks from the one holding the tile's
// first code (offset a = its address % 16) to the one holding its last,
// then one more chunk the per-thread 32-bit reads may touch
constexpr int kCodeBytes = kFront + ((15 + kTile + kMaxHalo + 15) / 16) * 16 + 16;
constexpr int kMaxWords64 = 3;              // nwords of a 64-bit state (DNA5 k=21)
constexpr int kMaxWords128 = 5;             // of a 128-bit state (DNA5 k=42)
constexpr int kWideThreads = 256;           // threads of a wide tile
constexpr int kWideItems = 4;               // windows per thread, wide kernel
constexpr int kWideTile = kWideThreads * kWideItems;

static_assert(kItems % 4 == 0, "a thread writes whole 16-byte chunks");
static_assert(kTile % 16 == 0, "tiles keep 16-byte alignment");

struct CompLut {
  uint8_t v[256];
};

// 16-byte chunk c of a staged word column: XOR inside each aligned group of
// 8 chunks (128 bytes), so both the per-thread chunk writes (c = tid *
// kQuads + q) and the striped reads (c = v * kThreads + tid) of 8
// neighbouring threads fall in 8 distinct bank groups
__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 7); }

// ----------------------------------------------------------- state types
struct U64State {
  uint64_t v;
};

struct U128State {
  uint64_t hi, lo;
};

template <typename S>
struct Roll;

template <>
struct Roll<U64State> {
  static constexpr int kMaxWords = kMaxWords64;
  uint64_t mask;   // k * bits low bits
  int bits, rshift, kb;
  __device__ Roll(int kb_, int b)
      : mask(kb_ >= 64 ? ~0ull : (1ull << kb_) - 1), bits(b),
        rshift(kb_ - b), kb(kb_) {}
  __device__ __forceinline__ void step(U64State& f, U64State& r, uint32_t c,
                                       uint32_t cc) const {
    f.v = ((f.v << bits) | c) & mask;
    r.v = (r.v >> bits) | (static_cast<uint64_t>(cc) << rshift);
  }
  // four steps at once: f4 packs the four codes (first most significant),
  // r4 their complements (first least significant), 4 * bits <= 32
  __device__ __forceinline__ void step4(U64State& f, U64State& r, uint32_t f4,
                                        uint32_t r4) const {
    const int s = 4 * bits;
    f.v = ((f.v << s) | f4) & mask;
    r.v = (r.v >> s) | (kb >= s ? static_cast<uint64_t>(r4) << (kb - s)
                                : static_cast<uint64_t>(r4 >> (s - kb)));
  }
  __device__ __forceinline__ static bool less(const U64State& a,
                                              const U64State& b) {
    return a.v < b.v;
  }
  // bits [sh, sh + 32) of x
  __device__ __forceinline__ static uint32_t field(const U64State& x, int sh) {
    return static_cast<uint32_t>(x.v >> sh);
  }
};

template <>
struct Roll<U128State> {
  static constexpr int kMaxWords = kMaxWords128;
  uint64_t mhi, mlo;
  int bits, kb;
  __device__ Roll(int kb_, int b)
      : mhi(kb_ >= 128 ? ~0ull : kb_ > 64 ? (1ull << (kb_ - 64)) - 1 : 0ull),
        mlo(kb_ >= 64 ? ~0ull : (1ull << kb_) - 1),
        bits(b),
        kb(kb_) {}
  // s / bits codes in one step: both strands move by s bits (0 < s <= 32),
  // x enters f's low bits and y r's bits [kb - s, kb)
  __device__ __forceinline__ void shift_in(U128State& f, U128State& r, int s,
                                           uint32_t x, uint32_t y) const {
    f.hi = ((f.hi << s) | (f.lo >> (64 - s))) & mhi;
    f.lo = ((f.lo << s) | x) & mlo;
    r.lo = (r.lo >> s) | (r.hi << (64 - s));
    r.hi >>= s;
    const uint64_t v = y;
    const int at = kb - s;
    if (at >= 64) {
      r.hi |= v << (at - 64);
    } else if (at > 0) {
      r.lo |= v << at;
      r.hi |= v >> (64 - at);
    } else {
      r.lo |= v >> -at;
    }
  }
  __device__ __forceinline__ void step(U128State& f, U128State& r, uint32_t c,
                                       uint32_t cc) const {
    shift_in(f, r, bits, c, cc);
  }
  // four steps at once, as Roll<U64State>::step4
  __device__ __forceinline__ void step4(U128State& f, U128State& r,
                                        uint32_t f4, uint32_t r4) const {
    shift_in(f, r, 4 * bits, f4, r4);
  }
  __device__ __forceinline__ static bool less(const U128State& a,
                                              const U128State& b) {
    return a.hi < b.hi || (a.hi == b.hi && a.lo < b.lo);
  }
  __device__ __forceinline__ static uint32_t field(const U128State& x,
                                                   int sh) {
    if (sh >= 64) return static_cast<uint32_t>(x.hi >> (sh - 64));
    if (sh == 0) return static_cast<uint32_t>(x.lo);
    return static_cast<uint32_t>((x.lo >> sh) | (x.hi << (64 - sh)));
  }
};

// ----------------------------------------------------- rolling kernel
template <typename S>
__global__ void __launch_bounds__(kThreads)
extract_rolling_kernel(const uint8_t* __restrict__ codes, int64_t n,
                       CompLut lut_in, int k, int bits, int cpw, int nwords,
                       uint32_t* __restrict__ words, bool* __restrict__ was_rc) {
  using R = Roll<S>;
  constexpr int kMaxWords = R::kMaxWords;
  extern __shared__ uint4 smem[];
  // layout: staged word columns [nwords][kChunks], was_rc [kTile] bytes,
  // codes [kCodeBytes], complement table [256]
  uint4* sw = smem;
  uint8_t* src = reinterpret_cast<uint8_t*>(smem + nwords * kChunks);
  uint8_t* scodes = src + kTile;
  uint8_t* lut = scodes + kCodeBytes;
  const uint32_t* scodes32 = reinterpret_cast<const uint32_t*>(scodes);
  const int tid = threadIdx.x;

  for (int t = tid; t < 256; t += kThreads) lut[t] = lut_in.v[t];
  if (tid < kFront / 4) reinterpret_cast<uint32_t*>(scodes)[tid] = 0u;

  const R roll(k * bits, bits);
  // field shifts and masks of the output words
  int wsh[kMaxWords];
  uint32_t wmask[kMaxWords];
#pragma unroll
  for (int w = 0; w < kMaxWords; ++w) {
    const int last = k - (nwords - 1) * cpw;
    const int nch = w < nwords - 1 ? cpw : last;
    wsh[w] = w < nwords - 1 ? bits * (k - (w + 1) * cpw) : 0;
    wmask[w] = nch * bits >= 32 ? 0xFFFFFFFFu : (1u << (nch * bits)) - 1u;
  }
  const uintptr_t cp = reinterpret_cast<uintptr_t>(codes);
  const int a = static_cast<int>(cp & 15);           // codes[0] in its chunk
  const uint4* aligned = reinterpret_cast<const uint4*>(cp - a);
  const int span = kTile + k - 1;                    // codes a tile reads
  const int nchunks = (a + span + 15) / 16;
  // the thread's first code read: `warm` >= k - 1 codes (a multiple of 4)
  // before its first window's last code; reads start on the same byte
  // offset of a 32-bit word in every thread (kItems % 4 == 0).  Codes
  // rolled in before the window's first are shifted out of both strands.
  const int warm = (k - 1 + 3) & ~3;
  const int first = kFront + a + tid * kItems + (k - 1) - warm;
  const int off8 = (first & 3) * 8;
  const int word0 = first >> 2;

  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kTile;
  // stage codes[g0 - a, g0 - a + 16 * nchunks): chunk m of the tile is
  // aligned chunk (a + g0) / 16 + m of the code stream
  for (int m = tid; m < nchunks; m += kThreads) {
    const int64_t c0 = g0 + 16 * m - a;            // its first code index
    uint4* dst = reinterpret_cast<uint4*>(scodes + kFront) + m;
    if (c0 >= 0 && c0 + 16 <= n) {
      *dst = __ldg(aligned + (g0 / 16 + m));
    } else {
      uint8_t* d = reinterpret_cast<uint8_t*>(dst);
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const int64_t g = c0 + b;
        d[b] = g >= 0 && g < n ? codes[g] : 0;
      }
    }
  }
  __syncthreads();

  // roll in the warm-up codes, then one code per window
  S f{}, r{};
  uint32_t lo = scodes32[word0];
  int wi = word0 + 1;
  for (int j = 0; j < warm; j += 4) {
    const uint32_t hi = scodes32[wi++];
    const uint32_t g = __funnelshift_r(lo, hi, off8);
    lo = hi;
    uint32_t f4 = 0, r4 = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t c = (g >> (8 * b)) & 0xFFu;
      f4 = (f4 << bits) | c;
      r4 |= static_cast<uint32_t>(lut[c]) << (bits * b);
    }
    roll.step4(f, r, f4, r4);
  }
  uint32_t rc_flags[kQuads];
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const uint32_t hi = scodes32[wi++];
    const uint32_t g = __funnelshift_r(lo, hi, off8);
    lo = hi;
    uint32_t out[kMaxWords][4];
    uint32_t flags = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t c = (g >> (8 * b)) & 0xFFu;
      roll.step(f, r, c, lut[c]);
      const bool use_rc = R::less(r, f);
      const S x = use_rc ? r : f;
#pragma unroll
      for (int w = 0; w < kMaxWords; ++w)
        out[w][b] = R::field(x, wsh[w]) & wmask[w];
      flags |= static_cast<uint32_t>(use_rc) << (8 * b);
    }
    rc_flags[q] = flags;
    const int chunk = swz(tid * kQuads + q);
#pragma unroll
    for (int w = 0; w < kMaxWords; ++w)
      if (w < nwords)
        sw[w * kChunks + chunk] =
            make_uint4(out[w][0], out[w][1], out[w][2], out[w][3]);
  }
  if constexpr (kQuads % 4 == 0) {
#pragma unroll
    for (int v = 0; v < kQuads / 4; ++v)
      reinterpret_cast<uint4*>(src)[tid * (kQuads / 4) + v] = make_uint4(
          rc_flags[4 * v], rc_flags[4 * v + 1], rc_flags[4 * v + 2],
          rc_flags[4 * v + 3]);
  } else if constexpr (kQuads % 2 == 0) {
#pragma unroll
    for (int v = 0; v < kQuads / 2; ++v)
      reinterpret_cast<uint2*>(src)[tid * (kQuads / 2) + v] =
          make_uint2(rc_flags[2 * v], rc_flags[2 * v + 1]);
  } else {
#pragma unroll
    for (int v = 0; v < kQuads; ++v)
      reinterpret_cast<uint32_t*>(src)[tid * kQuads + v] = rc_flags[v];
  }
  __syncthreads();

  // write the tile: 16-byte stores where the column is aligned and the
  // chunk lies inside [0, n), 4-byte (still coalesced) stores elsewhere
  const bool full = g0 + kTile <= n;
  for (int w = 0; w < nwords; ++w) {
    uint32_t* col = words + static_cast<int64_t>(w) * n + g0;
    const uint4* sc = sw + w * kChunks;
    if (full && (reinterpret_cast<uintptr_t>(col) & 15) == 0) {
#pragma unroll
      for (int v = 0; v < kQuads; ++v) {
        const int c = v * kThreads + tid;
        reinterpret_cast<uint4*>(col)[c] = sc[swz(c)];
      }
    } else {
      const uint32_t* s32 = reinterpret_cast<const uint32_t*>(sc);
      for (int e = tid; e < kTile; e += kThreads) {
        if (g0 + e < n) col[e] = s32[swz(e >> 2) * 4 + (e & 3)];
      }
    }
  }
  bool* rc_out = was_rc + g0;
  if (full && (reinterpret_cast<uintptr_t>(rc_out) & 15) == 0) {
    for (int c = tid; c < kTile / 16; c += kThreads)
      reinterpret_cast<uint4*>(rc_out)[c] = reinterpret_cast<const uint4*>(src)[c];
  } else {
    for (int e = tid; e < kTile; e += kThreads)
      if (g0 + e < n) rc_out[e] = src[e] != 0;
  }
}

// ------------------------------------------------------- wide kernel
// shared-memory layout of a wide tile of k-mers: `span` codes (the tile's
// windows plus the halo), staged as `code_bytes`, and two bit streams of
// `swords` words each (one more than the span needs: the funnel shifts
// read a word past the last character)
struct WideShape {
  int span, code_bytes, swords;
};

WideShape wide_shape(int k, int bits) {
  WideShape sh;
  sh.span = kWideTile + k - 1;
  sh.code_bytes = 16 * ((sh.span + 30) / 16);
  sh.swords = (sh.span * bits + 31) / 32 + 1;
  return sh;
}

size_t wide_smem(const WideShape& sh) {
  return static_cast<size_t>(sh.code_bytes) + 8 * static_cast<size_t>(sh.swords) +
         256;
}

// bits [32q, 32q + 32) of the big-endian stream of `bits`-bit characters
// ch(0), ch(1), ...
template <typename Ch>
__device__ __forceinline__ uint32_t stream_word(int q, int bits, const Ch& ch) {
  const int lo = 32 * q;
  const int j0 = lo / bits, j1 = (lo + 31) / bits;
  uint64_t acc = 0;
  for (int j = j0; j <= j1; ++j) acc = (acc << bits) | ch(j);
  return static_cast<uint32_t>(acc >> ((j1 + 1) * bits - lo - 32));
}

// the nbits (<= 32) bits of a stream from character p on, right-aligned
__device__ __forceinline__ uint32_t stream_field(const uint32_t* s, int p,
                                                 int bits, int nbits) {
  const int o = p * bits;
  const uint32_t x = __funnelshift_l(s[(o >> 5) + 1], s[o >> 5], o & 31);
  return x >> (32 - nbits);
}

__global__ void __launch_bounds__(kWideThreads)
extract_wide_kernel(const uint8_t* __restrict__ codes, int64_t n,
                    CompLut lut_in, int k, int bits, int cpw, int nwords,
                    WideShape sh, uint32_t* __restrict__ words,
                    bool* __restrict__ was_rc) {
  extern __shared__ uint4 wsmem[];
  uint8_t* scodes = reinterpret_cast<uint8_t*>(wsmem);
  uint32_t* fwd = reinterpret_cast<uint32_t*>(scodes + sh.code_bytes);
  uint32_t* rev = fwd + sh.swords;
  uint8_t* lut = reinterpret_cast<uint8_t*>(rev + sh.swords);
  const int tid = threadIdx.x;
  const int span = sh.span;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * kWideTile;
  for (int t = tid; t < 256; t += kWideThreads) lut[t] = lut_in.v[t];

  // stage codes [g0, g0 + span) at scodes[a, a + span), a = the codes'
  // address % 16: chunk m is aligned chunk g0 / 16 + m of the code stream
  const uintptr_t cp = reinterpret_cast<uintptr_t>(codes);
  const int a = static_cast<int>(cp & 15);
  const uint4* chunks = reinterpret_cast<const uint4*>(cp - a) + g0 / 16;
  const int nchunks = (a + span + 15) / 16;
  for (int m = tid; m < nchunks; m += kWideThreads) {
    const int64_t c0 = g0 + 16 * m - a;            // its first code index
    if (c0 >= 0 && c0 + 16 <= n) {
      wsmem[m] = __ldg(chunks + m);
    } else {
      uint8_t* d = scodes + 16 * m;
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const int64_t g = c0 + b;
        d[b] = g >= 0 && g < n ? codes[g] : 0;     // zero past the end
      }
    }
  }
  __syncthreads();

  // the forward stream (character j = code g0 + j) and the reversed,
  // complemented one (character j = comp(code g0 + span - 1 - j)); zero
  // past the span
  for (int q = tid; q < sh.swords; q += kWideThreads) {
    fwd[q] = stream_word(q, bits, [&](int j) -> uint32_t {
      return j < span ? scodes[a + j] : 0u;
    });
    rev[q] = stream_word(q, bits, [&](int j) -> uint32_t {
      return j < span ? lut[scodes[a + span - 1 - j]] : 0u;
    });
  }
  __syncthreads();

  const int full_bits = cpw * bits;
  const int last_bits = (k - (nwords - 1) * cpw) * bits;
  int p0s[kWideItems];
  bool rcs[kWideItems];
  for (int s = 0; s < kWideItems; ++s) {
    const int j = s * kWideThreads + tid;          // the window in the tile
    const int64_t i = g0 + j;
    if (i >= n) break;
    const int r0 = span - k - j;                   // its strand in `rev`
    bool use_rc = false;
    for (int w = 0; w < nwords; ++w) {
      const int nb = w < nwords - 1 ? full_bits : last_bits;
      const uint32_t f = stream_field(fwd, j + w * cpw, bits, nb);
      const uint32_t r = stream_field(rev, r0 + w * cpw, bits, nb);
      if (f != r) {
        use_rc = r < f;
        break;
      }
    }
    p0s[s] = use_rc ? r0 : j;
    rcs[s] = use_rc;
    was_rc[i] = use_rc;
  }
  for (int w = 0; w < nwords; ++w) {
    const int nb = w < nwords - 1 ? full_bits : last_bits;
#pragma unroll
    for (int s = 0; s < kWideItems; ++s) {
      const int64_t i = g0 + s * kWideThreads + tid;
      if (i < n)
        words[static_cast<int64_t>(w) * n + i] =
            stream_field(rcs[s] ? rev : fwd, p0s[s] + w * cpw, bits, nb);
    }
  }
}

// launch the wide kernel, one CTA per kWideTile windows; a tile whose
// staged codes and streams pass the device's shared memory is refused
cudaError_t launch_wide(const uint8_t* codes, int64_t n, const CompLut& lut,
                        int k, int bits, int cpw, int nwords, uint32_t* words,
                        bool* was_rc, cudaStream_t stream) {
  const WideShape sh = wide_shape(k, bits);
  const size_t smem = wide_smem(sh);
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(extract_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t tiles = (n + kWideTile - 1) / kWideTile;
  extract_wide_kernel<<<static_cast<unsigned>(tiles), kWideThreads, smem,
                        stream>>>(codes, n, lut, k, bits, cpw, nwords, sh,
                                  words, was_rc);
  return cudaGetLastError();
}

size_t rolling_smem(int nwords) {
  return static_cast<size_t>(nwords) * kChunks * sizeof(uint4) + kTile +
         kCodeBytes + 256;
}

// launch the rolling kernel, one CTA per tile
template <typename S>
cudaError_t launch_rolling(const uint8_t* codes, int64_t n,
                           const CompLut& lut, int k, int bits, int cpw,
                           int nwords, uint32_t* words, bool* was_rc,
                           cudaStream_t stream) {
  constexpr int kMaxWords = Roll<S>::kMaxWords;
  if (nwords > kMaxWords) return cudaErrorInvalidValue;
  // above 48 KB, dynamic shared memory needs the kernel's leave, once per
  // device
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(extract_rolling_kernel<S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(rolling_smem(kMaxWords)));
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  const int64_t tiles = (n + kTile - 1) / kTile;
  extract_rolling_kernel<S><<<static_cast<unsigned>(tiles), kThreads,
                              rolling_smem(nwords), stream>>>(
      codes, n, lut, k, bits, cpw, nwords, words, was_rc);
  return cudaGetLastError();
}

}  // namespace

// windows per tile of the rolling kernels and of the wide kernel (the
// tests size their cases by them)
extern "C" int kmerind_extract_canonical_tile() { return kTile; }
extern "C" int kmerind_extract_wide_tile() { return kWideTile; }

// kernel: 0 = rolling 64-bit state (k * bits <= 64), 1 = rolling 128-bit
// state (k * bits <= 128), 2 = wide (any k); ops/kernels.py::k1_kernel
// picks it from the spec's width
extern "C" int kmerind_extract_canonical(const uint8_t* codes, int64_t n,
                                         const uint8_t* comp_lut_host,
                                         int k, int bits, int cpw,
                                         int nwords, int kernel,
                                         uint32_t* words, bool* was_rc,
                                         void* stream) {
  const int kb = k * bits;
  const bool ok = n > 0 && k >= 1 && bits >= 2 && bits <= 8 &&
                  ((kernel == 0 && kb <= 64) ||
                   (kernel == 1 && kb <= 128) || kernel == 2);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  CompLut lut;
  for (int t = 0; t < 256; ++t) lut.v[t] = comp_lut_host[t];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 0)
    return static_cast<int>(launch_rolling<U64State>(
        codes, n, lut, k, bits, cpw, nwords, words, was_rc, s));
  if (kernel == 1)
    return static_cast<int>(launch_rolling<U128State>(
        codes, n, lut, k, bits, cpw, nwords, words, was_rc, s));
  return static_cast<int>(launch_wide(codes, n, lut, k, bits, cpw, nwords,
                                      words, was_rc, s));
}
