// Bimolecule's representative minimum: each row's key-run minimum, one
// streaming segmented scan (decoupled look-back).
//
// Replaces no TPU kernel.  The JAX package computes it with an associative
// scan and three reversed broadcast scans in XLA
// (kmerind_tpu/index/store.py::_segmented_min_rep); the port did it with an
// int64 cumsum of the head flags, two int64 scatter_reduce "amin" passes and
// three gathers (ops/kernels.py::bimol_min_rep_plain, the plain version).
// The store is sorted by key, so every run is contiguous and the scatters'
// atomics hit one address from neighbouring threads.
//
// Contract: one shard, n rows.  keys uint32 [w, n] column-major, sorted
// lexicographically with duplicates and sentinel padding (any w >= 1);
// weights int32 [n], id halves hi / lo uint32 [n], strand int32 [n].  A row
// is live when its weight is > 0; its key is the unsigned 64-bit id
// hi << 32 | lo, a dead row's is 2^64 - 1.  Each row gets the (key, row)
// minimum of its key run — the smallest key, the first row on a tie — as
// out_hi / out_lo = that key's halves (all ones for a run with no live
// row) and out_strand = the winning row's strand if it is live, else 0.
//
// What bounds it on the H100: bytes.  A row reads its w key words, weight,
// id halves and strand and writes three words: 4w + 28 bytes (36 at w = 2:
// 2^27 rows move 4.8 GB, 1.44 ms at 3.35 TB/s).  The design moves each of
// them once:
//  * tiles: a CTA takes the next tile of kTile = 1024 rows from an atomic
//    counter (it only ever waits on tiles whose CTAs already run), stages
//    each column through shared memory with coalesced loads (one padding
//    word every 32, so both the striped stores and each thread's 8
//    consecutive rows are free of bank conflicts), marks the run heads (a
//    row differing from the one before in any word, the row before the tile
//    read as a halo) and whether the row after the tile begins a run;
//  * in the tile: a thread takes each of its 8 rows' run segment minimum in
//    registers; one forward and one backward segmented scan over the
//    threads (warp shuffles, then the 4 warp totals) give each thread the
//    minimum of the run open at its start and of the run open at its end;
//    so every run that starts and ends in the tile is resolved there;
//  * look-back: the run open at the tile's left edge comes through 64-bit
//    status words (flag, the tile where the run starts, the winning row; a
//    row's key is read back from the inputs, which stay in L2).  A tile
//    with a head publishes its open run's minimum at once — a head resets
//    the scan, so it needs no predecessor; a tile with none publishes its
//    aggregate, then its inclusive value once warp 0 has looked back to
//    the nearest tile with a head.  Status words are relaxed atomics at
//    device scope, as in prefix_sum.cu: flag and value share one word;
//  * the one run open at the tile's right edge, when it goes on into the
//    next tile, is left unwritten; the tile where it ends writes its
//    winning row into a slot of every tile it crossed, and a second launch
//    writes those rows (12 bytes a row, no reads but one row a tile);
//  * outputs leave through shared memory with coalesced stores; the strand
//    of a winner inside the tile comes from a staged column, from global
//    memory (one row a thread) for a winner before it.
// Three launches: a memset of the status words and counter, the scan, the
// fill (not launched when the store is one tile).  No atomics on the data;
// scratch is O(n / kTile); nothing is read back to the host.
// Occupancy sets the rate: the scan holds 8 candidates (96-bit) a thread,
// and uncapped it takes 76 registers, 3 CTAs of 256 threads an SM, 54 % of
// the bound at 2^27 rows; capped at 64 (8 CTAs of 128 threads an SM, no
// spills) it reads 63 % on an H100 (tiles of 256 threads under the same
// cap: 62 %; 4 rows a thread: 43 %; every column staged at once: 52 %).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kItems = 8;                  // consecutive rows per thread
constexpr int kTile = kThreads * kItems;   // 1024 rows
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint64_t kDead = ~0ull;          // a dead row's key
constexpr uint32_t kNoRow = 0xFFFFFFFFu;   // the identity's row (n < 2^31)
constexpr uint64_t kFlagAggregate = 1ull << 62;
constexpr uint64_t kFlagPrefix = 2ull << 62;
constexpr uint64_t kStartMask = (1ull << 30) - 1;

// one padding word every 32
__device__ __forceinline__ int pad(int r) { return r + (r >> 5); }
constexpr int kStage = kTile + 2 + (kTile + 2) / 32 + 1;

// a candidate: (key, row), ordered lexicographically
struct Cand {
  uint64_t key;
  uint32_t row;
};

__device__ __forceinline__ Cand ident() { return Cand{kDead, kNoRow}; }

__device__ __forceinline__ Cand cmin(Cand a, Cand b) {
  return (b.key < a.key || (b.key == a.key && b.row < a.row)) ? b : a;
}

// a segment of threads: f = it holds a run head; c = the minimum over the
// rows the scan carries (see the two combines)
struct Seg {
  bool f;
  Cand c;
};

// forward (a before b): the run open at b's end
__device__ __forceinline__ Seg fwd(Seg a, Seg b) {
  return b.f ? b : Seg{a.f, cmin(a.c, b.c)};
}

// backward (a before b): the run open at a's start
__device__ __forceinline__ Seg bwd(Seg a, Seg b) {
  return a.f ? a : Seg{b.f, cmin(a.c, b.c)};
}

__device__ __forceinline__ Seg shfl_up(Seg v, int off) {
  return Seg{__shfl_up_sync(kFull, static_cast<int>(v.f), off) != 0,
             Cand{__shfl_up_sync(kFull, v.c.key, off),
                  __shfl_up_sync(kFull, v.c.row, off)}};
}

__device__ __forceinline__ Seg shfl_down(Seg v, int off) {
  return Seg{__shfl_down_sync(kFull, static_cast<int>(v.f), off) != 0,
             Cand{__shfl_down_sync(kFull, v.c.key, off),
                  __shfl_down_sync(kFull, v.c.row, off)}};
}

__device__ __forceinline__ Cand warp_min(Cand c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c = cmin(c, Cand{__shfl_xor_sync(kFull, c.key, off),
                     __shfl_xor_sync(kFull, c.row, off)});
  }
  return c;
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

struct Cols {
  const uint32_t* keys;   // [w, n]
  const int32_t* weights;
  const uint32_t* hi;
  const uint32_t* lo;
  const int32_t* strand;
  int w;
  int64_t n;
};

__device__ __forceinline__ uint64_t key_at(const Cols& in, int64_t r) {
  return in.weights[r] > 0
             ? (static_cast<uint64_t>(in.hi[r]) << 32) | in.lo[r]
             : kDead;
}

// the minimum of the run open at the left edge of `tile` over the rows
// before it, and the tile where that run starts; run by one whole warp,
// the result valid in every lane
__device__ void look_back(const uint64_t* status, int64_t tile,
                          const Cols& in, Cand* out, int64_t* start) {
  const int lane = threadIdx.x & 31;
  Cand acc = ident();
  for (int64_t end = tile - 1;; end -= 32) {
    const int64_t idx = end - lane;          // lane 0: the nearest tile
    // tile 0 always publishes a prefix (row 0 is a head), so no lane that
    // counts reads before it
    uint64_t s = idx >= 0 ? load_status(status + idx) : kFlagPrefix;
    while (__any_sync(kFull, (s >> 62) == 0)) {
      if ((s >> 62) == 0) s = load_status(status + idx);
    }
    const unsigned prefix = __ballot_sync(kFull, (s >> 62) == 2);
    const int nearest = prefix ? __ffs(prefix) - 1 : 32;
    Cand c = ident();
    if (lane <= nearest && idx >= 0) {
      const uint32_t row = static_cast<uint32_t>(s);
      c = Cand{key_at(in, row), row};
    }
    acc = cmin(acc, warp_min(c));
    if (prefix) {
      *out = acc;
      *start = static_cast<int64_t>(
          (__shfl_sync(kFull, s, nearest) >> 32) & kStartMask);
      return;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 8)
min_rep_scan_kernel(Cols in, int32_t* __restrict__ out_hi,
                    int32_t* __restrict__ out_lo,
                    int32_t* __restrict__ out_strand,
                    uint64_t* __restrict__ status,
                    unsigned long long* __restrict__ counter,
                    int64_t* __restrict__ open_start,
                    int64_t* __restrict__ final_row) {
  __shared__ uint32_t s[kStage];            // one staged column
  __shared__ int32_t se[kStage];            // strand of live rows, else 0
  __shared__ Seg s_fwd[kWarps], s_bwd[kWarps];
  __shared__ int64_t s_last[kWarps];
  __shared__ int64_t s_tile, s_start;
  __shared__ Cand s_carry;
  __shared__ bool s_next_head, s_first_head;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int64_t>(atomicAdd(counter, 1ull));
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t n = in.n;
  const int64_t base = tile * kTile;
  const int64_t end = base + kTile < n ? base + kTile : n;
  const int r0 = tid * kItems;              // this thread's first row in the tile

  // run heads: bit i = row r0 + i differs from the row before in some word
  // (row 0 and every row past n count as heads)
  unsigned head = 0;
  bool next_head = false;   // the row after the tile differs from its last
  for (int c = 0; c < in.w; ++c) {
    const uint32_t* col = in.keys + static_cast<int64_t>(c) * n;
#pragma unroll
    for (int t = 0; t < kItems; ++t) {
      const int j = t * kThreads + tid;
      const int64_t g = base + j;
      s[pad(1 + j)] = g < n ? col[g] : 0u;
    }
    if (tid == 0) {
      s[pad(0)] = base > 0 ? col[base - 1] : 0u;
      s[pad(kTile + 1)] = base + kTile < n ? col[base + kTile] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      head |= static_cast<unsigned>(s[pad(1 + r0 + i)] != s[pad(r0 + i)])
              << i;
    }
    if (tid == kThreads - 1) next_head |= s[pad(kTile + 1)] != s[pad(kTile)];
    __syncthreads();
  }
  if (base == 0 && tid == 0) head |= 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (base + r0 + i >= n) head |= 1u << i;
  }
  if (tid == kThreads - 1) s_next_head = next_head;
  if (tid == 0) s_first_head = head & 1u;

  // liveness (staged weights) and the strands a winner in the tile reports
  unsigned live = 0;
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const int j = t * kThreads + tid;
    const int64_t g = base + j;
    const int32_t wt = g < n ? in.weights[g] : 0;
    s[pad(j)] = static_cast<uint32_t>(wt);
    se[pad(j)] = wt > 0 ? in.strand[g] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    live |= static_cast<unsigned>(static_cast<int32_t>(s[pad(r0 + i)]) > 0)
            << i;
  }
  __syncthreads();
  uint32_t hi[kItems];
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const int j = t * kThreads + tid;
    const int64_t g = base + j;
    s[pad(j)] = g < n ? in.hi[g] : 0u;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) hi[i] = s[pad(r0 + i)];
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const int j = t * kThreads + tid;
    const int64_t g = base + j;
    s[pad(j)] = g < n ? in.lo[g] : 0u;
  }
  __syncthreads();

  // each row's segment minimum: the rows between heads in this thread —
  // forward, then broadcast back from each segment's last row
  Cand m[kItems];
  Cand acc = ident();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const uint64_t key = ((live >> i) & 1u)
                             ? (static_cast<uint64_t>(hi[i]) << 32) |
                                   s[pad(r0 + i)]
                             : kDead;
    if ((head >> i) & 1u) acc = ident();
    acc = cmin(acc, Cand{key, static_cast<uint32_t>(base + r0 + i)});
    m[i] = acc;
  }
#pragma unroll
  for (int i = kItems - 2; i >= 0; --i) {
    if (!((head >> (i + 1)) & 1u)) m[i] = m[i + 1];
  }
  const bool hh = head != 0;
  // forward element: the segment open at the thread's end; backward: the
  // rows before its first head (none when row r0 is a head)
  const Seg ef{hh, m[kItems - 1]};
  const Seg eb{hh, (head & 1u) ? ident() : m[0]};

  Seg vf = ef, vb = eb;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Seg yf = shfl_up(vf, off);
    const Seg yb = shfl_down(vb, off);
    if (lane >= off) vf = fwd(yf, vf);
    if (lane + off < 32) vb = bwd(vb, yb);
  }
  int64_t last = -1;   // the tile's last head before n
  if (hh) {
    const int i = 31 - __clz(head);
    if (base + r0 + i < n) last = base + r0 + i;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int64_t y = __shfl_xor_sync(kFull, last, off);
    last = y > last ? y : last;
  }
  if (lane == 31) s_fwd[warp] = vf;
  if (lane == 0) {
    s_bwd[warp] = vb;
    s_last[warp] = last;
  }
  // exclusive within the warp
  const Seg lf = shfl_up(vf, 1);
  const Seg lb = shfl_down(vb, 1);
  __syncthreads();

  const Seg none{false, ident()};
  Seg xf = none, yb = none, tile_f = none, tile_b = none;
  int64_t tile_last = -1;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    if (k < warp) xf = fwd(xf, s_fwd[k]);
    tile_f = fwd(tile_f, s_fwd[k]);
    tile_last = s_last[k] > tile_last ? s_last[k] : tile_last;
  }
#pragma unroll
  for (int k = kWarps - 1; k >= 0; --k) {
    if (k > warp) yb = bwd(s_bwd[k], yb);
    tile_b = bwd(s_bwd[k], tile_b);
  }
  if (lane > 0) xf = fwd(xf, lf);          // X: the run open at row r0
  if (lane < 31) yb = bwd(lb, yb);         // Y: the run open after r0 + 7
  const bool first = s_first_head;         // no run crosses the left edge
  const bool has_head = tile_f.f;
  const bool ends = base + kTile >= n || s_next_head;   // ... nor the right

  // publish: a tile with a head its open run's minimum as a prefix, one
  // with none its aggregate; then look back for the run that crosses the
  // left edge
  if (tid == 0) {
    store_status(status + tile,
                 has_head ? kFlagPrefix | (static_cast<uint64_t>(tile) << 32) |
                                tile_f.c.row
                          : kFlagAggregate | tile_f.c.row);
  }
  Cand carry = ident();
  if (!first) {                            // uniform over the block
    if (warp == 0) {
      Cand c;
      int64_t a;
      look_back(status, tile, in, &c, &a);
      if (lane == 0) {
        s_carry = c;
        s_start = a;
        if (!has_head) {
          store_status(status + tile,
                       kFlagPrefix | (static_cast<uint64_t>(a) << 32) |
                           cmin(c, tile_f.c).row);
        }
      }
    }
    __syncthreads();
    carry = s_carry;
  }

  // each row's run minimum: its segment's, with the run before the thread
  // for rows before its first head and the run after it for rows after
  // its last
  const Cand xeff = xf.f ? xf.c : cmin(carry, xf.c);
  uint32_t ohi[kItems], olo[kItems];
  int32_t ost[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    Cand v = m[i];
    if ((head & ((2u << i) - 1u)) == 0) v = cmin(v, xeff);
    if ((head >> (i + 1)) == 0) v = cmin(v, yb.c);
    ohi[i] = static_cast<uint32_t>(v.key >> 32);
    olo[i] = static_cast<uint32_t>(v.key);
    const int64_t d = static_cast<int64_t>(v.row) - base;
    ost[i] = d >= 0 && d < kTile
                 ? se[pad(static_cast<int>(d))]
                 : (in.weights[v.row] > 0 ? in.strand[v.row] : 0);
  }

  // rows [base, lim) are resolved; the rest (the run crossing the right
  // edge) are the fill's
  const int64_t lim = ends ? end : (has_head ? tile_last : base);
  __syncthreads();
  int32_t* outs[3] = {out_hi, out_lo, out_strand};
#pragma unroll
  for (int o = 0; o < 3; ++o) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      s[pad(r0 + i)] = o == 0 ? ohi[i]
                     : o == 1 ? olo[i] : static_cast<uint32_t>(ost[i]);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kItems; ++t) {
      const int j = t * kThreads + tid;
      const int64_t g = base + j;
      if (g < lim) outs[o][g] = static_cast<int32_t>(s[pad(j)]);
    }
    __syncthreads();
  }
  if (tid == 0) open_start[tile] = ends ? -1 : lim;
  // the run crossing the left edge ends here: its winning row for the
  // tiles it crossed
  if (!first && (has_head || ends)) {
    const uint32_t row = cmin(carry, tile_b.c).row;
    for (int64_t x = s_start + tid; x < tile; x += kThreads) {
      final_row[x] = row;
    }
  }
}

// the rows of each run that crosses a tile's right edge: the run's winner,
// from the slot the tile where it ends wrote
__global__ void __launch_bounds__(kThreads)
min_rep_fill_kernel(Cols in, int32_t* __restrict__ out_hi,
                    int32_t* __restrict__ out_lo,
                    int32_t* __restrict__ out_strand,
                    const int64_t* __restrict__ open_start,
                    const int64_t* __restrict__ final_row) {
  const int64_t tile = blockIdx.x;
  const int64_t start = open_start[tile];
  if (start < 0) return;
  const int64_t r = final_row[tile];
  const bool lv = in.weights[r] > 0;
  const int32_t h = lv ? static_cast<int32_t>(in.hi[r]) : -1;
  const int32_t l = lv ? static_cast<int32_t>(in.lo[r]) : -1;
  const int32_t st = lv ? in.strand[r] : 0;
  const int64_t end = (tile + 1) * kTile < in.n ? (tile + 1) * kTile : in.n;
  for (int64_t g = start + threadIdx.x; g < end; g += kThreads) {
    out_hi[g] = h;
    out_lo[g] = l;
    out_strand[g] = st;
  }
}

int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

// scratch size in 64-bit words: a status word a tile, the counter, then a
// tile's open start and its run's winning row
extern "C" int64_t kmerind_bimol_min_rep_scratch_words(int64_t n) {
  return 3 * tiles_of(n) + 1;
}

// keys: w columns of n words ([w, n]); weights, hi, lo, strand and the
// three outputs int32 [n]; scratch: kmerind_bimol_min_rep_scratch_words(n)
// 64-bit words, its status words and counter zeroed here on the stream
extern "C" int kmerind_bimol_min_rep(const int32_t* keys, int w, int64_t n,
                                     const int32_t* weights,
                                     const int32_t* hi, const int32_t* lo,
                                     const int32_t* strand, int32_t* out_hi,
                                     int32_t* out_lo, int32_t* out_strand,
                                     int64_t* scratch, void* stream) {
  if (n <= 0 || n >= (int64_t{1} << 31) || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = tiles_of(n);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(tiles + 1) * sizeof(int64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cols in{reinterpret_cast<const uint32_t*>(keys), weights,
                reinterpret_cast<const uint32_t*>(hi),
                reinterpret_cast<const uint32_t*>(lo), strand, w, n};
  uint64_t* status = reinterpret_cast<uint64_t*>(scratch);
  int64_t* open_start = scratch + tiles + 1;
  int64_t* final_row = open_start + tiles;
  min_rep_scan_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      in, out_hi, out_lo, out_strand, status,
      reinterpret_cast<unsigned long long*>(status + tiles), open_start,
      final_row);
  err = cudaGetLastError();
  // one tile: every run ends in it
  if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
  min_rep_fill_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      in, out_hi, out_lo, out_strand, open_start, final_row);
  return static_cast<int>(cudaGetLastError());
}
