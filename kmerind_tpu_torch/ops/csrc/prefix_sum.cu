// K3: inclusive int32 prefix sum, one pass (decoupled look-back).
//
// Replaces kmerind_tpu/ops/pallas_kernels.py::prefix_sum_pallas (:1090;
// kernel body _make_ps_kernel :1049), which index/store.py::_cumsum_i32
// dispatches to (run adoption of weighted runs, run_compact).  Contract
// (ops/kernels.py::prefix_sum_i32_plain is the plain version): out[i] =
// x[0] + ... + x[i], wrapping modulo 2^32 like the JAX package's int32 sums
// (the host code guards the 2^31 bound).
//
// What bounds it on the H100: bytes moved.  The least traffic is one read
// and one write of n int32, 8n bytes (2^28 values: 2^31 bytes, 0.641 ms at
// 3.35 TB/s).  The TPU kernel carries the running total across its
// sequential grid in SMEM and reads and writes each element once; Hopper's
// CTAs run in no order, so the carry travels through device memory instead,
// in one launch that still moves each element once:
//  * tiles: a CTA takes the next tile of kTile = 256 x 32 values from an
//    atomic counter (not blockIdx, so it only ever waits on tiles whose
//    CTAs already run), loads it with coalesced 16-byte streaming loads,
//    transposes it through shared memory (XOR-swizzled 16-byte chunks, no
//    bank conflicts) so each thread scans 32 consecutive values in
//    registers, and scans the thread totals with warp shuffles;
//  * look-back: the tile publishes its aggregate in a 64-bit status word
//    (flag in the high half, uint32 value in the low half, one store);
//    warp 0 then reads the 32 preceding status words at once, spins while
//    any is unset, and with a ballot finds the nearest inclusive prefix and
//    sums the aggregates after it; if there is none it moves 32 tiles
//    back.  It publishes the tile's inclusive prefix.  Status words are
//    stored and loaded as relaxed atomics at device scope: flag and value
//    share one word, so a reader sees both or neither, and nothing else is
//    published through them — a release store would order nothing a reader
//    needs (it cost ~6 % at 2^28 on an H100);
//  * the tile is written back through the same shared-memory transpose
//    with coalesced 16-byte streaming stores (scalar loads and stores on a
//    tail tile or an input or output not 16-byte aligned).
// Tiles of 8192 values halve the look-backs of 4096-value tiles (~13 %
// faster at 2^28); the streaming hints keep the status words in L2.
// The wrapper zeroes the scratch (status words and counter) on the stream
// before the launch.  Arithmetic is uint32, so overflow wraps without
// undefined behaviour.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 32;                 // consecutive values per thread
constexpr int kTile = kThreads * kItems;   // 8192 values
constexpr int kVecs = kItems / 4;          // 16-byte chunks per thread
constexpr int kChunks = kTile / 4;         // 16-byte chunks per tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint64_t kFlagAggregate = 1ull << 32;
constexpr uint64_t kFlagPrefix = 2ull << 32;

// position of 16-byte chunk c in shared memory: XOR inside each aligned
// group of 8 chunks (128 bytes), so both the striped accesses (chunk
// v * kThreads + tid) and the blocked ones (chunk tid * kVecs + v) of 8
// neighbouring threads fall in 8 distinct bank groups
__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 7); }

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

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// exclusive prefix of `tile` from the status words of tiles < tile; run by
// one whole warp, the result valid in every lane
__device__ uint32_t look_back(const uint64_t* status, int64_t tile) {
  const int lane = threadIdx.x & 31;
  uint32_t excl = 0;
  for (int64_t end = tile - 1;; end -= 32) {
    const int64_t idx = end - lane;          // lane 0: the nearest tile
    uint64_t s = idx >= 0 ? load_status(status + idx) : kFlagPrefix;
    while (__any_sync(kFull, (s >> 32) == 0)) {
      if ((s >> 32) == 0) s = load_status(status + idx);
    }
    const unsigned prefix = __ballot_sync(kFull, (s >> 32) == 2);
    const uint32_t v = static_cast<uint32_t>(s);
    if (prefix) {
      const int nearest = __ffs(prefix) - 1;
      return excl + warp_sum(lane <= nearest ? v : 0u);
    }
    excl += warp_sum(v);
  }
}

__global__ void __launch_bounds__(kThreads)
prefix_scan_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                   int64_t n, uint64_t* __restrict__ status,
                   unsigned long long* __restrict__ counter, bool vec) {
  __shared__ uint4 buf[kChunks];
  __shared__ uint32_t warp_excl[kWarps];
  __shared__ int64_t s_tile;
  __shared__ uint32_t s_prefix;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int64_t>(atomicAdd(counter, 1ull));
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * kTile;
  const bool full = vec && base + kTile <= n;
  uint32_t* sbuf = reinterpret_cast<uint32_t*>(buf);

  if (full) {
    const uint4* x4 = reinterpret_cast<const uint4*>(x + base);
#pragma unroll
    for (int v = 0; v < kChunks / kThreads; ++v) {
      const int c = v * kThreads + tid;
      buf[swz(c)] = __ldcs(x4 + c);
    }
  } else {
#pragma unroll
    for (int v = 0; v < kItems; ++v) {
      const int e = v * kThreads + tid;
      const int64_t g = base + e;
      sbuf[swz(e >> 2) * 4 + (e & 3)] = g < n ? x[g] : 0u;
    }
  }
  __syncthreads();

  uint32_t item[kItems];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const uint4 q = buf[swz(tid * kVecs + v)];
    item[4 * v] = q.x;
    item[4 * v + 1] = q.y;
    item[4 * v + 2] = q.z;
    item[4 * v + 3] = q.w;
  }
#pragma unroll
  for (int k = 1; k < kItems; ++k) item[k] += item[k - 1];
  const uint32_t total = item[kItems - 1];
  uint32_t incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_excl[warp] = incl;
  __syncthreads();

  if (warp == 0) {
    const uint32_t wt = lane < kWarps ? warp_excl[lane] : 0u;
    uint32_t wi = wt;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, wi, off);
      if (lane >= off) wi += y;
    }
    if (lane < kWarps) warp_excl[lane] = wi - wt;
    const uint32_t aggregate = __shfl_sync(kFull, wi, kWarps - 1);
    uint32_t prefix = 0;
    if (tile == 0) {
      if (lane == 0) store_status(status, kFlagPrefix | aggregate);
    } else {
      if (lane == 0) store_status(status + tile, kFlagAggregate | aggregate);
      prefix = look_back(status, tile);
      if (lane == 0) store_status(status + tile, kFlagPrefix | (prefix + aggregate));
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();

  const uint32_t add = s_prefix + warp_excl[warp] + (incl - total);
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    buf[swz(tid * kVecs + v)] = make_uint4(item[4 * v] + add, item[4 * v + 1] + add,
                                       item[4 * v + 2] + add, item[4 * v + 3] + add);
  }
  __syncthreads();
  if (full) {
    uint4* o4 = reinterpret_cast<uint4*>(out + base);
#pragma unroll
    for (int v = 0; v < kChunks / kThreads; ++v) {
      const int c = v * kThreads + tid;
      __stcs(o4 + c, buf[swz(c)]);
    }
  } else {
#pragma unroll
    for (int v = 0; v < kItems; ++v) {
      const int e = v * kThreads + tid;
      const int64_t g = base + e;
      if (g < n) out[g] = sbuf[swz(e >> 2) * 4 + (e & 3)];
    }
  }
}

int64_t tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

// scratch size in 64-bit words: one status word per tile, then the counter
extern "C" int64_t kmerind_prefix_sum_scratch_words(int64_t n) {
  return tiles_of(n) + 1;
}

// scratch: kmerind_prefix_sum_scratch_words(n) 64-bit words, zeroed here on
// the stream before the one launch
extern "C" int kmerind_prefix_sum_i32(const int32_t* x, int32_t* out,
                                      int64_t n, int64_t* scratch,
                                      void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = tiles_of(n);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(tiles + 1) * sizeof(int64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  uint64_t* status = reinterpret_cast<uint64_t*>(scratch);
  prefix_scan_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      reinterpret_cast<const uint32_t*>(x), reinterpret_cast<uint32_t*>(out),
      n, status, reinterpret_cast<unsigned long long*>(status + tiles), vec);
  return static_cast<int>(cudaGetLastError());
}
