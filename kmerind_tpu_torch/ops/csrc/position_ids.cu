// The 64-bit position ids of a chunk's bases, composed on the card.
//
// Replaces no TPU kernel.  The JAX package builds the ids on the host
// (kmerind_tpu/io/batch.py::ReadBatch.short_ids / long_ids) and copies 8
// bytes a base to the device; so did the port, with ~10 numpy passes over
// uint64 arrays a base on its feeding thread.  An id depends on one word of
// its record and on the base's offset in the record, so the host now
// composes one word a record (index/api.py::_IndexBase._pooled_id_table)
// and copies 2 or 4 offset bytes a base; this kernel does the rest.
//
// Contract (ops/kernels.py::position_ids_plain is the plain version): n
// bases, seg int32 [n] (each base's record, < 0 on padding), off [n] (its
// byte offset in the record: uint16 for short ids, the low 16 bits the id
// keeps; uint32 for long ids) and table uint64 [nrec], each record's word
// (short: fid << 56 | (record_start & POS40) << 16; long: fid << 56 |
// seq_index << 40 | (record_start & POS40)).  With w = table[seg]:
//   short: id = w | off
//   long:  id = (w & ~POS40) | ((w + off) & POS40)
// — the long form rests on global_pos == record_start + offset_in_record,
// which every parser keeps.  A base whose seg is < 0 or >= nrec gets 0.
// Out: hi int32 [n] = id >> 32, lo int32 [n] = the low 32 bits.
//
// What bounds it on the H100: bytes.  A base reads 4 (seg) + 2 or 4 (off)
// bytes and writes 8; the table (~75k records, 600 KB a chunk of the pq
// cell) stays in L2.  At the pq cell's chunk (8,388,638 bases, short ids)
// that is ~117 MB, ~0.035 ms at 3.35 TB/s.  One thread takes 4 consecutive
// bases: one 16-byte load of seg, one 8- or 16-byte load of off, 4 table
// gathers, two 16-byte stores.  The last (n % 4) bases and views that are
// not so aligned take a scalar path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint64_t kPos40 = (uint64_t{1} << 40) - 1;

template <bool kLong>
__device__ __forceinline__ uint64_t compose(int32_t s, uint32_t off,
                                            const uint64_t* __restrict__ table,
                                            int64_t nrec) {
  if (s < 0 || s >= nrec) return 0;
  const uint64_t w = __ldg(table + s);
  if (kLong) return (w & ~kPos40) | ((w + off) & kPos40);
  return w | off;
}

// Off: uint16_t (short ids) or uint32_t (long ids); Off4 its 4-wide load
template <bool kLong, typename Off, typename Off4>
__global__ void __launch_bounds__(kThreads)
position_ids_kernel(const int32_t* __restrict__ seg,
                    const Off* __restrict__ off,
                    const uint64_t* __restrict__ table, int64_t nrec,
                    int64_t n, int32_t* __restrict__ hi,
                    int32_t* __restrict__ lo, bool vec) {
  const int64_t i0 =
      4 * (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
  if (i0 >= n) return;
  if (vec && i0 + 4 <= n) {
    const int4 s = *reinterpret_cast<const int4*>(seg + i0);
    const Off4 o = *reinterpret_cast<const Off4*>(off + i0);
    const uint64_t a = compose<kLong>(s.x, o.x, table, nrec);
    const uint64_t b = compose<kLong>(s.y, o.y, table, nrec);
    const uint64_t c = compose<kLong>(s.z, o.z, table, nrec);
    const uint64_t d = compose<kLong>(s.w, o.w, table, nrec);
    *reinterpret_cast<int4*>(hi + i0) = make_int4(
        static_cast<int32_t>(a >> 32), static_cast<int32_t>(b >> 32),
        static_cast<int32_t>(c >> 32), static_cast<int32_t>(d >> 32));
    *reinterpret_cast<int4*>(lo + i0) = make_int4(
        static_cast<int32_t>(a), static_cast<int32_t>(b),
        static_cast<int32_t>(c), static_cast<int32_t>(d));
    return;
  }
  const int64_t end = i0 + 4 < n ? i0 + 4 : n;
  for (int64_t i = i0; i < end; ++i) {
    const uint64_t id = compose<kLong>(seg[i], off[i], table, nrec);
    hi[i] = static_cast<int32_t>(id >> 32);
    lo[i] = static_cast<int32_t>(id);
  }
}

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

}  // namespace

// seg int32 [n]; off uint16 [n] (long_ids 0) or uint32 [n] (long_ids 1);
// table uint64 [nrec]; hi, lo int32 [n].  One launch, n > 0.
extern "C" int kmerind_position_ids(const int32_t* seg, const void* off,
                                    int long_ids, const uint64_t* table,
                                    int64_t nrec, int64_t n, int32_t* hi,
                                    int32_t* lo, void* stream) {
  if (n <= 0 || nrec < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t groups = (n + 3) / 4;
  const unsigned blocks =
      static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  const bool vec = aligned(seg, 16) && aligned(hi, 16) && aligned(lo, 16) &&
                   aligned(off, long_ids ? 16 : 8);
  if (long_ids)
    position_ids_kernel<true, uint32_t, uint4><<<blocks, kThreads, 0, s>>>(
        seg, static_cast<const uint32_t*>(off), table, nrec, n, hi, lo, vec);
  else
    position_ids_kernel<false, uint16_t, ushort4><<<blocks, kThreads, 0, s>>>(
        seg, static_cast<const uint16_t*>(off), table, nrec, n, hi, lo, vec);
  return static_cast<int>(cudaGetLastError());
}
