"""Host-side read batches: the tensor form of parsed sequence files.

This replaces the reference's lazy iterator pipeline (records →
SequencesIterator → per-char k-mer iterators, src/io/sequence_iterator.hpp,
src/io/kmer_parser.hpp) with a flat columnar representation: one entry per
*retained sequence byte* (EOLs stripped, per NotEOL —
src/utils/file_utils.hpp:43-53), aligned across columns, so
the device kernels see dense int8 tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..alphabets import Alphabet

__all__ = ["ReadBatch", "concat_batches"]

_POS40 = np.uint64((1 << 40) - 1)


@dataclasses.dataclass
class ReadBatch:
    """Columnar batch of sequence bases (host-side numpy).

    Per-base columns (length n = number of retained sequence bytes):
      codes: uint8 alphabet codes.
      valid: bool — False marks padding introduced by `pad_to`; a k-mer
        window must consist entirely of valid bases.
      owned: bool — True iff a k-mer window may *start* at this base on this
        shard.  Halo bases (the k-1 overlap duplicated onto the next shard,
        kmer_file_helper.hpp:361) are valid but not owned, so boundary
        windows are emitted exactly once.
      seg_id: int32 — index into the per-record columns.
      offset_in_record: uint32 — raw byte offset of this base from its
        record's first byte (EOL bytes counted, per reference semantics).
      global_pos: uint64 — absolute byte position in the file.
      qual: uint8 — raw phred byte (0 where absent, e.g. FASTA).

    Per-record columns (length r):
      record_start: uint64 — file byte offset of the record's first byte.
      seq_index: uint32 — ordinal of the record in its file.
      file_id: uint16.
    """

    codes: np.ndarray
    valid: np.ndarray
    owned: np.ndarray
    seg_id: np.ndarray
    offset_in_record: np.ndarray
    global_pos: np.ndarray
    qual: np.ndarray
    record_start: np.ndarray
    seq_index: np.ndarray
    file_id: np.ndarray
    alphabet: Alphabet | None = None

    # ------------------------------------------------------------------
    @property
    def num_bases(self) -> int:
        return int(self.codes.shape[0])

    @property
    def num_records(self) -> int:
        return int(self.record_start.shape[0])

    def short_ids(self) -> np.ndarray:
        """uint64[n] ShortSequenceKmerId per base (sequence.hpp:152-156):
        file id << 56 | record start (40 bits) << 16 | offset in the read
        (16 bits, wrapping like the reference's uint16)."""
        if self.num_records == 0:
            return np.zeros(self.num_bases, dtype=np.uint64)
        rs = self.record_start[self.seg_id] & _POS40
        fid = self.file_id[self.seg_id].astype(np.uint64) << np.uint64(56)
        off16 = self.offset_in_record.astype(np.uint64) & np.uint64(0xFFFF)
        return fid | (rs << np.uint64(16)) | off16

    def long_ids(self) -> np.ndarray:
        """uint64[n] LongSequenceKmerId per base (sequence.hpp:253-257):
        file id << 56 | sequence index << 40 | file position (40 bits)."""
        if self.num_records == 0:
            return np.zeros(self.num_bases, dtype=np.uint64)
        fid = self.file_id[self.seg_id].astype(np.uint64) << np.uint64(56)
        sid = self.seq_index[self.seg_id].astype(np.uint64) << np.uint64(40)
        return fid | sid | (self.global_pos & _POS40)

    def ids(self, kind: str) -> np.ndarray:
        """Position ids of `kind` "short" (FASTQ reads) or "long" (FASTA)."""
        if kind == "short":
            return self.short_ids()
        if kind == "long":
            return self.long_ids()
        raise ValueError(f"unknown id kind {kind!r}")

    # ------------------------------------------------------------------
    def pad_to(self, n: int) -> "ReadBatch":
        """Zero-pad per-base columns to length n (valid=False on the pad).

        Padding bases get seg_id = -1 so no window can span real + pad.
        """
        cur = self.num_bases
        if n < cur:
            raise ValueError(f"pad_to({n}) smaller than batch ({cur})")
        if n == cur:
            return self
        pad = n - cur

        def _pad(a, fill=0):
            return np.concatenate([a, np.full((pad,), fill, dtype=a.dtype)])

        return dataclasses.replace(
            self,
            codes=_pad(self.codes),
            valid=_pad(self.valid, False),
            owned=_pad(self.owned, False),
            seg_id=_pad(self.seg_id, -1),
            offset_in_record=_pad(self.offset_in_record),
            global_pos=_pad(self.global_pos),
            qual=_pad(self.qual),
        )

    def slice_bases(self, start: int, stop: int) -> "ReadBatch":
        """View of per-base columns [start, stop); record columns shared."""
        return dataclasses.replace(
            self,
            codes=self.codes[start:stop],
            valid=self.valid[start:stop],
            owned=self.owned[start:stop],
            seg_id=self.seg_id[start:stop],
            offset_in_record=self.offset_in_record[start:stop],
            global_pos=self.global_pos[start:stop],
            qual=self.qual[start:stop],
        )

    def iter_chunks(self, chunk_bases: int, halo: int, halo_left: int = 0):
        """Yield base-stream chunks of ~chunk_bases with `halo` lookahead
        and `halo_left` bases of preceding context (de Bruijn edges need
        1); window ownership masks guarantee each window appears exactly
        once.

        Every chunk is padded to the SAME static length (halo_left +
        chunk_bases + halo), so every chunk of every file has one shape —
        bounded device memory for arbitrarily large inputs.
        """
        n = self.num_bases
        start = 0
        while start < n:
            stop = min(n, start + chunk_bases)
            lo = max(0, start - halo_left)
            sub = self.slice_bases(lo, min(n, stop + halo)).pad_to(
                halo_left + chunk_bases + halo)
            owned = sub.owned.copy()
            owned[:start - lo] = False
            owned[stop - lo:] = False
            yield dataclasses.replace(sub, owned=owned)
            start = stop


def concat_batches(batches: list[ReadBatch]) -> ReadBatch:
    """Concatenate batches (e.g. several files); the valid bases' seg ids
    are re-based onto the concatenated record table."""
    if not batches:
        raise ValueError("no batches")
    seg_offset = 0
    segs = []
    for b in batches:
        seg = b.seg_id.copy()
        seg[b.valid] += seg_offset
        segs.append(seg)
        seg_offset += b.num_records
    cat = lambda f: np.concatenate([getattr(b, f) for b in batches])  # noqa: E731
    return ReadBatch(
        codes=cat("codes"), valid=cat("valid"), owned=cat("owned"),
        seg_id=np.concatenate(segs),
        offset_in_record=cat("offset_in_record"),
        global_pos=cat("global_pos"), qual=cat("qual"),
        record_start=cat("record_start"), seq_index=cat("seq_index"),
        file_id=cat("file_id"), alphabet=batches[0].alphabet)
