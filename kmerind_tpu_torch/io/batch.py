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

__all__ = ["ReadBatch"]


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

    def iter_chunks(self, chunk_bases: int, halo: int):
        """Yield base-stream chunks of ~chunk_bases with `halo` lookahead;
        window ownership masks guarantee each window appears exactly once.

        Every chunk is padded to the SAME static length (chunk_bases +
        halo), so every chunk of every file has one shape — bounded device
        memory for arbitrarily large inputs.
        """
        n = self.num_bases
        start = 0
        while start < n:
            stop = min(n, start + chunk_bases)
            sub = self.slice_bases(start, min(n, stop + halo)).pad_to(
                chunk_bases + halo)
            owned = sub.owned.copy()
            owned[stop - start:] = False
            yield dataclasses.replace(sub, owned=owned)
            start = stop
