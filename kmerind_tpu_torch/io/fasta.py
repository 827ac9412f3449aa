"""FASTA parsing — vectorized, host-side.

Rebuild of the reference FASTA stack (src/io/fasta_loader.hpp)
as numpy byte scans.  Both '>' and ';' line starts are header lines
(fasta_loader.hpp:295,305), and a RUN of consecutive header lines is ONE
record header (the mxx::unique collapse on the header flag,
fasta_loader.hpp:318-325): a record starts at a header line whose previous
line is not a header.  Sequence bytes are all non-EOL bytes of non-header
lines; a sequence may span many lines, and k-mer windows legitimately cross
line boundaries (EOLs are simply absent from the code stream, while raw
byte positions are preserved for LongSequenceKmerId).
"""

from __future__ import annotations

import numpy as np

from ..alphabets import Alphabet
from .batch import ReadBatch
from .fastq import _line_table, _ragged_gather

__all__ = ["parse_fasta", "find_fasta_record_start"]

_GT = ord(">")
_SEMI = ord(";")


def find_fasta_record_start(data: np.ndarray, at_parent_start: bool) -> int:
    """Offset of the first record start ('>'/';' header-RUN start) in
    `data`.

    The FASTA analog of fastq.find_record_start.  A header line begins a
    record iff the previous line is not a header (fasta_loader.hpp:318-325
    run collapse); for the first visible line after a partial line the
    previous line's kind is unknowable locally and is assumed non-header
    (callers with boundary context use `parse_fasta(prev_line_is_header=)`
    instead).  Returns len(data) if none.
    """
    data = np.asarray(data, dtype=np.uint8)
    n = data.shape[0]
    if n == 0:
        return 0
    eol = (data == 10) | (data == 13)
    prev_nl = np.empty(n, dtype=bool)
    prev_nl[0] = at_parent_start
    prev_nl[1:] = data[:-1] == 10
    line_start = prev_nl & ~eol
    starts = np.flatnonzero(line_start)
    if starts.size == 0:
        return n
    first = data[starts]
    is_hdr = (first == _GT) | (first == _SEMI)
    prev_hdr = np.empty_like(is_hdr)
    prev_hdr[0] = False
    prev_hdr[1:] = is_hdr[:-1]
    cand = np.flatnonzero(is_hdr & ~prev_hdr)
    return int(starts[cand[0]]) if cand.size else n


def parse_fasta(
    data: np.ndarray,
    alphabet: Alphabet,
    file_offset: int = 0,
    file_id: int = 0,
    seq_index_base: int = 0,
    leading_record_start: int | None = None,
    prev_line_is_header: bool = False,
) -> ReadBatch:
    """Parse a FASTA byte block to a ReadBatch.

    Normally the block starts at a record header.  For block-parallel reads
    a slice may begin mid-record: pass `leading_record_start` (the ABSOLUTE
    file position of the containing record's header-run start) and the
    leading sequence lines are attributed to that record, whose ordinal is
    `seq_index_base` (the reference's distributed header exchange supplies
    the same context, fasta_loader.hpp:202-360).  `prev_line_is_header`
    says whether the line just before the slice is a header line, so a
    header run spanning the slice start is not double-counted.
    """
    data = np.asarray(data, dtype=np.uint8)
    starts, ends = _line_table(data)
    if starts.size == 0:
        return _empty(alphabet)
    first_chars = data[starts]
    is_hdr_line = (first_chars == _GT) | (first_chars == _SEMI)
    if not is_hdr_line[0] and leading_record_start is None:
        raise ValueError("FASTA block does not begin with a header line")
    prev_hdr = np.empty_like(is_hdr_line)
    prev_hdr[0] = prev_line_is_header
    prev_hdr[1:] = is_hdr_line[:-1]
    new_rec = is_hdr_line & ~prev_hdr
    rec_of_line = np.cumsum(new_rec.astype(np.int64)) - 1  # -1 before first
    if leading_record_start is not None:
        rec_of_line = rec_of_line + 1
    is_seq_line = ~is_hdr_line & (rec_of_line >= 0)

    seq_starts = starts[is_seq_line]
    seq_lens = (ends - starts)[is_seq_line]
    seq_rec = rec_of_line[is_seq_line]

    flat, line_seg, _ = _ragged_gather(seq_starts, seq_lens)
    seg = seq_rec[line_seg].astype(np.int32)

    record_start = starts[new_rec].astype(np.int64)
    if leading_record_start is not None:
        record_start = np.concatenate(
            [[leading_record_start - file_offset], record_start])
    nrec = record_start.shape[0]
    codes = alphabet.from_ascii[data[flat]]
    return ReadBatch(
        codes=codes,
        valid=np.ones(codes.shape[0], dtype=bool),
        owned=np.ones(codes.shape[0], dtype=bool),
        seg_id=seg,
        offset_in_record=(flat - record_start[seg]).astype(np.uint32),
        global_pos=(flat + file_offset).astype(np.uint64),
        qual=np.zeros(codes.shape[0], dtype=np.uint8),
        record_start=(record_start + file_offset).astype(np.uint64),
        seq_index=(np.arange(nrec) + seq_index_base).astype(np.uint32),
        file_id=np.full(nrec, file_id, dtype=np.uint16),
        alphabet=alphabet,
    )


def _empty(alphabet: Alphabet) -> ReadBatch:
    z = lambda dt: np.zeros(0, dtype=dt)
    return ReadBatch(
        codes=z(np.uint8), valid=z(bool), owned=z(bool), seg_id=z(np.int32),
        offset_in_record=z(np.uint32), global_pos=z(np.uint64),
        qual=z(np.uint8), record_start=z(np.uint64), seq_index=z(np.uint32),
        file_id=z(np.uint16), alphabet=alphabet,
    )
