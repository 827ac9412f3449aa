"""FASTQ parsing — vectorized, host-side.

Rebuild of the reference FASTQ stack (src/io/fastq_loader.hpp)
as numpy byte-tensor scans instead of per-char iterators:

* `find_record_start` — the 4-line ``@..+`` / ``+..@`` disambiguation that
  locates the first true record start from an arbitrary byte offset
  (fastq_loader.hpp:199-358; decision table :338-342).
* `parse_fastq` — one vectorized pass over a byte block: newline positions →
  line quadruples → ragged gather of sequence/quality bytes into a flat
  `ReadBatch`.

Records are strictly 4 lines (header '@', sequence, '+', quality), matching
SequentialFASTQParser::get_next_record (fastq_loader.hpp:389-490).
"""

from __future__ import annotations

import numpy as np

from ..alphabets import Alphabet
from .batch import ReadBatch

__all__ = ["find_record_start", "parse_fastq", "parse_fastq_bytes"]

_NL = 10  # \n
_CR = 13  # \r


def _is_eol(b: np.ndarray) -> np.ndarray:
    return (b == _NL) | (b == _CR)


def find_record_start(data: np.ndarray, at_parent_start: bool) -> int:
    """Offset of the first FASTQ record start within `data`.

    Implements the reference algorithm (fastq_loader.hpp:269-358): collect the
    first characters of up to 4 lines (a "line start" is the first non-EOL
    char after an EOL run — or the block start itself when `at_parent_start`),
    then match ``@..+`` (record starts at line 0 or 1) or ``+..@`` (record
    starts at line 2 or 3).  Returns len(data) if no marker pattern fits
    (caller decides whether that is EOF or an error).
    """
    data = np.asarray(data, dtype=np.uint8)
    n = data.shape[0]
    if n == 0:
        return 0
    eol = _is_eol(data)
    # positions whose predecessor is EOL (line starts), excluding EOL chars
    prev_eol = np.empty(n, dtype=bool)
    prev_eol[0] = at_parent_start
    prev_eol[1:] = eol[:-1]
    starts = np.flatnonzero(prev_eol & ~eol)
    if starts.size == 0:
        return n
    first = data[starts[:4]]
    at = ord("@")
    plus = ord("+")
    if first.size >= 3 and first[0] == at and first[2] == plus:
        return int(starts[0])
    if first.size >= 4 and first[1] == at and first[3] == plus:
        return int(starts[1])
    if first.size >= 3 and first[0] == plus and first[2] == at:
        return int(starts[2])
    if first.size >= 4 and first[1] == plus and first[3] == at:
        return int(starts[3])
    return n


def _line_table(data: np.ndarray):
    """(line_start, line_end) arrays over a byte block, skipping blank lines.

    line_end excludes the EOL bytes (and a trailing \\r before \\n).
    """
    n = data.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    eol = _is_eol(data)
    prev_eol = np.empty(n, dtype=bool)
    prev_eol[0] = True
    prev_eol[1:] = eol[:-1]
    starts = np.flatnonzero(prev_eol & ~eol)
    # end of line i = first EOL at/after its start, or n for the last line
    eol_pos = np.flatnonzero(eol)
    if eol_pos.size == 0:
        ends = np.full(starts.shape, n, dtype=np.int64)
    else:
        k = np.searchsorted(eol_pos, starts)
        ends = np.where(k < eol_pos.size, eol_pos[np.minimum(k, eol_pos.size - 1)], n)
    return starts.astype(np.int64), ends.astype(np.int64)


def parse_fastq_bytes(data: np.ndarray):
    """Record table of a FASTQ byte block that begins at a record start.

    Returns dict of int64 arrays: record_start, seq_start, seq_len,
    qual_start (offsets within `data`).  Raises ValueError on malformed
    records (non-'@' header, non-'+' separator, seq/qual length mismatch),
    mirroring the reference's IOException on incomplete records
    (fastq_loader.hpp:441-489).
    """
    data = np.asarray(data, dtype=np.uint8)
    starts, ends = _line_table(data)
    nlines = starts.shape[0]
    if nlines % 4 != 0:
        # empty sequence/quality lines ('@r\n\n+\n\n') are dropped by the
        # fast visible-line table, collapsing the 4-line cycle — re-walk
        # with the exact record state machine (native/reference semantics)
        return _parse_fastq_bytes_exact(data)
    starts4 = starts.reshape(-1, 4)
    ends4 = ends.reshape(-1, 4)
    if nlines and not np.all(data[starts4[:, 0]] == ord("@")):
        return _parse_fastq_bytes_exact(data)
    if nlines and not np.all(data[starts4[:, 2]] == ord("+")):
        return _parse_fastq_bytes_exact(data)
    seq_len = ends4[:, 1] - starts4[:, 1]
    qual_len = ends4[:, 3] - starts4[:, 3]
    if not np.array_equal(seq_len, qual_len):
        bad = int(np.flatnonzero(seq_len != qual_len)[0])
        raise ValueError(
            f"FASTQ record {bad}: sequence length {seq_len[bad]} != quality "
            f"length {qual_len[bad]}")
    return {
        "record_start": starts4[:, 0],
        "seq_start": starts4[:, 1],
        "seq_len": seq_len,
        "qual_start": starts4[:, 3],
    }


def _parse_fastq_bytes_exact(data: np.ndarray):
    """Sequential 4-line record walk, the exact semantics of the native
    scanner (fastscan.cpp fastq_range) and the reference's get_next_record
    (fastq_loader.hpp:389-490): blank lines skip BETWEEN records, empty
    sequence/quality lines are legal record fields.  Fallback for inputs
    the vectorized visible-line table cannot frame."""
    buf = data.tobytes()
    n = len(buf)
    rs, ss, sl, qs = [], [], [], []
    p = 0

    def line(p):
        e = buf.find(b"\n", p)
        raw_end = n if e < 0 else e
        c = raw_end
        while c > p and buf[c - 1] == 0x0D:
            c -= 1
        return c, (raw_end + 1 if e >= 0 else n), raw_end < n

    while p < n:
        while p < n and buf[p] in (0x0A, 0x0D):
            p += 1
        if p >= n:
            break
        rec = p
        if buf[p] != ord("@"):
            raise ValueError(f"FASTQ record {len(rs)} does not start with '@'")
        _, p, had = line(p)
        if not had:
            raise ValueError("truncated FASTQ record (header)")
        seq = p
        seq_end, p, had = line(p)
        if not had:
            raise ValueError("truncated FASTQ record (sequence)")
        if p >= n or buf[p] != ord("+"):
            raise ValueError("FASTQ record separator line does not start "
                             "with '+'")
        _, p, had = line(p)
        if not had:
            raise ValueError("truncated FASTQ record (separator)")
        qual = p
        qual_end, p, _ = line(p)
        if qual_end - qual != seq_end - seq:
            raise ValueError(
                f"FASTQ record {len(rs)}: sequence length {seq_end - seq} "
                f"!= quality length {qual_end - qual}")
        rs.append(rec)
        ss.append(seq)
        sl.append(seq_end - seq)
        qs.append(qual)
    return {
        "record_start": np.asarray(rs, np.int64),
        "seq_start": np.asarray(ss, np.int64),
        "seq_len": np.asarray(sl, np.int64),
        "qual_start": np.asarray(qs, np.int64),
    }


def _ragged_gather(starts: np.ndarray, lens: np.ndarray):
    """(flat_idx, seg_id, within): flat indices start_r + j for j < lens[r]."""
    if lens.shape[0] == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.astype(np.int32), z
    total = int(lens.sum())
    seg = np.repeat(np.arange(lens.shape[0]), lens)
    cum = np.concatenate([[0], np.cumsum(lens)[:-1]])
    within = np.arange(total, dtype=np.int64) - np.repeat(cum, lens)
    return np.repeat(starts, lens) + within, seg.astype(np.int32), within


def parse_fastq(
    data: np.ndarray,
    alphabet: Alphabet,
    file_offset: int = 0,
    file_id: int = 0,
    seq_index_base: int = 0,
) -> ReadBatch:
    """Parse a FASTQ byte block (starting at a record boundary) to a ReadBatch.

    Args:
      data: uint8 bytes of one or more complete records.
      alphabet: target alphabet for base encoding.
      file_offset: absolute file position of data[0] (for global ids).
      file_id: file ordinal (ShortSequenceKmerId file field).
      seq_index_base: ordinal of the first record within the file.
    """
    data = np.asarray(data, dtype=np.uint8)
    rec = parse_fastq_bytes(data)
    nrec = rec["record_start"].shape[0]
    flat, seg, within = _ragged_gather(rec["seq_start"], rec["seq_len"])
    qflat = np.repeat(rec["qual_start"], rec["seq_len"]) + within
    codes = alphabet.from_ascii[data[flat]]
    offset_in_record = (flat - rec["record_start"][seg]).astype(np.uint32)
    return ReadBatch(
        codes=codes,
        valid=np.ones(codes.shape[0], dtype=bool),
        owned=np.ones(codes.shape[0], dtype=bool),
        seg_id=seg,
        offset_in_record=offset_in_record,
        global_pos=(flat + file_offset).astype(np.uint64),
        qual=data[qflat],
        record_start=(rec["record_start"] + file_offset).astype(np.uint64),
        seq_index=(np.arange(nrec) + seq_index_base).astype(np.uint32),
        file_id=np.full(nrec, file_id, dtype=np.uint16),
        alphabet=alphabet,
    )
