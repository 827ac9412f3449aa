"""File access + block-parallel partitioned reading.

Rebuild of the reference file stack (src/io/file.hpp):

* `read_file` — whole-file parse to a `ReadBatch` (the serial readers,
  file.hpp:552-900).
* `block_partition` — contiguous byte-range decomposition with remainder
  spread, the BlockPartitioner (src/partition/partitioner.hpp:269-350).
* `read_fastq_block` / `read_fasta_block` — the parallel
  ``partitioned_file`` semantics (file.hpp:1066-1432): each partition owns
  the records *starting* in its byte block (FASTQ) or the sequence bases in
  its block (FASTA), reading past the block end to complete trailing
  records.  Instead of shipping partial prefixes to the left neighbor with
  alltoallv (file.hpp:1384-1422), a partition simply begins at the first
  record start at-or-after its block start — the two formulations assign
  every byte to exactly one owner.

Memory-mapped numpy views replace mmap_file/posix_file.  The block readers
feed the streaming build (`CountIndex.build_stream`), one block at a time,
and each rank of a multi-process build reads its own blocks
(``parallel/multihost.py``).
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from ..alphabets import Alphabet
from . import native
from .batch import ReadBatch
from .fasta import parse_fasta
from .fastq import find_record_start, parse_fastq

__all__ = [
    "sniff_format",
    "read_bytes",
    "block_partition",
    "cyclic_partition",
    "fastq_block_span",
    "owned_base_count",
    "read_file",
    "read_fastq_block",
    "read_fasta_block",
]

_SLACK = 1 << 16  # initial over-read when hunting for a record boundary


def read_bytes(path, start: int = 0, end: int | None = None) -> np.ndarray:
    """uint8 view of file bytes [start, end) via mmap (file.hpp:228-291)."""
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    return mm[start:end if end is not None else mm.shape[0]]


def file_size(path) -> int:
    return pathlib.Path(path).stat().st_size


def sniff_format(path) -> str:
    """'fastq' or 'fasta', from extension else first byte
    (KmerFileHelper chooses by template arg; we sniff)."""
    ext = pathlib.Path(path).suffix.lower()
    if ext in (".fastq", ".fq"):
        return "fastq"
    if ext in (".fasta", ".fa", ".fna", ".ffn", ".faa", ".frn"):
        return "fasta"
    first = bytes(read_bytes(path, 0, 1))
    if first == b"@":
        return "fastq"
    if first in (b">", b";"):
        return "fasta"
    raise ValueError(f"cannot determine format of {path}")


def block_partition(total: int, nparts: int, part: int) -> tuple[int, int]:
    """[start, end) of contiguous block `part`, remainder given to the first
    total%nparts parts (BlockPartitioner, partitioner.hpp:269-350)."""
    if not 0 <= part < nparts:
        raise ValueError(f"part {part} out of range for {nparts}")
    base, rem = divmod(total, nparts)
    start = part * base + min(part, rem)
    end = start + base + (1 if part < rem else 0)
    return start, end


def cyclic_partition(total: int, nparts: int, part: int,
                     chunk: int) -> list[tuple[int, int]]:
    """Round-robin chunked decomposition (CyclicPartitioner,
    partitioner.hpp:442): part p owns chunks p, p+nparts, p+2*nparts, ...
    Returns the list of [start, end) spans.  (The reference's
    DemandDrivenPartitioner has no SPMD analog — static decompositions
    only.)"""
    spans = []
    start = part * chunk
    while start < total:
        spans.append((start, min(start + chunk, total)))
        start += nparts * chunk
    return spans


def read_file(
    path,
    alphabet: Alphabet,
    fmt: str | None = None,
    file_id: int = 0,
    engine: str = "auto",
    reuse: bool = False,
) -> ReadBatch:
    """Whole-file parse (serial read path, kmer_file_helper.hpp:391-433).

    engine: "native" (C++ single-pass scanner), "numpy" (vectorized python),
    or "auto" (native when the shared library is available).

    reuse: with the native engine, return zero-copy views into a rotating
    buffer ring instead of fresh arrays — the batch is valid until the
    next-but-one native parse.  Streaming build loops that consume each batch
    onto the device before parsing the next block use this to avoid
    first-touch page-fault storms on multi-GB outputs.
    """
    fmt = fmt or sniff_format(path)
    data = read_bytes(path)
    use_native = engine == "native" or (engine == "auto" and native.available())
    if fmt == "fastq":
        if use_native:
            return native.fastq_parse(data, alphabet, 0, file_id, reuse=reuse)
        return parse_fastq(data, alphabet, file_offset=0, file_id=file_id)
    if fmt == "fasta":
        if use_native:
            return native.fasta_parse(data, alphabet, 0, file_id, reuse=reuse)
        return parse_fasta(data, alphabet, file_offset=0, file_id=file_id)
    raise ValueError(f"unknown format {fmt!r}")


def _find_boundary(path, total: int, pos: int, finder) -> int:
    """Absolute offset of the first record start at-or-after byte `pos`.

    The scan starts one byte EARLY: the finder assumes an arbitrary
    mid-line offset and skips the partial first line, which would skip a
    record starting exactly AT `pos` — including data[pos-1] (the '\\n'
    that precedes any line start) makes that record's line start visible,
    so records landing precisely on block boundaries are never lost."""
    if pos == 0:
        return 0
    if pos >= total:
        return total
    slack = _SLACK
    while True:
        hi = min(pos + slack, total)
        data = read_bytes(path, pos - 1, hi)
        off = finder(data, False)
        if off < data.shape[0]:
            return pos - 1 + off
        if hi == total:
            return total
        slack *= 4


def read_fastq_block(
    path,
    alphabet: Alphabet,
    part: int,
    nparts: int,
    file_id: int = 0,
    reuse: bool = False,
    seq_index_base: int = 0,
) -> ReadBatch:
    """Parse the FASTQ records starting within byte block `part` of `nparts`.

    The union of all parts' records equals the whole-file parse, each record
    owned by exactly one part — the partitioned_file FASTQ contract
    (file.hpp:1216-1432).  A block cannot know how many records precede it:
    its records are numbered from `seq_index_base` (the caller's count of
    the records of the blocks before it; 0, as in the JAX package, numbers
    them within the block).
    """
    first, nxt = fastq_block_span(path, block_partition(
        file_size(path), nparts, part))
    if first >= nxt:
        return parse_fastq(np.zeros(0, np.uint8), alphabet, 0, file_id)
    data = read_bytes(path, first, nxt)
    if native.available():
        return native.fastq_parse(data, alphabet, first, file_id,
                                  seq_index_base, reuse=reuse)
    return parse_fastq(data, alphabet, file_offset=first, file_id=file_id,
                       seq_index_base=seq_index_base)


def fastq_block_span(path, block: tuple[int, int]) -> tuple[int, int]:
    """[first, next) bytes of the FASTQ records starting in byte range
    `block` = [bs, be): the first record start at or after bs, and the
    first at or after be (first == next when none starts in the range)."""
    total = file_size(path)
    bs, be = block
    finder = (native.find_record_start if native.available()
              else find_record_start)
    first = _find_boundary(path, total, bs, finder)
    if first >= be:
        return first, first
    return first, _find_boundary(path, total, be, finder)


_HEADER_CACHE: dict = {}


def _record_starts_in(data: np.ndarray, at_parent_start: bool,
                      prev_line_is_header: bool) -> np.ndarray:
    """Record-start offsets within `data` (header-RUN starts: a '>'/';'
    line whose previous line is not a header, fasta_loader.hpp:295-325)."""
    n = data.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    eol = (data == 10) | (data == 13)
    prev_nl = np.empty(n, dtype=bool)
    prev_nl[0] = at_parent_start
    prev_nl[1:] = data[:-1] == 10
    starts = np.flatnonzero(prev_nl & ~eol)
    if starts.size == 0:
        return np.zeros(0, np.int64)
    first = data[starts]
    is_hdr = (first == ord(">")) | (first == ord(";"))
    prev_hdr = np.empty_like(is_hdr)
    prev_hdr[0] = prev_line_is_header
    prev_hdr[1:] = is_hdr[:-1]
    return starts[is_hdr & ~prev_hdr].astype(np.int64)


def fasta_header_table(path) -> np.ndarray:
    """Absolute positions of every FASTA record start (the first line of
    each '>'/';' header run).

    One vectorized scan, cached per (path, size, mtime) — serves the
    block readers.
    """
    st = pathlib.Path(path).stat()
    key = (str(path), st.st_size, st.st_mtime_ns)
    hit = _HEADER_CACHE.get(key)
    if hit is not None:
        return hit
    data = read_bytes(path)
    hdr = _record_starts_in(data, True, False)
    _HEADER_CACHE.clear()
    _HEADER_CACHE[key] = hdr
    return hdr


def _line_context_before(path, pos: int) -> tuple[int, bool]:
    """(line start containing/at `pos`, is the previous VISIBLE line a
    header line).

    O(line) backward peek: scans back from `pos` to the nearest newline
    for the alignment, then to the previous visible (non-blank) line for
    the header flag — blank lines are invisible, matching
    `_record_starts_in` (they neither start records nor break header
    runs)."""
    if pos == 0:
        return 0, False
    back = 1 << 12
    while True:
        lo = max(0, pos - back)
        window = read_bytes(path, lo, pos)
        n = window.shape[0]
        nl = np.flatnonzero(window == 10)
        if nl.size == 0 and lo > 0:
            back *= 4
            continue
        ls = lo + (int(nl[-1]) + 1 if nl.size else 0)
        # visible line starts strictly before the containing line
        prev_nl = np.empty(n, dtype=bool)
        prev_nl[0] = lo == 0
        prev_nl[1:] = window[:-1] == 10
        eol = (window == 10) | (window == 13)
        starts = np.flatnonzero(prev_nl & ~eol)
        starts = starts[starts < ls - lo]
        if starts.size == 0:
            if lo == 0:
                return ls, False
            back *= 4
            continue
        first = int(window[int(starts[-1])])
        return ls, first in (ord(">"), ord(";"))


def fasta_block_record_starts(path, bs: int, be: int) -> np.ndarray:
    """Absolute record-start positions within byte block [bs, be) —
    O(block) work plus an O(line) boundary peek (the per-rank half of the
    reference's distributed header scan, fasta_loader.hpp:202-360)."""
    if bs >= be:
        return np.zeros(0, np.int64)
    ls, prev_hdr = _line_context_before(path, bs)
    data = read_bytes(path, ls, be)
    # ls is always a line start (file start or just after a newline)
    rel = _record_starts_in(data, True, prev_hdr)
    abs_pos = rel + ls
    return abs_pos[abs_pos >= bs]


def read_fasta_block(
    path,
    alphabet: Alphabet,
    part: int,
    nparts: int,
    file_id: int = 0,
    halo: int = 0,
    halo_left: int = 0,
    reuse: bool = False,
    context: tuple[int, int] | None = None,
) -> ReadBatch:
    """Parse the FASTA sequence bases within byte block `part` of `nparts`,
    plus `halo` following bases (k-1 overlap so windows crossing the block
    boundary are produced exactly once, by the left owner —
    kmer_file_helper.hpp:361, file.hpp:1264-1295) and `halo_left`
    preceding bases (the de Bruijn edges' left context, not owned).

    Cost is O(block): record context for a block that begins mid-sequence
    comes either from `context=(hidx, lead_abs)` — the ordinal and start
    position of the record containing the block start, as the ranks of a
    multi-process build compute it (``parallel.multihost.
    distributed_fasta_context``, the reference's distributed header scan,
    fasta_loader.hpp:202-360); (-1, -1) means no record starts at or before
    the block — or, when `context` is None, from the cached whole-file
    header table (`fasta_header_table`).  Only [block_start, block_end +
    halo slack) bytes are read and parsed.

    Ownership: this part owns k-mer windows whose first base lies within its
    byte block; `ReadBatch.owned` is True for owned bases, False for halo
    bases, so extraction emits boundary-crossing windows exactly once.
    """
    total = file_size(path)
    bs, be = block_partition(total, nparts, part)
    if bs >= be:
        return parse_fasta(np.zeros(0, np.uint8), alphabet)
    if context is not None:
        hidx, lead_abs = context
    else:
        headers = fasta_header_table(path)
        # containing/most-recent record at or before bs
        hidx = int(np.searchsorted(headers, bs, side="right")) - 1
        lead_abs = int(headers[hidx]) if hidx >= 0 else -1
    if hidx < 0:
        # block lies before the first record: skip to the first record
        # start within the block (O(block) local scan), empty if none
        local = fasta_block_record_starts(path, bs, be)
        if local.size == 0:
            return parse_fasta(np.zeros(0, np.uint8), alphabet)
        bs = int(local[0])
        hidx = 0
        lead_abs = bs
    # align the parse start to a line boundary at or before bs, learning
    # whether the line just before it is a header line (run context)
    ps, prev_hdr = _line_context_before(path, bs)
    # left-context bases (edge_iterator.hpp:56): step the parse start back
    # one line at a time until bases precede bs (a header line stops the
    # walk — the left context then does not exist, which seg_id handles)
    while halo_left > 0 and ps >= bs and ps > 0 and not prev_hdr:
        ps, prev_hdr = _line_context_before(path, ps - 1)
    leading = None if lead_abs >= ps else lead_abs
    # read the block plus slack until >= halo bases beyond be (or EOF)
    slack = max(halo * 2, 1 << 14)
    while True:
        hi = min(total, be + slack)
        data = read_bytes(path, ps, hi)
        # ps is the start of the line containing bs, so either the slice
        # begins at record hidx's own header-run start (ps == lead_abs, no
        # leading context) or inside record hidx (leading context =
        # lead_abs, with prev_hdr saying whether ps continues a header
        # run); the first record in the slice is hidx in both cases
        if native.available():
            batch = native.fasta_parse(
                data, alphabet, file_offset=ps, file_id=file_id,
                seq_index_base=hidx, reuse=reuse,
                leading_record_start=leading,
                prev_line_is_header=prev_hdr)
        else:
            batch = parse_fasta(
                data, alphabet, file_offset=ps, file_id=file_id,
                seq_index_base=hidx, leading_record_start=leading,
                prev_line_is_header=prev_hdr)
        # global_pos is strictly increasing (bases in file order), so the
        # owned span [bs, be) is one contiguous index range — searchsorted
        # instead of mask temporaries (block reads are allocation-bound on
        # hosts where first-touch faults are slow)
        pos = batch.global_pos
        cut = int(np.searchsorted(pos, be, side="left"))
        if batch.num_bases - cut >= halo or hi == total:
            break
        slack *= 4
    lo_i = int(np.searchsorted(pos, bs, side="left"))
    if lo_i >= cut:
        return batch.slice_bases(0, 0)
    lo2 = max(lo_i - halo_left, 0)
    hi_i = min(cut + halo, batch.num_bases)
    sub = batch.slice_bases(lo2, hi_i)
    owned = np.zeros(hi_i - lo2, bool)
    owned[lo_i - lo2:cut - lo2] = True
    return dataclasses.replace(sub, owned=owned)


def owned_base_count(batch: ReadBatch) -> int:
    """Bases this block owns (its halo bases excluded)."""
    return int(batch.owned.sum())
