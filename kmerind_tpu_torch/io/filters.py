"""Record filters — the FilteredSequencesIterator and
SplitSequencesIterator equivalents.

The reference filters records through predicate iterators
(src/io/filtered_sequence_iterator.hpp:63-247) testing
`SequenceNPredicate` (:151): a character outside the alphabet's explicit
letter set (e.g. 'N' under the strict DNA alphabet, which would otherwise
silently encode as 'A' — alphabets.hpp:139).

Here each filter is a vectorized pass over the parsed batch: per-base
validity from `Alphabet.valid_ascii`, OR-reduced per record where whole
records are dropped.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..alphabets import Alphabet
from .batch import ReadBatch

__all__ = ["drop_records_with_invalid", "records_with_invalid",
           "split_records_at_invalid"]


def records_with_invalid(batch: ReadBatch, raw_data: np.ndarray,
                         alphabet: Alphabet,
                         file_offset: int = 0) -> np.ndarray:
    """bool[num_records]: records containing a byte outside the alphabet's
    explicit letter set (the SequenceNPredicate test)."""
    pos = (batch.global_pos - np.uint64(file_offset)).astype(np.int64)
    raw = np.asarray(raw_data, dtype=np.uint8)[pos]
    bad_base = ~alphabet.valid_ascii[raw] & batch.valid
    bad = np.zeros(batch.num_records, dtype=bool)
    bad[batch.seg_id[bad_base]] = True
    return bad


def drop_records_with_invalid(batch: ReadBatch, raw_data: np.ndarray,
                              alphabet: Alphabet,
                              file_offset: int = 0) -> ReadBatch:
    """A new batch without any base of the records that contain invalid
    letters (FilteredSequencesIterator + SequenceNPredicate semantics).
    The per-record table stays as it is (ids and indices unchanged); only
    the base stream shrinks."""
    bad = records_with_invalid(batch, raw_data, alphabet, file_offset)
    keep = ~bad[batch.seg_id] & batch.valid
    return dataclasses.replace(
        batch, codes=batch.codes[keep], valid=batch.valid[keep],
        owned=batch.owned[keep], seg_id=batch.seg_id[keep],
        offset_in_record=batch.offset_in_record[keep],
        global_pos=batch.global_pos[keep], qual=batch.qual[keep])


def split_records_at_invalid(batch: ReadBatch, raw_data: np.ndarray,
                             alphabet: Alphabet,
                             file_offset: int = 0) -> ReadBatch:
    """Split records wherever a base fails the alphabet's letter test —
    the SplitSequencesIterator semantics
    (filtered_sequence_iterator.hpp:168-247: "EFFECTIVELY BREAKS THE
    SEQUENCE INTO PARTS WHERE PREDICATE FAILS").

    Tensor form: offending bases are marked invalid in place.  The window
    machinery (`extract_tuples` requires every base of a k-mer window to
    be valid) then yields exactly the k-mers of the split parts — no
    k-mer spans a failing base — while positions (`offset_in_record`,
    record ids) keep their original-record values, matching the
    reference's split parts which retain their offsets within the parent
    sequence."""
    pos = (batch.global_pos - np.uint64(file_offset)).astype(np.int64)
    raw = np.asarray(raw_data, dtype=np.uint8)[pos]
    good = alphabet.valid_ascii[raw]
    return dataclasses.replace(batch, valid=batch.valid & good)
