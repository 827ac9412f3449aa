"""Record -> tuple extraction: per-base tensors -> k-mer tensors.

The port of ``kmerind_tpu.io.kmer_parsers.extract_tuples`` for the count
index (the reference's KmerParser / KmerCountTupleParser,
src/io/kmer_parser.hpp:86,910): one vectorized extraction over the whole
base tensor, invalid windows masked.  Canonicalization on ingest (the
``lex_less`` InputTransform of the Canonical map presets,
kmer_index.hpp:436-562) runs in the K1 kernel on the device
(``ops/kernels.py::extract_canonical``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..kmer import KmerSpec
from ..ops import kernels, packing

__all__ = ["DeviceBases", "KmerTuples", "extract_tuples", "transform_name"]


@dataclasses.dataclass
class DeviceBases:
    """Per-base tensors of one shard, all shape [n]."""

    codes: torch.Tensor   # uint8
    valid: torch.Tensor   # bool
    owned: torch.Tensor   # bool
    seg_id: torch.Tensor  # int32


@dataclasses.dataclass
class KmerTuples:
    """Extracted k-mer tuples of one shard; rows align with window starts."""

    words: torch.Tensor   # int32[n, nwords] (uint32 bits)
    valid: torch.Tensor   # bool[n] — real, owned windows
    strand: torch.Tensor  # bool[n] — stored word is the reverse complement


def transform_name(canonical) -> str:
    """InputTransform name (kmer_transform.hpp:90-145) of a `canonical`
    argument: a bool (Canonical / SingleStrand preset) or a name.  The port
    has "lex_less" and "single"; "lex_greater" and "xor_rev_comp" are
    still to be ported."""
    t = {False: "single", True: "lex_less"}.get(canonical, canonical)
    if t not in ("lex_less", "single"):
        raise NotImplementedError(
            f"transform {t!r} is not ported yet (ROADMAP queue 1, item 3)")
    return t


def extract_tuples(bases: DeviceBases, spec: KmerSpec,
                   canonical=True) -> KmerTuples:
    """All k-mer tuples of one shard (hot loops 1-2 of the reference build
    stack): window pack, canonicalize, validity mask."""
    if transform_name(canonical) == "lex_less":
        words, strand = kernels.extract_canonical(bases.codes, spec)
    else:
        words = packing.extract_kmers(bases.codes, spec)
        strand = torch.zeros(bases.codes.shape[0], dtype=torch.bool,
                             device=bases.codes.device)
    wvalid = packing.window_valid(bases.valid, bases.seg_id, spec.k) \
        & bases.owned
    return KmerTuples(words=words, valid=wvalid, strand=strand)
