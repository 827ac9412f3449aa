"""Record -> tuple extraction: per-base tensors -> k-mer tensors.

The port of ``kmerind_tpu.io.kmer_parsers.extract_tuples`` (the
reference's KmerParser, KmerPositionTupleParser, KmerPositionQualityTuple-
Parser and KmerCountTupleParser, src/io/kmer_parser.hpp:86,304,578,910):
one vectorized extraction over the whole base tensor, invalid windows
masked, each window carrying its first base's 64-bit position id and, with
`with_quality`, its windowed quality score.  Canonicalization on ingest (the
``lex_less`` InputTransform of the Canonical map presets,
kmer_index.hpp:436-562) runs in the K1 kernel on the device
(``ops/kernels.py::extract_canonical``); the ``lex_greater`` and
``xor_rev_comp`` transforms are torch ops on the same device, as the JAX
package computes them in XLA outside its Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..kmer import KmerSpec
from ..ops import kernels, packing
from ..quality import ILLUMINA18, QualityCodec, window_quality

__all__ = ["DeviceBases", "KmerTuples", "TRANSFORMS", "batch_to_arrays",
           "extract_tuples", "transform_name"]


@dataclasses.dataclass
class DeviceBases:
    """Per-base tensors of one shard, all shape [n] — or of p shards
    stacked, [p, n].  The id and quality columns are None for indexes that
    do not store them (the count indexes never copy them to the device)."""

    codes: torch.Tensor   # uint8
    valid: torch.Tensor   # bool
    owned: torch.Tensor   # bool
    seg_id: torch.Tensor  # int32
    id_hi: torch.Tensor | None = None  # int32 (uint32 bits): id >> 32
    id_lo: torch.Tensor | None = None  # int32 (uint32 bits): id & 2^32-1
    qual: torch.Tensor | None = None   # uint8 phred byte

    def shard(self, s: int) -> "DeviceBases":
        """Shard s of stacked bases."""
        return DeviceBases(*(None if t is None else t[s] for t in (
            self.codes, self.valid, self.owned, self.seg_id, self.id_hi,
            self.id_lo, self.qual)))


@dataclasses.dataclass
class KmerTuples:
    """Extracted k-mer tuples of one shard; rows align with window starts."""

    words: torch.Tensor   # int32[n, nwords] (uint32 bits)
    valid: torch.Tensor   # bool[n] — real, owned windows
    strand: torch.Tensor  # bool[n] — stored word is the reverse complement
    id_hi: torch.Tensor | None = None  # position id of the window's first
    id_lo: torch.Tensor | None = None  # base, as in DeviceBases
    qual: torch.Tensor | None = None   # float32[n] windowed quality


def batch_to_arrays(batch, id_kind: str | None = None,
                    device="cuda") -> DeviceBases:
    """A host `ReadBatch` as `DeviceBases` on `device`: every per-base
    column, the position ids of `id_kind` ("short" / "long"; zeros when
    None) split into their uint32 halves."""
    ids = (np.zeros(batch.num_bases, np.uint64) if id_kind is None
           else batch.ids(id_kind))
    halves = ids.view(np.uint32).reshape(-1, 2)
    hi, lo = (halves[:, 1], halves[:, 0]) if sys.byteorder == "little" \
        else (halves[:, 0], halves[:, 1])

    def put(a):
        return torch.from_numpy(np.array(a)).to(device)

    return DeviceBases(
        codes=put(batch.codes), valid=put(batch.valid),
        owned=put(batch.owned), seg_id=put(batch.seg_id),
        id_hi=put(hi.view(np.int32)), id_lo=put(lo.view(np.int32)),
        qual=put(batch.qual))


TRANSFORMS = ("single", "lex_less", "lex_greater", "xor_rev_comp")


def transform_name(canonical) -> str:
    """InputTransform name (kmer_transform.hpp:90-145) of a `canonical`
    argument: a bool (Canonical / SingleStrand preset) or one of
    `TRANSFORMS`."""
    t = {False: "single", True: "lex_less"}.get(canonical, canonical)
    if t not in TRANSFORMS:
        raise ValueError(f"unknown transform {t!r}")
    return t


def extract_tuples(bases: DeviceBases, spec: KmerSpec, canonical=True,
                   with_quality: bool = False,
                   codec: QualityCodec = ILLUMINA18) -> KmerTuples:
    """All k-mer tuples of one shard (hot loops 1-2 of the reference build
    stack): window pack, canonicalize, validity mask; the bases' id
    columns ride along, and with `with_quality` each window's quality
    (`quality.window_quality` of the phred bytes under `codec`)."""
    t = transform_name(canonical)
    if t == "lex_less":
        words, strand = kernels.extract_canonical(bases.codes, spec)
    elif t == "lex_greater":
        words, strand = packing.extract_canonical_greater(bases.codes, spec)
    else:
        words = (packing.extract_xor_rev_comp if t == "xor_rev_comp"
                 else packing.extract_kmers)(bases.codes, spec)
        strand = torch.zeros(bases.codes.shape[0], dtype=torch.bool,
                             device=bases.codes.device)
    wvalid = packing.window_valid(bases.valid, bases.seg_id, spec.k) \
        & bases.owned
    qual = (window_quality(bases.qual, spec.k, codec) if with_quality
            else None)
    return KmerTuples(words=words, valid=wvalid, strand=strand,
                      id_hi=bases.id_hi, id_lo=bases.id_lo, qual=qual)
