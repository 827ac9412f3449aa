"""Unified runtime configuration of an index.

The port of ``kmerind_tpu.config``: the reference's three configuration
layers (CMake options, the compile-time type matrix of
test/benchmark/BenchmarkKmerIndex.cpp:45-260, TCLAP flags) as one runtime
dataclass with the JAX package's fields, so a config written by either
package (e.g. a checkpoint's JSON) builds the same index here.

| reference macro          | field        | values                        |
|--------------------------|--------------|-------------------------------|
| pPARSER FASTQ/FASTA      | fmt          | "fastq" / "fasta" (or sniffed) |
| pINDEX COUNT/POS/POSQUAL | index        | "count" / "position" / "posqual" |
| pMAP DENSEHASH/SORTED    | distribution | "hash" / "range"              |
| pKmerParser canonical    | strands      | "canonical" / "single"        |
| pDistHash MURMUR/FARM    | hash_name    | "murmur" / "farm" / "std" ... |
| pDNA 4/5/16              | alphabet     | "DNA" / "DNA5" / "DNA16" ...  |
| pK 21/31/63              | k            | any                           |

Families the port does not have yet raise NotImplementedError with their
ROADMAP item: the de Bruijn graphs (index="debruijn", queue 1 item 14),
the Bimolecule preset (strands="bimolecule", item 12) and the value maps
(index="value", item 13); the lex_greater / xor_rev_comp strands raise in
the index (item 3).
"""

from __future__ import annotations

import dataclasses

from . import alphabets, quality
from .kmer import KmerSpec

__all__ = ["IndexConfig"]

_NOT_PORTED = {"debruijn": "14 (de Bruijn graphs)",
               "bimolecule": "12 (Bimolecule)",
               "value": "13 (value maps)"}


def _not_ported(what: str):
    return NotImplementedError(
        f"{what!r} is not ported yet: ROADMAP queue 1, item "
        f"{_NOT_PORTED[what]}")


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """All knobs of one index instance (the JAX package's fields)."""

    k: int = 21
    alphabet: str = "DNA"
    index: str = "count"           # count | position | posqual
    canonical: bool = True         # Canonical vs SingleStrand presets
    strands: str | None = None     # "canonical" | "single"; overrides
    #                                `canonical` when set
    distribution: str = "hash"     # "hash" (densehash) | "range" (sorted)
    hash_name: str = "murmur"      # DistHash preset (hash distribution)
    id_kind: str = "short"         # short (FASTQ) | long (FASTA)
    quality_codec: str = "Illumina18"
    saturate: int | None = None    # saturating counter ceiling
    reduce: str = "first"          # value-map insert reduction
    fill_factor: float = 1.6       # exchange bucket headroom
    fmt: str | None = None         # input format override
    devices: int | None = None     # shards of the index (None: 1); the
    #                                JAX package's mesh size

    def spec(self) -> KmerSpec:
        return KmerSpec(self.k, alphabets.by_name(self.alphabet))

    def make_index(self, device="cuda", nparts: int | None = None):
        """The configured index on `device`, with `nparts` shards (default:
        `devices`, else 1)."""
        from .index.api import CountIndex, PositionIndex, PositionQualityIndex
        from .index.sorted_api import (SortedCountIndex, SortedPositionIndex,
                                       SortedPositionQualityIndex)

        strands = self.strands
        if strands is None:
            strands = "canonical" if self.canonical else "single"
        if strands not in ("canonical", "single", "bimolecule",
                           "lex_greater", "xor_rev_comp"):
            raise ValueError(f"unknown strands preset {strands!r}")
        if self.distribution not in ("hash", "range"):
            raise ValueError(f"unknown distribution {self.distribution!r}")
        if self.index in _NOT_PORTED:
            raise _not_ported(self.index)
        if strands == "bimolecule":
            raise _not_ported("bimolecule")
        canonical = (strands if strands in ("lex_greater", "xor_rev_comp")
                     else strands != "single")
        range_cls = {"count": SortedCountIndex,
                     "position": SortedPositionIndex,
                     "posqual": SortedPositionQualityIndex}
        hash_cls = {"count": CountIndex, "position": PositionIndex,
                    "posqual": PositionQualityIndex}
        table = range_cls if self.distribution == "range" else hash_cls
        if self.index not in table:
            raise ValueError(f"{self.distribution} distribution has no "
                             f"{self.index!r} index")
        kw = dict(device=device, canonical=canonical,
                  nparts=nparts or self.devices or 1)
        if self.index == "count":
            kw["saturate"] = self.saturate
        else:
            kw["id_kind"] = self.id_kind
            if self.index == "posqual":
                kw["codec"] = quality.by_name(self.quality_codec)
        if self.distribution == "hash":
            kw["hash_name"] = self.hash_name
        idx = table[self.index](self.spec(), **kw)
        idx.fill_factor = self.fill_factor
        return idx
