"""Unified runtime configuration of an index.

The port of ``kmerind_tpu.config``: the reference's three configuration
layers (CMake options, the compile-time type matrix of
test/benchmark/BenchmarkKmerIndex.cpp:45-260, TCLAP flags) as one runtime
dataclass with the JAX package's fields, so a config written by either
package (e.g. a checkpoint's JSON) builds the same index here.

| reference macro          | field        | values                        |
|--------------------------|--------------|-------------------------------|
| pPARSER FASTQ/FASTA      | fmt          | "fastq" / "fasta" (or sniffed) |
| pINDEX COUNT/POS/POSQUAL | index        | "count" / "position" / "posqual" / "debruijn" / "value" |
| pMAP DENSEHASH/SORTED    | distribution | "hash" / "range"              |
| pKmerParser canonical    | strands      | "canonical" / "single" / "bimolecule" / "lex_greater" / "xor_rev_comp" |
| pDistHash MURMUR/FARM    | hash_name    | "murmur" / "farm" / "std" ... |
| pDNA 4/5/16              | alphabet     | "DNA" / "DNA5" / "DNA16" ...  |
| pK 21/31/63              | k            | any                           |

strands="bimolecule" builds the `BimoleculeCountIndex` (hash-distributed
count indexes only, as in the JAX package); index="value" the unique-key
value maps, `KmerValueIndex` or `SortedKmerValueIndex`, with `reduce` and
`id_kind`.
"""

from __future__ import annotations

import dataclasses

from . import alphabets, quality
from .kmer import KmerSpec

__all__ = ["IndexConfig"]

@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """All knobs of one index instance (the JAX package's fields)."""

    k: int = 21
    alphabet: str = "DNA"
    index: str = "count"           # count | position | posqual | debruijn
    #                                | value (unique-key u64 map)
    canonical: bool = True         # Canonical vs SingleStrand presets
    strands: str | None = None     # "canonical" | "single" | "bimolecule"
    #                                | "lex_greater" | "xor_rev_comp";
    #                                overrides `canonical` when set
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

    def make_index(self, device="cuda", nparts: int | None = None,
                   mesh=None, timer=None):
        """The configured index on `device`, with `nparts` shards (default:
        `devices`, else 1) — or over `mesh` (``parallel/mesh.py``), whose
        shard count and device it takes; `timer` records its phases."""
        from .debruijn import DeBruijnGraph
        from .index.api import (BimoleculeCountIndex, CountIndex,
                                PositionIndex, PositionQualityIndex)
        from .index.sorted_api import (SortedCountIndex, SortedPositionIndex,
                                       SortedPositionQualityIndex)
        from .index.value_api import KmerValueIndex, SortedKmerValueIndex

        strands = self.strands
        if strands is None:
            strands = "canonical" if self.canonical else "single"
        if strands not in ("canonical", "single", "bimolecule",
                           "lex_greater", "xor_rev_comp"):
            raise ValueError(f"unknown strands preset {strands!r}")
        if self.distribution not in ("hash", "range"):
            raise ValueError(f"unknown distribution {self.distribution!r}")
        nparts = mesh.nparts if mesh is not None else (
            nparts or self.devices or 1)
        common = dict(nparts=nparts, mesh=mesh, timer=timer)
        if strands == "bimolecule":
            if self.distribution != "hash" or self.index != "count":
                raise ValueError(
                    "the Bimolecule preset is provided for hash-distributed "
                    "count indexes (the reference's BenchmarkKmerIndex "
                    "matrix likewise pairs it with hash maps)")
            idx = BimoleculeCountIndex(self.spec(), device,
                                       hash_name=self.hash_name,
                                       saturate=self.saturate, **common)
            idx.fill_factor = self.fill_factor
            return idx
        transform = strands in ("lex_greater", "xor_rev_comp")
        if self.index == "debruijn":
            if transform:
                raise ValueError(
                    "the de Bruijn graph defines edges on the lex_less "
                    "canonical strand (the reference's driver config)")
            if self.distribution != "hash":
                raise ValueError("range distribution has no 'debruijn' "
                                 "index")
            g = DeBruijnGraph(self.spec(), device,
                              canonical=strands != "single",
                              hash_name=self.hash_name,
                              saturate=self.saturate, **common)
            g.fill_factor = self.fill_factor
            return g
        canonical = strands if transform else strands != "single"
        range_cls = {"count": SortedCountIndex,
                     "position": SortedPositionIndex,
                     "posqual": SortedPositionQualityIndex,
                     "value": SortedKmerValueIndex}
        hash_cls = {"count": CountIndex, "position": PositionIndex,
                    "posqual": PositionQualityIndex, "value": KmerValueIndex}
        table = range_cls if self.distribution == "range" else hash_cls
        if self.index not in table:
            raise ValueError(f"{self.distribution} distribution has no "
                             f"{self.index!r} index")
        kw = dict(device=device, canonical=canonical, **common)
        if self.index == "count":
            kw["saturate"] = self.saturate
        else:
            kw["id_kind"] = self.id_kind
            if self.index == "posqual":
                kw["codec"] = quality.by_name(self.quality_codec)
            if self.index == "value":
                kw["reduce"] = self.reduce
        if self.distribution == "hash":
            kw["hash_name"] = self.hash_name
        idx = table[self.index](self.spec(), **kw)
        idx.fill_factor = self.fill_factor
        return idx
