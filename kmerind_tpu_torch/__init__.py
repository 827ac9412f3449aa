"""kmerind_tpu_torch — the k-mer index of ``kmerind_tpu`` in PyTorch + CUDA.

A port of the JAX/Pallas package ``kmerind_tpu`` (the reference it is
tested against) to PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper (``ops/csrc``).  It mirrors the JAX package's module layout:

* ``alphabets`` / ``kmer`` — k-mer data model (numpy);
* ``io``       — host-side FASTQ/FASTA parsing into read batches;
* ``ops``      — k-mer extraction, sort/merge/search, the CUDA kernels;
* ``parallel`` — owner exchange and sample sort over p shards stacked on
  one device;
* ``index``    — count and multimap stores and the indexes: `CountIndex`,
  `PositionIndex`, `PositionQualityIndex` (hash-partitioned) and
  `SortedCountIndex`, `SortedPositionIndex`, `SortedPositionQualityIndex`
  (range-partitioned), each over p shards stacked on one device;
* ``quality``  — the phred codec and windowed k-mer quality;
* ``config``   — `IndexConfig`, every index's knobs in one dataclass;
* ``utils.checkpoint`` — sharded `save_index` / `load_index` (each index
  also has npz `save` / `load` in the JAX package's formats).

Every tensor function runs on the device its inputs live on; an index
lives on ``device="cuda"`` unless the caller names another (the tests pass
"cpu").  Nothing here imports JAX.
"""

from . import alphabets
from .alphabets import ASCII, DNA, DNA5, DNA6, DNA16, DNA_IUPAC, RNA, RNA5, RNA6
from .config import IndexConfig
from .index.api import CountIndex, PositionIndex, PositionQualityIndex
from .index.sorted_api import (SortedCountIndex, SortedPositionIndex,
                               SortedPositionQualityIndex)
from .kmer import KmerSpec

__all__ = ["alphabets", "KmerSpec", "IndexConfig", "CountIndex", "PositionIndex",
           "PositionQualityIndex", "SortedCountIndex", "SortedPositionIndex",
           "SortedPositionQualityIndex", "DNA", "DNA5", "DNA6", "DNA16",
           "DNA_IUPAC", "RNA", "RNA5", "RNA6", "ASCII"]
