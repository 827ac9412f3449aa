"""kmerind_tpu_torch — the k-mer index of ``kmerind_tpu`` in PyTorch + CUDA.

A port of the JAX/Pallas package ``kmerind_tpu`` (the reference it is
tested against) to PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper (``ops/csrc``).  It mirrors the JAX package's module layout:

* ``alphabets`` / ``kmer`` — k-mer data model (numpy);
* ``io``       — host-side FASTQ/FASTA parsing into read batches;
* ``ops``      — k-mer extraction, sort/merge/search, the CUDA kernels;
* ``parallel`` — owner exchange and sample sort over p shards, stacked on
  one device or spread over `torch.distributed` ranks (``mesh``,
  ``multihost``: the layout, each rank's file blocks, the launcher);
* ``index``    — count, multimap and value stores and the indexes:
  `CountIndex`, `BimoleculeCountIndex`, `PositionIndex`,
  `PositionQualityIndex`, `KmerValueIndex` (hash-partitioned) and
  `SortedCountIndex`, `SortedPositionIndex`, `SortedPositionQualityIndex`,
  `SortedKmerValueIndex` (range-partitioned), each over p shards stacked
  on one device;
* ``debruijn`` — the de Bruijn graphs `DeBruijnGraph` and
  `QualityDeBruijnGraph` on the same machinery;
* ``quality``  — the phred codec and windowed k-mer quality;
* ``config``   — `IndexConfig`, every index's knobs in one dataclass;
* ``utils.checkpoint`` — sharded `save_index` / `load_index` (each index
  also has npz `save` / `load` in the JAX package's formats);
* ``utils.timers`` / ``logging`` / ``profiling`` — phase timers (over
  ranks too), the ``kmerind_tpu_torch`` logger, `torch.profiler` traces;
* ``bench`` — the BenchmarkKmerIndex CLI and the micro-benchmarks.

Every tensor function runs on the device its inputs live on; an index
lives on ``device="cuda"`` unless the caller names another (the tests pass
"cpu"), or on its rank's device under a ``mesh=``.  Nothing here imports
JAX.
"""

from . import alphabets
from .alphabets import ASCII, DNA, DNA5, DNA6, DNA16, DNA_IUPAC, RNA, RNA5, RNA6
from .config import IndexConfig
from .debruijn import DeBruijnGraph, QualityDeBruijnGraph
from .index.api import (BimoleculeCountIndex, CountIndex, PositionIndex,
                        PositionQualityIndex)
from .index.sorted_api import (SortedCountIndex, SortedPositionIndex,
                               SortedPositionQualityIndex)
from .index.value_api import KmerValueIndex, SortedKmerValueIndex
from .kmer import KmerSpec

__all__ = ["alphabets", "KmerSpec", "IndexConfig", "CountIndex",
           "BimoleculeCountIndex", "PositionIndex", "PositionQualityIndex",
           "KmerValueIndex", "SortedCountIndex", "SortedPositionIndex",
           "SortedPositionQualityIndex", "SortedKmerValueIndex",
           "DeBruijnGraph",
           "QualityDeBruijnGraph", "DNA", "DNA5", "DNA6", "DNA16",
           "DNA_IUPAC", "RNA", "RNA5", "RNA6", "ASCII"]
