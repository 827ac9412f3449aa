"""kmerind_tpu_torch — the k-mer index of ``kmerind_tpu`` in PyTorch + CUDA.

A port of the JAX/Pallas package ``kmerind_tpu`` (the reference it is
tested against) to PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper (``ops/csrc``).  It mirrors the JAX package's module layout:

* ``alphabets`` / ``kmer`` — k-mer data model (numpy);
* ``io``       — host-side FASTQ/FASTA parsing into read batches;
* ``ops``      — k-mer extraction, sort/merge/search, the CUDA kernels;
* ``parallel`` — owner routing (single shard so far);
* ``index``    — run-layout stores and the `CountIndex` API.

Every tensor function runs on the device its inputs live on; the index
takes an explicit ``device``.  Nothing here imports JAX.
"""

from . import alphabets
from .alphabets import ASCII, DNA, DNA5, DNA6, DNA16, DNA_IUPAC, RNA, RNA5, RNA6
from .index.api import CountIndex
from .kmer import KmerSpec

__all__ = ["alphabets", "KmerSpec", "CountIndex", "DNA", "DNA5", "DNA6",
           "DNA16", "DNA_IUPAC", "RNA", "RNA5", "RNA6", "ASCII"]
