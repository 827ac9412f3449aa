"""Host-side file IO and parsing into read batches (numpy)."""

from .batch import ReadBatch
from .files import read_fasta_block, read_fastq_block, read_file, sniff_format
from .filters import split_records_at_invalid

__all__ = ["ReadBatch", "read_file", "read_fastq_block", "read_fasta_block",
           "sniff_format", "split_records_at_invalid"]
