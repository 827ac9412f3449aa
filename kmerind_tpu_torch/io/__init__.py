"""Host-side file IO and parsing into read batches (numpy)."""

from .batch import ReadBatch, concat_batches
from .files import (cyclic_partition, owned_base_count, read_fasta_block,
                    read_fastq_block, read_file, sniff_format)
from .filters import (drop_records_with_invalid, records_with_invalid,
                      split_records_at_invalid)

__all__ = ["ReadBatch", "concat_batches", "cyclic_partition",
           "owned_base_count", "read_file", "read_fastq_block",
           "read_fasta_block", "sniff_format", "drop_records_with_invalid",
           "records_with_invalid", "split_records_at_invalid"]
