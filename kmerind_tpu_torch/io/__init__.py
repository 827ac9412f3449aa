"""Host-side file IO and parsing into read batches (numpy), and the
per-base device columns k-mers are extracted from."""

from .batch import ReadBatch, concat_batches
from .fasta import find_fasta_record_start, parse_fasta
from .fastq import find_record_start, parse_fastq
from .files import (block_partition, cyclic_partition, fasta_header_table,
                    owned_base_count, read_bytes, read_fasta_block,
                    read_fastq_block, read_file, sniff_format)
from .filters import (drop_records_with_invalid, records_with_invalid,
                      split_records_at_invalid)
from .kmer_parsers import (DeviceBases, KmerTuples, batch_to_arrays,
                           extract_tuples)

__all__ = ["ReadBatch", "concat_batches", "parse_fastq", "parse_fasta",
           "find_record_start", "find_fasta_record_start", "read_file",
           "read_fastq_block", "read_fasta_block", "read_bytes",
           "block_partition", "cyclic_partition", "owned_base_count",
           "fasta_header_table", "sniff_format", "drop_records_with_invalid",
           "records_with_invalid", "split_records_at_invalid", "DeviceBases",
           "KmerTuples", "batch_to_arrays", "extract_tuples"]
