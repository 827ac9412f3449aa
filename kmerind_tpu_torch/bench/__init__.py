"""Command-line tools: the BenchmarkKmerIndex driver (`cli`) and the per-op
micro-benchmarks (`micro`)."""
