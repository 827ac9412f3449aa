"""Command-line tools: the BenchmarkKmerIndex command line (`cli`), the
per-op micro-benchmarks (`micro`) and the headline bench (`headline`, the
counterpart of the repo's ``bench.py``)."""
