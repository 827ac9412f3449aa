"""The de Bruijn graph engine built on the k-mer index (the reference's
test/test/debruijn application)."""

from .edges import edge_bytes_for_windows, revcomp_edge_byte
from .graph import DeBruijnGraph, QualityDeBruijnGraph

__all__ = ["DeBruijnGraph", "QualityDeBruijnGraph",
           "edge_bytes_for_windows", "revcomp_edge_byte"]
