"""Tensor ops on packed k-mers (packing, bit ops, hashing, sort / merge /
search primitives) and the CUDA kernels (``kernels``)."""

from . import bitops, hashing, packing, sortops

__all__ = ["bitops", "hashing", "packing", "sortops"]
