"""Tensor ops on packed k-mers, and the CUDA kernels (``kernels``)."""
