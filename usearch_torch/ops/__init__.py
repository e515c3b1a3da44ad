"""Tensor operations of the port: casts, distances, top-k and the scan kernels."""
