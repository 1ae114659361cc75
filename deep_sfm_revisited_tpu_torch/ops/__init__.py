"""Geometry, the essential-matrix engine and the CUDA kernel wrappers of the port."""
