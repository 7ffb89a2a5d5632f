"""Kernels and plain tensor functions of the PyTorch port."""
