"""Benchmark of the PyTorch/CUDA port (see README.md)."""
