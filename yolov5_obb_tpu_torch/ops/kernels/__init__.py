"""Hand-written CUDA kernels of the inference path, each beside its plain
PyTorch version; ``_build.py`` compiles ``csrc/`` with ``nvcc`` at first
use."""
