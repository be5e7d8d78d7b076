"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version; sources in ``csrc/``, built on first use by ``build.py``."""
