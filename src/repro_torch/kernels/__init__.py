"""Kernels of the port (counterpart of ``repro/kernels``): the ZO axpy
K1 and flash attention K2, each a CUDA kernel beside its plain PyTorch
version, plus the builder that compiles ``csrc/`` at first use."""
