"""Kernels of the port (counterpart of ``repro/kernels``): the ZO axpy
K1, flash attention K2 and the norm kernel (which no Pallas kernel
answers to), each a CUDA kernel beside its plain PyTorch version, plus
the builder that compiles ``csrc/`` at first use."""
