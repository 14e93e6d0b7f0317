"""PyTorch/CUDA port of the LeZO system for one NVIDIA H100.

Mirrors the JAX package ``repro`` module for module: every file here
names its counterpart there (``repro_torch/core/rng.py`` answers to
``repro/core/rng.py``).  Plain tensor code is PyTorch; every Pallas TPU
kernel on the ported path is a CUDA C++ kernel for ``sm_90a`` under
``csrc/``, built by ``nvcc`` at first use (``kernels/_build.py``) and
held beside a plain PyTorch version of the same function.

Entry points (``api.run``, ``train.trainer.Trainer.from_spec``) run on
the card unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper takes its plain version.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is missing unless the
    caller asked for the CPU explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port's plain PyTorch path on the CPU")
    return dev
