"""Architecture registry of the port: the OPT entries of
``repro/configs/__init__.py``.  Other architectures are not yet ported;
``api/validate.py`` names them so."""
from __future__ import annotations

import importlib

ARCHS = {
    "opt-13b": "opt",
}

# Accepted spellings that resolve to a registry id.
ALIASES = {
    "opt": "opt-13b",      # family alias: full() is the 13b paper model
}


def get(arch: str, variant: str = "full"):
    arch = ALIASES.get(arch, arch)
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return getattr(mod, variant)()


def list_archs():
    return sorted(ARCHS)
