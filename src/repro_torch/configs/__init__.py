"""Architecture registry of the port: the OPT entries, the dense
``attn + dense`` model zoo, its MoE/MLA configs (granite-moe,
deepseek-v2-lite) and its recurrent ones (jamba, xlstm) of
``repro/configs/__init__.py``."""
from __future__ import annotations

import importlib

ARCHS = {
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "xlstm-350m": "xlstm_350m",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "internlm2-1.8b": "internlm2_1_8b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "qwen3-14b": "qwen3_14b",
    "musicgen-large": "musicgen_large",
    "internvl2-2b": "internvl2_2b",
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
