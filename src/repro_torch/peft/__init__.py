"""PEFT trainable subtrees of the port (counterpart of ``repro/peft``):
LoRA (``lora.py``) and prefix tuning (``prefix.py``).

A PEFT tree is a plain dict keyed like the reference's, so its leaf
paths (``stages/s0/b0/mix/wq/A``, ``stages/s0/b0/mix/pk``) are the
reference's and ZO draws the reference's z for them.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.models import lm


def from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """A PEFT tree of numpy arrays (the reference's tree after
    ``jax.tree.map(np.asarray, ...)``) -> the same tree of tensors on
    ``device``, each of its array's dtype (bfloat16 bit for bit)."""
    return {k: from_numpy(v, device) if isinstance(v, dict)
            else lm.tensor_from_numpy(v).to(device)
            for k, v in tree.items()}
