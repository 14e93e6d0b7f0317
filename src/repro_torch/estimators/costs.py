"""Analytic per-step cost counts (copy of the two-point part of
``repro/estimators/costs.py``; the other estimators are not yet ported).

Per optimization step: ``forwards`` model forwards, ``axpy_sweeps``
full-parameter axpy passes (perturb / restore / update), and
``state_scalars`` optimizer state beyond the parameters.
"""
from __future__ import annotations

from typing import Dict

FORWARD_BACKENDS = ("materialized", "virtual", "virtual_ref")


def step_counts(name: str, fused_update: bool = True,
                forward_backend: str = "materialized") -> Dict:
    """Counts for the two-point estimator: virtual probes remove the
    perturb and restore sweeps, leaving the single update axpy."""
    if name != "two_point":
        raise ValueError(f"estimator {name!r} is not yet ported")
    if forward_backend not in FORWARD_BACKENDS:
        raise ValueError(f"unknown forward_backend {forward_backend!r}; "
                         f"pick from {FORWARD_BACKENDS}")
    virtual = forward_backend != "materialized"
    sweeps = 1 if virtual else (3 if fused_update else 4)
    return {"forwards": 2, "axpy_sweeps": sweeps, "state_scalars": 0}
