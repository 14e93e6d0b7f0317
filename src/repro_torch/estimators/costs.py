"""Analytic per-step cost counts (copy of ``repro/estimators/costs.py``).

Per optimization step: ``forwards`` model forwards, ``axpy_sweeps``
full-parameter axpy passes (perturb / restore / update), and
``state_scalars`` optimizer state beyond the parameters.  These counts
are the contract the estimators honour (pinned by the port's tests and
by ``chip_smoke.py``'s launch counts).
"""
from __future__ import annotations

from typing import Dict

ESTIMATORS = ("two_point", "one_sided", "averaged", "importance")
FORWARD_BACKENDS = ("materialized", "virtual", "virtual_ref")
# the step the dry run lowers: launch/analysis.py projects from it
BASELINE = "two_point"


def step_counts(name: str, q: int = 1, fused_update: bool = True,
                inner: str = "two_point", num_layers: int = 0,
                forward_backend: str = "materialized") -> Dict:
    """Counts for estimator ``name`` with ``q`` directions.  Virtual
    probes remove every perturb and restore sweep, leaving the update
    sweeps; the forward count is unchanged."""
    if q < 1:
        raise ValueError(f"q must be >= 1, got {q}")
    if forward_backend not in FORWARD_BACKENDS:
        raise ValueError(f"unknown forward_backend {forward_backend!r}; "
                         f"pick from {FORWARD_BACKENDS}")
    virtual = forward_backend != "materialized"
    if name == "two_point":
        # perturb(+eps), perturb(-2eps), then fused restore+update — or
        # separate restore and update passes when unfused
        sweeps = 1 if virtual else (3 if fused_update else 4)
        return {"forwards": 2, "axpy_sweeps": sweeps, "state_scalars": 0}
    if name == "one_sided":
        # 1 baseline + q perturbed forwards; q perturb sweeps (zero when
        # virtual), q update sweeps
        return {"forwards": q + 1, "axpy_sweeps": q if virtual else 2 * q,
                "state_scalars": 0}
    if name == "averaged":
        # q two-point probes (+eps, -2eps, +eps restore; zero when
        # virtual) + q update sweeps
        return {"forwards": 2 * q, "axpy_sweeps": q if virtual else 4 * q,
                "state_scalars": 0}
    if name == "importance":
        if inner == "importance":
            raise ValueError("importance cannot wrap itself")
        c = dict(step_counts(inner, q=q, fused_update=fused_update,
                             forward_backend=forward_backend))
        c["state_scalars"] = c["state_scalars"] + num_layers
        return c
    raise ValueError(f"unknown estimator {name!r}; pick from {ESTIMATORS}")
