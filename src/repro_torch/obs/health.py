"""Optimizer-health accumulator of the port (counterpart of
``repro/obs/health.py``): the ZO step's scalar vitals, sync-free.

A MeZO/LeZO step is fully determined by a handful of scalars — (seed,
projected gradient g, ε, lr, active-layer set) — so observing the
*optimizer* (is g's variance blowing up?  is LeZO starving a layer?  how
big are the updates?) costs almost nothing.

:class:`HealthAccumulator` keeps the reference's contract:

  * ``record(step, metrics, seed=...)`` keeps references to the step's
    values and converts nothing.  The port's ZO step already brings its
    scalars to the host (``estimators/base.py::host_f32``), so what it
    buffers are host values; a tensor (the FO loss) is buffered as is.
    It runs every step and adds no device synchronisation.
  * ``drain()`` turns everything buffered since the last drain into
    JSON-ready step rows (the ``obs.runlog`` stream format), bringing
    any buffered tensor to the host once.  The trainer calls it on the
    ``log_every`` boundary.
  * Running aggregates — Welford mean/variance of g, cumulative
    per-layer selection counts and last-active step under LeZO
    sparsity — update at drain time.
  * The update magnitude ``‖lr·g·z‖`` comes from the RNG-stream norm
    identity: ``‖Δθ‖ ≈ |lr|·sqrt(Σ_i g_i²·N_i)`` (N_i = active parameter
    count of direction i, E‖z‖² = N), recorded as ``update_norm_est``
    every step; with an exact ``norm_fn`` (``core/zo.tree_z_norm``, when
    ``telemetry.health_norms``) the literal ``|lr·g|·‖z(seed)‖`` is
    computed at drain time, off the hot path, as ``update_norm``.

Scalars are stored as float32 values (``float(np.float32(v))``): what
the step applied, as the reference records them.  ``metrics`` keys are
best-effort: a ``zo`` step emits all of them, ``zo_momentum`` and ``fo``
fewer; missing keys are absent from the row, never an error.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

# Step-metric keys the accumulator snapshots when present.
SCALAR_KEYS = ("loss", "projected_grad", "eps", "lr", "active_layers")
VECTOR_KEYS = ("probe_grads", "coeffs", "n_active_params", "layer_sel",
               "arrived")
# swarm shard rows (DESIGN.md §14): {shard: [l+, l-]} for arrived shards
DICT_KEYS = ("shard_losses",)


def _host(v):
    """A buffered value on the host: tensors through numpy, others as
    they are."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _host(x) for k, x in v.items()}
    return v


def _to_float_list(v) -> List[float]:
    return [float(x) for x in np.asarray(v, np.float32).reshape(-1)]


class HealthAccumulator:
    """Per-step optimizer vitals: sync-free record, batched drain."""

    def __init__(self, num_layers: int = 0, norm_fn=None):
        self.num_layers = int(num_layers)
        self.norm_fn = norm_fn      # optional (seed, layer_sel) -> ||z||
        self._pending: List = []
        self.rows: List[Dict[str, Any]] = []
        # Welford running stats over the per-step projected gradient.
        self.g_count = 0
        self.g_mean = 0.0
        self.g_m2 = 0.0
        # LeZO layer coverage: cumulative selections + last-active step.
        self.layer_counts = [0] * self.num_layers
        self.layer_last = [-1] * self.num_layers
        self.last_step = -1
        # swarm quorum accounting: steps that committed short-handed
        self.sharded_steps = 0
        self.straggler_steps = 0

    # ----------------------------------------------------------- record
    def record(self, step: int, metrics: Dict[str, Any],
               seed: Optional[int] = None):
        """Buffer the step's values.  Converts nothing, so it never
        syncs: tensors are brought to the host at the next :meth:`drain`."""
        keep = {k: metrics[k]
                for k in SCALAR_KEYS + VECTOR_KEYS + DICT_KEYS
                if k in metrics}
        self._pending.append((int(step), seed, keep))

    def __len__(self):
        return len(self._pending)

    # ------------------------------------------------------------ drain
    def drain(self) -> List[Dict[str, Any]]:
        """Bring everything buffered since the last drain to the host and
        return the new JSON-ready step rows."""
        if not self._pending:
            return []
        fetched = [_host(m) for _, _, m in self._pending]
        new_rows = []
        for (step, seed, _), vals in zip(self._pending, fetched):
            row: Dict[str, Any] = {"step": step}
            if seed is not None:
                row["seed"] = int(seed)
            for k in SCALAR_KEYS:
                if k in vals:
                    row[k] = float(np.float32(vals[k]))
            for k in ("probe_grads", "coeffs", "n_active_params"):
                if k in vals:
                    row[k] = _to_float_list(vals[k])
            if "layer_sel" in vals:
                row["layer_sel"] = [int(x) for x in vals["layer_sel"]]
            if "arrived" in vals:
                row["arrived"] = [int(x) for x in vals["arrived"]]
            if "shard_losses" in vals:
                row["shard_losses"] = {
                    str(k): [float(x) for x in v]
                    for k, v in vals["shard_losses"].items()}
            if "active_layers" in row:
                row["active_layers"] = int(row["active_layers"])
            self._aggregate(row)
            new_rows.append(row)
        self._pending.clear()
        self.rows.extend(new_rows)
        return new_rows

    def _aggregate(self, row: Dict[str, Any]):
        step = row["step"]
        self.last_step = max(self.last_step, step)
        g = row.get("projected_grad")
        if g is not None and math.isfinite(g):
            self.g_count += 1
            d = g - self.g_mean
            self.g_mean += d / self.g_count
            self.g_m2 += d * (g - self.g_mean)
            row["g_mean"] = self.g_mean
            row["g_var"] = self.g_var
        arrived = row.get("arrived")
        if arrived is not None:
            self.sharded_steps += 1
            if any(a == 0 for a in arrived):
                self.straggler_steps += 1
        sel = row.get("layer_sel")
        if sel is not None and len(sel) == self.num_layers:
            for i, n in enumerate(sel):
                if n > 0:
                    self.layer_counts[i] += n
                    self.layer_last[i] = step
        # update magnitude via the RNG-stream norm identity
        coeffs = row.get("coeffs")
        lr = row.get("lr")
        if coeffs is not None and lr is not None:
            n_act = row.get("n_active_params")
            if n_act is not None and len(n_act) == len(coeffs):
                row["update_norm_est"] = abs(lr) * math.sqrt(
                    sum(c * c * n for c, n in zip(coeffs, n_act)))
            if (self.norm_fn is not None and len(coeffs) == 1
                    and "seed" in row and sel is not None):
                row["update_norm"] = abs(lr * coeffs[0]) * float(
                    self.norm_fn(row["seed"], sel))
        return row

    # ---------------------------------------------------------- summary
    @property
    def g_var(self) -> float:
        return self.g_m2 / (self.g_count - 1) if self.g_count > 1 else 0.0

    def staleness(self) -> List[int]:
        """Steps since each layer was last selected (-1: never)."""
        return [-1 if last < 0 else self.last_step - last
                for last in self.layer_last]

    def summary(self) -> Dict[str, Any]:
        losses = [r["loss"] for r in self.rows if "loss" in r]
        out: Dict[str, Any] = {
            "steps_recorded": len(self.rows),
            "last_step": self.last_step,
            "g_count": self.g_count,
            "g_mean": self.g_mean,
            "g_var": self.g_var,
            "loss_first": losses[0] if losses else None,
            "loss_last": losses[-1] if losses else None,
        }
        if self.num_layers:
            out["layer_counts"] = list(self.layer_counts)
            out["layer_staleness"] = self.staleness()
            out["layers_never_selected"] = sum(
                1 for c in self.layer_counts if c == 0)
        norms = [r["update_norm_est"] for r in self.rows
                 if "update_norm_est" in r]
        if norms:
            out["update_norm_est_last"] = norms[-1]
        if self.sharded_steps:
            out["sharded_steps"] = self.sharded_steps
            out["straggler_steps"] = self.straggler_steps
        return out
