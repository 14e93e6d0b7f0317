"""``launch replay`` of the port (counterpart of
``repro/launch/replay.py``): re-execute a recorded ZO run, bit for bit.

A MeZO/LeZO step is fully determined by scalars — (base_seed, step
index, projected gradient g, ε, lr) — because z and the LeZO layer
selection regenerate from the counter RNG.  A run directory
(``obs.runlog``) records exactly those scalars, so a recorded run can be
re-executed and checked bit for bit:

  1. rebuild the trainer from the run's ``spec.json`` on the device the
     caller asks for (the card by default, like every entry point);
  2. check the recorded seed lineage (``seed_t = fold(base_seed, t)``);
  3. re-execute the steps through the trainer's own ``_step`` — from the
     newest usable checkpoint, or from the run's initial parameters —
     regenerating each step's batch through the data path ``train()``
     uses, and compare every recorded scalar of every step up to ``k``
     (loss, g per probe, coefficients, active parameter counts, ε, lr,
     layer selection; on a swarm run also the quorum mask ``arrived``,
     with which a sharded step is re-executed, and the per-shard
     ``shard_losses``) as float32 bits;
  4. wherever a checkpoint falls inside the replayed range, compare the
     re-executed parameters with it bitwise.

The initial parameters are the trainer's seeded random weights, or the
``params`` the caller passes (the weights the run was given through
``api.run(spec, params=...)``; they are updated in place).  Any
corruption of the run log (a flipped g bit, an edited loss) or any
nondeterminism in the step surfaces as a mismatch in ``failures``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import rng
from repro_torch.obs import runlog

# metric keys compared float32-bitwise between the recorded row and the
# re-executed step (missing on either side = skipped, e.g. layer_sel on
# a flat tree)
_COMPARE_SCALARS = ("loss", "projected_grad", "eps", "lr")
_COMPARE_VECTORS = ("probe_grads", "coeffs", "n_active_params")


def _f32(v) -> np.ndarray:
    return np.asarray(v, np.float32)


def _compare_row(t: int, row: Dict, metrics: Dict,
                 failures: List[str]) -> Dict[str, Any]:
    """float32-bitwise compare of one recorded row with the re-executed
    step's metrics."""
    matched: Dict[str, Any] = {}
    for key in _COMPARE_SCALARS:
        if key in row and key in metrics:
            rec, new = _f32(row[key]), _f32(metrics[key])
            matched[key] = float(new)
            if rec.tobytes() != new.tobytes():
                failures.append(
                    f"step {t} {key}: recorded {float(rec)!r} != "
                    f"re-executed {float(new)!r}")
    for key in _COMPARE_VECTORS:
        if key in row and key in metrics:
            rec = _f32(row[key]).reshape(-1)
            new = _f32(metrics[key]).reshape(-1)
            matched[key] = [float(x) for x in new]
            if rec.shape != new.shape or rec.tobytes() != new.tobytes():
                failures.append(
                    f"step {t} {key}: recorded {rec.tolist()!r} != "
                    f"re-executed {new.tolist()!r}")
    # swarm rows (DESIGN.md §14) add the quorum mask ``arrived`` and the
    # per-shard ±εz losses the commit was reduced over — a degraded step
    # replays with the recorded mask, so the shard sets match exactly
    for key in ("layer_sel", "active_layers", "arrived"):
        if key in row and key in metrics:
            rec = np.asarray(row[key], np.int64).reshape(-1)
            new = np.asarray(metrics[key], np.int64).reshape(-1)
            matched[key] = (int(new[0]) if key == "active_layers"
                            else new.tolist())
            if not np.array_equal(rec, new):
                failures.append(f"step {t} {key}: recorded {rec.tolist()!r}"
                                f" != re-executed {new.tolist()!r}")
    if "shard_losses" in row and "shard_losses" in metrics:
        rec_sl = {str(kk): _f32(v) for kk, v in row["shard_losses"].items()}
        new_sl = {str(kk): _f32(v)
                  for kk, v in metrics["shard_losses"].items()}
        matched["shard_losses"] = {kk: [float(x) for x in v]
                                   for kk, v in new_sl.items()}
        if sorted(rec_sl) != sorted(new_sl):
            failures.append(
                f"step {t} shard_losses: recorded shards "
                f"{sorted(rec_sl)} != re-executed {sorted(new_sl)}")
        else:
            for kk in sorted(rec_sl):
                if rec_sl[kk].tobytes() != new_sl[kk].tobytes():
                    failures.append(
                        f"step {t} shard_losses[{kk}]: recorded "
                        f"{rec_sl[kk].tolist()!r} != re-executed "
                        f"{new_sl[kk].tolist()!r}")
    return matched


def _bits(t: torch.Tensor) -> bytes:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def replay_run(run: Optional[str] = None, step: Optional[int] = None,
               runs_root: str = runlog.DEFAULT_RUNS_DIR, device=None,
               params=None) -> Dict[str, Any]:
    """Verify ``run`` through step ``step`` (default: the last recorded)
    on ``device`` (None = the card).  ``params`` (an ``lm.LM``) replaces
    the seeded initial weights, as in ``api.run``.

    Returns a report dict; ``report["failures"]`` is empty iff every
    recorded scalar of every replayed step matched the re-execution bit
    for bit (and the re-executed parameters matched every checkpoint in
    range)."""
    from repro_torch import api
    from repro_torch import tasks as tasks_mod
    from repro_torch.data import synthetic
    from repro_torch.train.trainer import Trainer, host_copy

    rd = runlog.load_run(run, runs_root)
    if rd.spec is None:
        raise FileNotFoundError(f"{rd.dir}: no spec.json — cannot replay")
    if not rd.steps:
        raise ValueError(f"{rd.dir}: no recorded steps in steps.jsonl")
    spec = api.from_dict(rd.spec)
    if spec.optimizer.mode != "zo":
        raise ValueError(
            f"replay covers optimizer.mode='zo' runs; this run used "
            f"{spec.optimizer.mode!r} (momentum/adam state is not part of "
            "the recorded scalar stream)")
    # replaying must not write a fresh run dir or trace
    spec = dataclasses.replace(spec, telemetry=api.Telemetry())

    k = rd.last_step if step is None else int(step)
    rows = {r["step"]: r for r in rd.steps}
    if k not in rows:
        raise KeyError(f"run {rd.run_id!r} has no recorded step {k} "
                       f"(steps {rd.first_step}..{rd.last_step})")

    failures: List[str] = []
    checks: List[str] = []

    trainer = Trainer.from_spec(spec, device=device, params=params)
    tcfg = trainer.tcfg
    base_seed = rng.fold_py(tcfg.seed, 0xC0FFEE)

    # ---- seed lineage: every recorded seed must be fold(base_seed, t)
    for t in sorted(rows):
        want = rng.fold_py(base_seed, t)
        got = rows[t].get("seed")
        if got != want:
            failures.append(
                f"seed lineage broken at step {t}: recorded {got}, "
                f"fold(base_seed={base_seed}, {t}) = {want}")
    checks.append(f"seed lineage over {len(rows)} recorded steps")

    # ---- the start point.  Stateless estimators (all but importance's
    # scores) fast-forward to the newest checkpoint <= k; a stateful one
    # re-warms its state from the run's first recorded step, as the run
    # itself did (estimator state is never checkpointed).
    first = rd.first_step
    stateless = trainer.state == {}
    ckpt_steps = (set(trainer.ckpt.all_steps())
                  if trainer.ckpt is not None else set())
    usable = [s for s in ckpt_steps if first <= s <= k]
    if stateless and usable:
        start_t = max(usable)
    elif first in ckpt_steps | {0}:
        start_t = first
    else:
        raise ValueError(
            f"run {rd.run_id!r} records steps {first}..{rd.last_step} "
            f"but no usable checkpoint exists under {tcfg.ckpt_dir!r} — "
            f"cannot reconstruct parameters at step {first}")
    params = trainer.params
    if start_t != 0:
        trainer.ckpt.restore(params, step=start_t)
    missing = [t for t in range(start_t, k + 1) if t not in rows]
    if missing:
        raise ValueError(f"run {rd.run_id!r}: steps {missing} missing from "
                         "the recorded stream — cannot replay through them")

    # ---- re-execute steps start_t..k through the trainer's own step
    # over the regenerated data stream, checking each recorded row
    train_data = trainer.make_dataset(4096)
    stream_data = {kk: v for kk, v in train_data.items()
                   if kk in tasks_mod.MODEL_BATCH_KEYS}
    stream = synthetic.batches(stream_data, tcfg.batch_size, tcfg.steps,
                               seed=tcfg.seed + 7)
    state = trainer.state
    matched: Dict[str, Any] = {}
    ckpt_hits = []
    done = False
    for t, np_batch in enumerate(stream):
        if t < start_t:
            continue
        if t > k:
            done = True
            break
        batch = trainer._model_batch(np_batch)
        if getattr(trainer._step, "sharded", False):
            # swarm runs re-execute with the recorded quorum mask, so a
            # short-handed commit reduces the very same shard subset
            params, state, metrics = trainer._step(
                params, state, batch, t, base_seed,
                arrived=rows[t].get("arrived"))
        else:
            params, state, metrics = trainer._step(params, state, batch, t,
                                                   base_seed)
        matched = _compare_row(t, rows[t], metrics, failures)
        # a checkpoint inside the replayed range pins the parameter bits
        if (t + 1) in ckpt_steps and (t + 1) <= k:
            ck = host_copy(params)
            trainer.ckpt.restore(ck, step=t + 1)
            got = host_copy(params)
            bad = sum(_bits(ck[p]) != _bits(got[p]) for p in got)
            if bad:
                failures.append(
                    f"re-executed params at step {t + 1} differ from "
                    f"checkpoint {t + 1} on {bad} leaves")
            else:
                ckpt_hits.append(t + 1)
        if t == k:
            done = True
            break
    if not done:
        raise ValueError(f"step {k} beyond the run's {tcfg.steps}-step "
                         "data stream")
    checks.append(
        f"re-executed steps {start_t}..{k} through the trainer's step "
        "(regenerated batches) and compared every recorded scalar "
        "float32-bitwise")
    if ckpt_hits:
        checks.append("re-executed params bitwise equal checkpoints "
                      f"{ckpt_hits}")

    return {
        "run_id": rd.run_id,
        "run_dir": rd.dir,
        "step": k,
        "estimator": spec.estimator.name,
        "forward_backend": spec.runtime.forward_backend,
        "device": str(trainer.device),
        "param_start": start_t,
        "checks": checks,
        "matched": matched,
        "failures": failures,
        "ok": not failures,
        "final_params": params,
    }
