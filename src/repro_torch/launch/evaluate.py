"""Task evaluation launcher (counterpart of ``repro/launch/evaluate.py``):
a shim over the port's spec CLI, ``python -m repro_torch.launch
evaluate``.

Modes:
  * ``--mode zeroshot``  score freshly-initialized params (the baseline
    every fine-tuning number in the paper is reported against);
  * ``--mode train``     run a ZO/FO fine-tune first, then report both
    zero-shot and post-train metrics (best parameters, selected on the
    task metric — the SuperGLUE protocol);
  * ``--ckpt-dir <d>``   restore the latest checkpoint from a previous
    train run and score it (post-train without re-training).

``--task all`` sweeps every registered task into one report, JSON on
stdout (and ``--out <path>``): one record per task with the metric
protocol name, zero-shot / post-train values, val loss, and the full
experiment spec that produced it.
"""
from __future__ import annotations

import sys
from typing import Optional

from repro_torch import api
from repro_torch.launch import cli


def evaluate_task(task_name: str, arch: str = "opt-13b",
                  variant: str = "smoke", mode: str = "zeroshot",
                  steps: Optional[int] = None,
                  batch_size: Optional[int] = None,
                  lr: Optional[float] = None, eps: Optional[float] = None,
                  sparsity: Optional[float] = None,
                  estimator: Optional[str] = None, q: Optional[int] = None,
                  seq_len: Optional[int] = None, n_examples: int = 256,
                  seed: int = 0, ckpt_dir: Optional[str] = None,
                  device=None) -> dict:
    """One task's metric report dict (the CLI emits a list of these):
    ``api.evaluate`` on the ``default`` preset with these overrides
    (``None`` keeps the preset's value); ``device`` None is the card."""
    overrides = {
        "task.name": task_name, "model.arch": arch,
        "model.variant": variant,
        "run.seed": seed, "run.ckpt_dir": ckpt_dir,
    }
    for path, val in (("model.seq_len", seq_len),
                      ("run.steps", steps), ("run.batch_size", batch_size),
                      ("optimizer.lr", lr), ("optimizer.eps", eps),
                      ("optimizer.sparsity", sparsity),
                      ("estimator.name", estimator), ("estimator.q", q)):
        if val is not None:
            overrides[path] = val
    spec = api.with_overrides(api.presets.get("default"), overrides)
    return api.evaluate(spec, mode=mode, n_examples=n_examples,
                        device=device)


def main(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    return cli.main(["evaluate"] + argv)


if __name__ == "__main__":
    main()
