"""Named experiment presets (copy of ``repro/api/presets.py``), so both
packages resolve a preset name to the same spec.

Part of the unified experiment-spec surface (DESIGN.md §11).
"""
import dataclasses
from typing import Dict

from repro_torch.api.spec import (Experiment, Estimator, Model, Optimizer,
                                  Run, Runtime, SpecError, Swarm)

# The paper's headline recipe at CPU-runnable scale: LeZO (75% of layers
# dropped per step) + two-point SPSA on the OPT stack.  This preset IS
# the legacy ``launch/train`` default surface — the bit-identity
# acceptance gate compares the two.
_LEZO_OPT13B = Experiment()

PRESETS: Dict[str, Experiment] = {
    # ``default`` is what every CLI command starts from when no --preset
    # is given; train and evaluate therefore agree on every shared field.
    "default": _LEZO_OPT13B,
    "lezo-opt13b": _LEZO_OPT13B,
    "mezo-opt13b": dataclasses.replace(
        _LEZO_OPT13B, optimizer=dataclasses.replace(
            _LEZO_OPT13B.optimizer, sparsity=0.0)),
    "fo-opt13b": dataclasses.replace(
        _LEZO_OPT13B, optimizer=dataclasses.replace(
            _LEZO_OPT13B.optimizer, mode="fo")),
    # fused virtual-perturbation runtime (DESIGN.md §10); virtual_ref is
    # the pure-JAX oracle so the preset runs on the CPU container too
    "lezo-opt13b-virtual": dataclasses.replace(
        _LEZO_OPT13B, runtime=dataclasses.replace(
            _LEZO_OPT13B.runtime, forward_backend="virtual_ref")),
    # FZOO-style batched multi-query estimator (DESIGN.md §6)
    "fzoo-opt13b-q16": dataclasses.replace(
        _LEZO_OPT13B, estimator=Estimator(name="one_sided", q=16)),
    "lezo-opt13b-lora": dataclasses.replace(
        _LEZO_OPT13B,
        optimizer=dataclasses.replace(_LEZO_OPT13B.optimizer,
                                      lr=3e-3, eps=1e-2),
        runtime=dataclasses.replace(_LEZO_OPT13B.runtime, peft="lora")),
    # CI bench-smoke: the benchmark-sized OPT variant at the sweep's
    # perturb-heavy params/token ratio (benchmarks/estimator_sweep.py)
    "bench-smoke": Experiment(
        model=Model(arch="opt-13b", variant="bench", seq_len=32),
        optimizer=Optimizer(lr=1e-4),
        # dense axpy backend: the benchmark suite's historical baseline
        runtime=Runtime(backend="dense"),
        run=Run(steps=120, batch_size=8, eval_every=0, log_every=0)),
    # fast-tier fixture: the 4L/128d CPU model, a handful of steps
    "tiny-smoke": Experiment(
        model=Model(arch="opt-13b", variant="tiny", seq_len=32),
        run=Run(steps=8, batch_size=8, eval_every=0, log_every=1)),
    # CI swarm-smoke: 2 local workers on the tiny model, enough steps
    # to cross a checkpoint so crash/rejoin is exercised (DESIGN.md §14)
    "swarm-smoke": Experiment(
        model=Model(arch="opt-13b", variant="tiny", seq_len=32),
        swarm=Swarm(workers=2),
        run=Run(steps=12, batch_size=8, eval_every=0, log_every=1)),
}


def names():
    return sorted(PRESETS)


def get(name: str) -> Experiment:
    if name not in PRESETS:
        raise SpecError("<preset>", f"unknown preset {name!r}; "
                                    f"known: {names()}")
    return PRESETS[name]
