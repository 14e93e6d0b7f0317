"""Experiment API of the port (counterpart of ``repro/api``)::

    from repro_torch import api

    spec = api.with_overrides(api.preset("lezo-opt13b"), {
        "model.variant": "full", "runtime.backend": "pallas",
        "runtime.forward_backend": "virtual"})
    result = api.run(spec)            # on the card; device="cpu" for CPU
    report = api.evaluate(api.with_overrides(spec, {"task.name": "sst2"}))

A spec JSON written by ``repro.api.to_json`` runs unchanged here.
"""
from repro_torch.api import presets
from repro_torch.api.presets import PRESETS
from repro_torch.api.runners import Derived, derive, evaluate, run, sweep
from repro_torch.api.spec import (Experiment, Estimator, Model, Optimizer,
                                  Run, Runtime, Serving, SpecError, Swarm,
                                  Task, Telemetry, check_resume_spec,
                                  from_dict, from_json, to_dict, to_json,
                                  with_overrides)
from repro_torch.api.validate import validate

__all__ = ["Derived", "Estimator", "Experiment", "Model", "Optimizer",
           "PRESETS", "Run", "Runtime", "Serving", "SpecError", "Swarm",
           "Task", "Telemetry", "check_resume_spec", "derive", "evaluate",
           "from_dict", "from_json", "preset", "presets", "run", "sweep",
           "to_dict", "to_json", "validate", "with_overrides"]


def preset(name: str) -> Experiment:
    return presets.get(name)
