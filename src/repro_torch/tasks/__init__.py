"""SuperGLUE-style task & evaluation subsystem of the port (counterpart of
``repro/tasks``; DESIGN.md §9).

    spec = tasks.get("sst2")                      # declarative TaskSpec
    task = tasks.build("sst2", vocab=512, seq_len=64)
    data = task.make_dataset(4096)                # synthetic-batch format
    acc  = task.evaluate(mcfg, params, data, lm)  # task's primary metric

with ``lm`` the port's ``repro_torch.models.lm``.

Tasks compile down to the exact batch dict ``data/synthetic.py``
produces, so the model stack, kernels, and estimators never see the
difference; ``train.Trainer`` and ``launch/evaluate.py`` consume the
metric protocol.
"""
from repro_torch.tasks.base import (CompiledTask, KINDS, METRICS,
                                    MODEL_BATCH_KEYS, TaskSpec, compile_task)
from repro_torch.tasks.generators import json_examples
from repro_torch.tasks.registry import (TASKS, build, classification_names,
                                        get, names, register)
from repro_torch.tasks import metrics, vocab

__all__ = ["CompiledTask", "KINDS", "METRICS", "MODEL_BATCH_KEYS", "TASKS",
           "TaskSpec", "build", "classification_names", "compile_task",
           "get", "json_examples", "metrics", "names", "register", "vocab"]
