"""The task registry: SuperGLUE-style specs behind ``--task <name>``
(counterpart of ``repro/tasks/registry.py``, the same seven specs).

Seven built-in tasks — five classification (sst2, boolq, rte, wic, cb),
one multiple-choice (copa), one generative (squad_copy) — covering all
three metric protocols (accuracy, macro-F1, exact match) and both signal
families (lexicon / overlap, see generators.py).  ``register`` accepts
new specs at runtime, e.g. JSON-file-backed tasks built with
``generators.json_examples``.

Task registry & metric protocol (DESIGN.md §9).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.tasks import generators as g
from repro_torch.tasks.base import CompiledTask, TaskSpec, compile_task

TASKS: Dict[str, TaskSpec] = {}


def register(spec: TaskSpec, overwrite: bool = False) -> TaskSpec:
    if spec.name in TASKS and not overwrite:
        raise ValueError(f"task {spec.name!r} already registered")
    TASKS[spec.name] = spec
    return spec


def get(name: str) -> TaskSpec:
    if name not in TASKS:
        raise KeyError(f"unknown task {name!r}; known: {names()}")
    return TASKS[name]


def names() -> List[str]:
    return sorted(TASKS)


def classification_names() -> List[str]:
    return [n for n in names() if TASKS[n].kind == "classification"]


def build(name: str, vocab: int, seq_len: int, seed: int = 0) -> CompiledTask:
    """Compile a registered task against a model's (vocab, seq_len)."""
    return compile_task(get(name), vocab, seq_len, seed)


register(TaskSpec(
    name="sst2", kind="classification",
    template="review : {text} . sentiment :",
    generator=g.sst2_examples, verbalizers=("terrible", "great"),
    description="SST-2 stand-in: sentiment lexicon classification"))

register(TaskSpec(
    name="boolq", kind="classification",
    template="passage : {passage} . question : {question} ? answer :",
    generator=g.boolq_examples, verbalizers=("no", "yes"),
    description="BoolQ stand-in: passage-conditioned yes/no QA"))

register(TaskSpec(
    name="rte", kind="classification",
    template="premise : {premise} . hypothesis : {hypothesis} . entailed :",
    generator=g.rte_examples, verbalizers=("yes", "no"),
    description="RTE stand-in: entailment via hypothesis-premise overlap"))

register(TaskSpec(
    name="wic", kind="classification",
    template="word : {word} . first : {sentence1} . second : {sentence2} . same :",
    generator=g.wic_examples, verbalizers=("no", "yes"),
    description="WiC stand-in: same word sense across two contexts"))

register(TaskSpec(
    name="cb", kind="classification",
    template="premise : {premise} . hypothesis : {hypothesis} . label :",
    generator=g.cb_examples, verbalizers=("yes", "no", "maybe"),
    metric="macro_f1",
    description="CB stand-in: 3-way entailment, macro-F1 (imbalanced SuperGLUE protocol)"))

register(TaskSpec(
    name="copa", kind="multiple_choice",
    template="premise : {premise} . what is the {question} ?",
    generator=g.copa_examples, answer_len=4,
    description="COPA stand-in: pick the continuation coherent with the premise"))

register(TaskSpec(
    name="squad_copy", kind="generation",
    template="context : {context} . question : {question} ? answer :",
    generator=g.squad_copy_examples, answer_field="answer",
    metric="exact_match", answer_len=4,
    description="SQuAD stand-in: extract the span following a cue word"))
