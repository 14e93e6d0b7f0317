"""Declarative task specs and their compilation to model batches (counterpart
of ``repro/tasks/base.py``: the same specs compile to the same arrays).

A :class:`TaskSpec` is the whole task as data: prompt template,
verbalizer words / choice continuations, example generator, and metric.
:func:`compile_task` binds it to a model's (vocab, seq_len) and returns a
:class:`CompiledTask` whose ``make_dataset`` emits exactly the batch
format ``data/synthetic.py`` established — ``{tokens, labels, loss_mask,
class_labels}`` (+ per-choice arrays for multiple choice) — so the model,
trainer loss, kernels, and estimators are untouched by the new subsystem.

Sequence layout (full length S; inputs = full[:, :-1], labels =
full[:, 1:], as everywhere else in the repo):

  classification    [pad ... prompt] [QUERY] [verbalizer]
  multiple_choice   [pad ... prompt] [QUERY] [continuation, A tokens]
  generation        [pad ... prompt] [QUERY] [answer, A tokens]

Prompts are right-aligned (truncated from the front) so the tokens
nearest the answer survive truncation; continuations/answers are
left-aligned and PAD-padded, with the loss/score mask excluding PAD.

Task registry & metric protocol (DESIGN.md §9).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.tasks import metrics as metrics_mod
from repro_torch.tasks import vocab as vb
from repro_torch.tasks.generators import Generator

KINDS = ("classification", "multiple_choice", "generation")
METRICS = ("accuracy", "macro_f1", "exact_match")
# Keys a model/loss batch may contain; everything else is eval-side only.
MODEL_BATCH_KEYS = ("tokens", "labels", "loss_mask", "embeds")


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """One SuperGLUE-style task, declaratively."""
    name: str
    kind: str                      # classification | multiple_choice | generation
    template: str                  # "{field}"-style prompt template
    generator: Generator           # fn(seed, n) -> list of example dicts
    verbalizers: Tuple[str, ...] = ()   # classification: one word per class
    choices_field: str = "choices"      # multiple_choice: field with k strings
    answer_field: str = "answer"        # generation: field with the gold span
    metric: str = "accuracy"
    answer_len: int = 4            # continuation/answer token budget
    description: str = ""

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"{self.name}: unknown kind {self.kind!r}")
        if self.metric not in METRICS:
            raise ValueError(f"{self.name}: unknown metric {self.metric!r}")
        if self.kind == "classification" and len(self.verbalizers) < 2:
            raise ValueError(f"{self.name}: classification needs >=2 verbalizers")

    @property
    def n_classes(self) -> int:
        return len(self.verbalizers) if self.kind == "classification" else 2


class CompiledTask:
    """A TaskSpec bound to (vocab, seq_len): dataset factory + metric."""

    def __init__(self, spec: TaskSpec, vocab: int, seq_len: int, seed: int = 0):
        if seq_len < spec.answer_len + 8:
            raise ValueError(f"{spec.name}: seq_len {seq_len} too short")
        self.spec, self.vocab, self.seq_len, self.seed = spec, vocab, seq_len, seed
        self.verb_ids = np.array([vb.verbalizer_id(vocab, i)
                                  for i in range(len(spec.verbalizers))],
                                 np.int32)

    # convenience mirrors of the spec
    name = property(lambda self: self.spec.name)
    kind = property(lambda self: self.spec.kind)
    metric = property(lambda self: self.spec.metric)

    # ------------------------------------------------------------ compile
    def _prompt_ids(self, ex: Dict) -> Sequence[int]:
        return vb.encode(self.spec.template.format(**ex), self.vocab)

    @staticmethod
    def _right_align(ids, width):
        """Prompts truncate from the front: tokens nearest the answer
        survive."""
        out = np.full((width,), vb.PAD, np.int64)
        ids = ids[-width:]
        out[width - len(ids):] = ids
        return out

    def _answer_ids(self, text: str, A: int, what: str, i: int):
        """Continuation/answer tokens, left-aligned into A slots.  Empty
        or over-length spans are rejected: an all-PAD continuation would
        out-score every real (negative log-prob) choice, and silent
        truncation can make two distinct choices compile identically."""
        ids = vb.encode(str(text), self.vocab)
        if not ids:
            raise ValueError(
                f"{self.spec.name}: example {i} has an empty {what}")
        if len(ids) > A:
            raise ValueError(
                f"{self.spec.name}: example {i} {what} is {len(ids)} tokens "
                f"but answer_len={A}; raise TaskSpec.answer_len")
        out = np.full((A,), vb.PAD, np.int64)
        out[:len(ids)] = ids
        return out

    def make_dataset(self, n: int, seed: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Compile n generated examples to the synthetic-batch format."""
        spec, S, V = self.spec, self.seq_len, self.vocab
        seed = self.seed if seed is None else seed
        examples = spec.generator(seed, n)

        full = np.full((n, S), vb.PAD, np.int64)
        loss_mask = np.zeros((n, S - 1), np.float32)
        class_labels = np.array([int(ex.get("label", 0)) for ex in examples],
                                np.int32)
        extras: Dict[str, np.ndarray] = {}

        if spec.kind == "classification":
            for i, ex in enumerate(examples):
                full[i, :S - 2] = self._right_align(self._prompt_ids(ex), S - 2)
            full[:, S - 2] = vb.query_token(V)
            full[:, S - 1] = self.verb_ids[class_labels]
            loss_mask[:, -1] = 1.0
        elif spec.kind in ("multiple_choice", "generation"):
            A = spec.answer_len
            W = S - 1 - A                       # prompt width; full[W] = QUERY
            full[:, W] = vb.query_token(V)
            if spec.kind == "multiple_choice":
                k = len(examples[0][spec.choices_field])
                ragged = [i for i, ex in enumerate(examples)
                          if len(ex[spec.choices_field]) != k]
                if ragged:
                    # an all-PAD phantom choice would out-score every real
                    # (negative log-prob) continuation, so reject up front
                    raise ValueError(
                        f"{spec.name}: all examples need exactly {k} "
                        f"choices; examples {ragged[:5]} differ")
                cont = np.full((n, k, A), vb.PAD, np.int64)
                for i, ex in enumerate(examples):
                    full[i, :W] = self._right_align(self._prompt_ids(ex), W)
                    for j, choice in enumerate(ex[spec.choices_field]):
                        cont[i, j] = self._answer_ids(choice, A, f"choice {j}", i)
                gold = cont[np.arange(n), class_labels]
                # all k candidate sequences, for continuation scoring
                cand = np.repeat(full[:, None], k, axis=1)
                cand[:, :, W + 1:] = cont
                extras["choice_inputs"] = cand[:, :, :-1].astype(np.int32)
                extras["choice_labels"] = cand[:, :, 1:].astype(np.int32)
                cmask = np.zeros((n, k, S - 1), np.float32)
                cmask[:, :, W:] = (cont != vb.PAD)
                extras["choice_mask"] = cmask
            else:
                gold = np.full((n, A), vb.PAD, np.int64)
                for i, ex in enumerate(examples):
                    full[i, :W] = self._right_align(self._prompt_ids(ex), W)
                    gold[i] = self._answer_ids(ex[spec.answer_field], A,
                                               "answer", i)
            full[:, W + 1:] = gold
            loss_mask[:, W:] = (gold != vb.PAD)   # label idx W+j predicts gold[j]
        else:  # pragma: no cover - guarded in TaskSpec.__post_init__
            raise ValueError(spec.kind)

        return {"tokens": full[:, :-1].astype(np.int32),
                "labels": full[:, 1:].astype(np.int32),
                "loss_mask": loss_mask, "class_labels": class_labels, **extras}

    # --------------------------------------------------------------- eval
    def predict(self, mcfg, params, dataset, lm_module, max_examples=256,
                chunk=metrics_mod.CHUNK):
        """Per-example predictions: class ids, or (for generation) EM
        hits; scored ``chunk`` examples a forward."""
        n = min(max_examples, dataset["tokens"].shape[0])
        if self.kind == "classification":
            return metrics_mod.verbalizer_predict(
                mcfg, params, dataset["tokens"][:n], self.verb_ids, lm_module,
                chunk)
        if self.kind == "multiple_choice":
            scores = metrics_mod.choice_scores(
                mcfg, params, dataset["choice_inputs"][:n],
                dataset["choice_labels"][:n], dataset["choice_mask"][:n],
                lm_module, chunk)
            return np.argmax(scores, axis=-1)
        return metrics_mod.exact_match_hits(
            mcfg, params, dataset["tokens"][:n], dataset["labels"][:n],
            dataset["loss_mask"][:n], lm_module, chunk)

    def evaluate(self, mcfg, params, dataset, lm_module,
                 max_examples: int = 256, chunk=metrics_mod.CHUNK) -> float:
        """The task's primary metric on (up to) max_examples rows."""
        n = min(max_examples, dataset["tokens"].shape[0])
        pred = np.asarray(self.predict(mcfg, params, dataset, lm_module, n,
                                       chunk))
        gold = np.asarray(dataset["class_labels"][:n])
        if self.metric == "exact_match":
            return metrics_mod.exact_match(pred)  # pred is per-row EM already
        if self.metric == "macro_f1":
            return metrics_mod.macro_f1(pred, gold, self.spec.n_classes)
        return metrics_mod.accuracy(pred, gold)


def compile_task(spec: TaskSpec, vocab: int, seq_len: int,
                 seed: int = 0) -> CompiledTask:
    return CompiledTask(spec, vocab, seq_len, seed)
