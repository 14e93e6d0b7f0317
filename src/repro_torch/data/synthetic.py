"""Synthetic fine-tuning streams (copy of ``repro/data/synthetic.py``).

The canonical batch format ``{tokens, labels, loss_mask, class_labels}``
as numpy arrays, made by the same numpy-seeded generators as the
reference, so both packages train on the same batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    name: str = "classification"
    kind: str = "classification"   # classification | multiple_choice | generation
    vocab: int = 512
    seq_len: int = 64
    n_classes: int = 2
    signal_rate: float = 0.25      # fraction of context positions carrying signal
    answer_len: int = 8            # generation only
    seed: int = 0

    @property
    def verbalizers(self) -> np.ndarray:
        # reserve the top token ids as class verbalizers / query marker
        return np.arange(self.vocab - 1 - self.n_classes, self.vocab - 1)

    @property
    def query_token(self) -> int:
        return self.vocab - 1


def make_dataset(task: TaskConfig, n: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(task.seed)
    V, S = task.vocab, task.seq_len
    base_vocab = V - 1 - task.n_classes          # ids usable as filler
    tokens = rng.integers(0, base_vocab // 2, size=(n, S))
    labels_cls = rng.integers(0, task.n_classes, size=(n,))
    loss_mask = np.zeros((n, S - 1), np.float32)

    if task.kind in ("classification", "multiple_choice"):
        # class-conditional signal tokens scattered through the context
        for c in range(task.n_classes):
            rows = labels_cls == c
            sig = rng.random((rows.sum(), S)) < task.signal_rate
            sig_tokens = base_vocab // 2 + c * (base_vocab // (2 * task.n_classes)) \
                + rng.integers(0, base_vocab // (2 * task.n_classes),
                               size=(rows.sum(), S))
            tokens[rows] = np.where(sig, sig_tokens, tokens[rows])
        tokens[:, -2] = task.query_token
        tokens[:, -1] = task.verbalizers[labels_cls]
        # labels[t] = tokens[t+1]: the verbalizer (position S-1) is
        # predicted at label index S-2 — the last one.
        loss_mask[:, -1] = 1.0
    elif task.kind == "generation":
        A = task.answer_len
        span_start = rng.integers(4, S - 3 * A, size=(n,))
        for i in range(n):
            span = tokens[i, span_start[i]:span_start[i] + A]
            tokens[i, -A - 1] = task.query_token
            tokens[i, -A:] = span
        loss_mask[:, -A:] = 1.0                    # predict the copied span
    else:
        raise ValueError(task.kind)

    inputs = tokens[:, :-1].astype(np.int32)
    labels = tokens[:, 1:].astype(np.int32)
    return {"tokens": inputs, "labels": labels, "loss_mask": loss_mask,
            "class_labels": labels_cls.astype(np.int32)}


def batches(dataset: Dict[str, np.ndarray], batch_size: int, steps: int,
            seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite shuffled batch stream (with-replacement epochs)."""
    n = dataset["tokens"].shape[0]
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        idx = rng.integers(0, n, size=(batch_size,))
        yield {k: v[idx] for k, v in dataset.items()}


def classification_accuracy(cfg_model, params, dataset, task: TaskConfig,
                            lm_module, max_examples: int = 256) -> float:
    """Argmax-over-verbalizers accuracy at the answer position."""
    import torch
    n = min(max_examples, dataset["tokens"].shape[0])
    dev = params["embed"]["tok"].device
    toks = torch.as_tensor(dataset["tokens"][:n], device=dev)
    with torch.no_grad():
        hidden = lm_module.forward(cfg_model, params, toks)
        logits = lm_module.logits_fn(cfg_model, params, hidden[:, -1])
    verb = torch.as_tensor(task.verbalizers, device=dev)
    pred = torch.argmax(logits[:, verb], dim=-1).cpu().numpy()
    return float(np.mean(pred == dataset["class_labels"][:n]))
