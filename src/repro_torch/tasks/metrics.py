"""Task metrics over logit-scored verbalizers and choice continuations
(counterpart of ``repro/tasks/metrics.py``).

Three scoring modes, matching how MeZO-style prompt fine-tuning is
evaluated (DESIGN.md §9):

  * verbalizer argmax — classification: logits at the answer position,
    restricted to the task's verbalizer token ids;
  * continuation log-likelihood — multiple choice: length-normalized
    sum of per-token log-probs over each candidate continuation;
  * teacher-forced exact match — generation: argmax at every answer
    position must equal the gold token.

Aggregates (accuracy, macro-F1, exact match) are plain numpy over the
per-example predictions, copied from the reference.  Model scoring runs
the port's ``models.lm.forward`` and ``logits_fn`` (kernel K2 on the
card) under no-grad, over chunks of ``chunk`` examples: at OPT-13B the
full float32 logits of 256 two-choice examples are 6.5 GB, and the
log-softmax doubles that.  Chunking changes no prediction (each row's
scores depend on that row alone).
"""
from __future__ import annotations

import numpy as np
import torch

CHUNK = 32          # examples per scored forward


def accuracy(pred: np.ndarray, gold: np.ndarray) -> float:
    return float(np.mean(pred == gold))


def macro_f1(pred: np.ndarray, gold: np.ndarray, n_classes: int) -> float:
    """Unweighted mean of per-class F1 (classes absent from both sides
    contribute 0, the sklearn zero_division=0 convention)."""
    f1s = []
    for c in range(n_classes):
        tp = float(np.sum((pred == c) & (gold == c)))
        fp = float(np.sum((pred == c) & (gold != c)))
        fn = float(np.sum((pred != c) & (gold == c)))
        denom = 2 * tp + fp + fn
        f1s.append(2 * tp / denom if denom > 0 else 0.0)
    return float(np.mean(f1s))


def exact_match(pred_rows: np.ndarray) -> float:
    return float(np.mean(pred_rows))


# -------------------------------------------------------- model scoring
def _chunks(n: int, chunk):
    """[a, b) ranges of at most ``chunk`` examples (falsy: all at once)."""
    step = max(1, chunk or n)
    return [(a, min(a + step, n)) for a in range(0, n, step)]


@torch.no_grad()
def logits(mcfg, params, inputs, lm_module, last_only: bool = False):
    """float32 logits of ``inputs`` (B, S) int: (B, S, V), or (B, V) at
    the last position only (the reference's ``_logits_runner``)."""
    dev = params["embed"]["tok"].device
    toks = torch.as_tensor(np.asarray(inputs), device=dev)
    hidden = lm_module.forward(mcfg, params, toks)
    hidden = hidden[:, -1] if last_only else hidden
    return lm_module.logits_fn(mcfg, params, hidden)


def verbalizer_logits(mcfg, params, inputs, verb_ids, lm_module,
                      chunk=CHUNK) -> torch.Tensor:
    """(n, n_verbalizers) float32 logits at the answer position."""
    verb = torch.as_tensor(np.asarray(verb_ids, np.int64))
    out = []
    for a, b in _chunks(len(inputs), chunk):
        lg = logits(mcfg, params, inputs[a:b], lm_module, last_only=True)
        out.append(lg[:, verb.to(lg.device)])
    return torch.cat(out)


def verbalizer_predict(mcfg, params, inputs, verb_ids, lm_module,
                       chunk=CHUNK) -> np.ndarray:
    """Argmax over verbalizer logits at the answer position -> class ids."""
    lg = verbalizer_logits(mcfg, params, inputs, verb_ids, lm_module, chunk)
    return torch.argmax(lg, dim=-1).cpu().numpy()


@torch.no_grad()
def choice_scores(mcfg, params, choice_inputs, choice_labels, choice_mask,
                  lm_module, chunk=CHUNK) -> np.ndarray:
    """Length-normalized continuation log-prob for each of k choices.

    choice_inputs/labels: (n, k, S-1) int32; choice_mask: (n, k, S-1).
    Returns (n, k) float32 scores.
    """
    n, k, s = choice_inputs.shape
    out = []
    for a, b in _chunks(n, chunk):
        lg = logits(mcfg, params, choice_inputs[a:b].reshape(-1, s),
                    lm_module)
        logp = torch.log_softmax(lg, dim=-1)
        del lg
        y = torch.as_tensor(choice_labels[a:b].reshape(-1, s),
                            device=logp.device).to(torch.int64)
        gold = torch.gather(logp, -1, y[..., None])[..., 0]
        del logp
        m = torch.as_tensor(choice_mask[a:b].reshape(-1, s),
                            device=gold.device)
        score = torch.sum(gold * m, dim=-1) / torch.clamp(
            torch.sum(m, dim=-1), min=1.0)
        out.append(score.reshape(b - a, k).cpu())
    return torch.cat(out).numpy()


def exact_match_hits(mcfg, params, inputs, labels, loss_mask, lm_module,
                     chunk=CHUNK) -> np.ndarray:
    """Per-row 0/1: teacher-forced argmax equals gold at every answer
    position (positions where loss_mask is set)."""
    out = []
    for a, b in _chunks(len(inputs), chunk):
        pred = torch.argmax(logits(mcfg, params, inputs[a:b], lm_module),
                            dim=-1).cpu().numpy()
        ok = (pred == np.asarray(labels[a:b])) | (
            np.asarray(loss_mask[a:b]) == 0)
        out.append(np.all(ok, axis=-1).astype(np.float32))
    return np.concatenate(out)
