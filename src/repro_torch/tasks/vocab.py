"""Toy deterministic tokenizer for the offline task registry (copy of
``repro/tasks/vocab.py``, so both packages compile the same token ids).

The container has no real tokenizer or downloaded vocab, so task prompts
are whitespace-split words hashed (FNV-1a) into the *content* region of
the model's token-id space.  The top ``N_RESERVED`` ids are reserved so a
task's control tokens can never collide with content words:

    vocab-1              query/answer marker (same slot synthetic.py uses)
    vocab-2 .. vocab-2-k verbalizer slots, assigned per task in order

Hashing is stable across processes and sessions (pure integer FNV), so a
dataset compiled from the same (spec, vocab, seq_len, seed) is
bit-identical everywhere — the same property core/rng.py gives the
perturbation stream.

Task registry & metric protocol (DESIGN.md §9).
"""
from __future__ import annotations

from typing import List

PAD = 0          # filler id; loss/score masks always exclude it
N_RESERVED = 16  # top-of-vocab ids reserved for control tokens
_CONTENT_LO = 2  # 0 = PAD, 1 = spare


def query_token(vocab: int) -> int:
    """Answer-position marker (matches synthetic.TaskConfig.query_token)."""
    return vocab - 1


def verbalizer_id(vocab: int, index: int) -> int:
    """Reserved token id for a task's index-th verbalizer word."""
    if index >= N_RESERVED - 1:
        raise ValueError(f"at most {N_RESERVED - 1} verbalizers, got index {index}")
    return vocab - 2 - index


def word_id(word: str, vocab: int) -> int:
    """FNV-1a hash of a word into the content region [2, vocab-N_RESERVED)."""
    span = vocab - N_RESERVED - _CONTENT_LO
    if span <= 0:
        raise ValueError(f"vocab {vocab} too small for content + reserved ids")
    h = 2166136261
    for ch in word.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return _CONTENT_LO + h % span


def encode(text: str, vocab: int) -> List[int]:
    """Whitespace tokenizer: one content id per word."""
    return [word_id(w, vocab) for w in text.split()]
