"""Deterministic synthetic example generators for the task registry
(copy of ``repro/tasks/generators.py``: the same examples from the same
seeds).

Each generator is ``fn(seed, n) -> list[dict]`` where every dict holds the
template fields plus an integer ``label``.  Two signal families (DESIGN.md
§9) mirror how the real SuperGLUE tasks are solved:

  * **lexicon** tasks (sst2, boolq, cb, wic): the class is carried by
    which word pool the content words are drawn from — the embedding
    table can learn pool→verbalizer directly (SST-2's sentiment words).
  * **overlap** tasks (rte, copa, squad_copy): the answer is carried by
    token *identity reuse* between prompt regions — requires attention,
    like entailment word-overlap or span extraction.

Everything is a pure function of (seed, n) via one ``np.default_rng``.

A task can also be backed by a JSON file instead of a generator:
:func:`json_examples` wraps a path (a list of example dicts) in the same
interface, with deterministic subsampling when ``n`` < file size.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List

import numpy as np

Example = Dict[str, object]
Generator = Callable[[int, int], List[Example]]

# Signal pools.  Some members look arbitrary ('copper', 'velvet'): the
# FNV tokenizer (vocab.py) can hash two words to one id, and a collision
# across pools leaks one class's signal into another, so every word here
# was chosen to keep ALL pools pairwise id-disjoint at the reference
# vocab=512 used by the tests/benchmarks.  tests/test_tasks.py pins this;
# when editing a pool, run it and swap any word it flags.

# Neutral filler — no class information.
NEUTRAL = ("the a an it this that was were is are on in at of for with by "
           "from as but and or so then still quite rather very really just "
           "also even both most some few each other same new old long short "
           "day time man woman city house harvest story music stream "
           "meadow").split()

POS_WORDS = ("brilliant copper moving superb charming hilarious "
             "heartfelt gorgeous").split()
NEG_WORDS = ("dreadful tedious clumsy violin grating lifeless "
             "incoherent shoddy").split()

TRUE_WORDS = ("confirmed verified documented established recorded "
              "official proven standard").split()
FALSE_WORDS = ("myth thunder hoax lantern debunked fictional "
               "alleged imaginary").split()

# CB: 3-way entailment lexicons.
CB_WORDS = (("certainly harbor undoubtedly clearly timber velvet".split()),
            ("never walnut contrary saddle marble denied".split()),
            ("cedar possibly maybe unclear ambiguous uncertain".split()))

# WiC: two "sense" topic pools sharing only the target word 'bank'.
SENSE_A = "bank amber loan deposit teller vault account credit".split()
SENSE_B = "bank shore water raven barley current bend ripple".split()

QUESTIONS = ("is the claim supported", "does the passage agree",
             "is this statement true", "can we conclude this")


def _mix(rng, pool, n_sig, n_total):
    """n_sig words from pool + neutral filler, shuffled."""
    words = list(rng.choice(pool, size=n_sig)) + \
        list(rng.choice(NEUTRAL, size=n_total - n_sig))
    rng.shuffle(words)
    return " ".join(words)


# ----------------------------------------------------------- lexicon tasks
def sst2_examples(seed: int, n: int) -> List[Example]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = int(rng.integers(0, 2))
        pool = (NEG_WORDS, POS_WORDS)[label]
        out.append({"text": _mix(rng, pool, 8, 20), "label": label})
    return out


def boolq_examples(seed: int, n: int) -> List[Example]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = int(rng.integers(0, 2))          # 0 = no, 1 = yes
        pool = (FALSE_WORDS, TRUE_WORDS)[label]
        out.append({"passage": _mix(rng, pool, 9, 16),
                    "question": str(rng.choice(QUESTIONS)),
                    "label": label})
    return out


def cb_examples(seed: int, n: int) -> List[Example]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = int(rng.integers(0, 3))  # entailment | contradiction | neutral
        out.append({"premise": _mix(rng, CB_WORDS[label], 6, 14),
                    "hypothesis": _mix(rng, NEUTRAL, 0, 6),
                    "label": label})
    return out


def wic_examples(seed: int, n: int) -> List[Example]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = int(rng.integers(0, 2))          # 1 = same sense
        first = int(rng.integers(0, 2))
        pools = (SENSE_A, SENSE_B)
        p1 = pools[first]
        p2 = pools[first if label else 1 - first]
        out.append({"word": "bank",
                    "sentence1": _mix(rng, p1, 4, 9),
                    "sentence2": _mix(rng, p2, 4, 9),
                    "label": label})
    return out


# ----------------------------------------------------------- overlap tasks
def rte_examples(seed: int, n: int) -> List[Example]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = int(rng.integers(0, 2))          # 0 = entailed, 1 = not
        premise = list(rng.choice(NEUTRAL, size=10, replace=False))
        if label == 0:                           # hypothesis ⊂ premise
            hyp = list(rng.choice(premise, size=5, replace=False))
        else:                                    # disjoint word set
            rest = [w for w in NEUTRAL if w not in premise]
            hyp = list(rng.choice(rest, size=5, replace=False))
        out.append({"premise": " ".join(premise),
                    "hypothesis": " ".join(hyp), "label": label})
    return out


def copa_examples(seed: int, n: int) -> List[Example]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        premise = list(rng.choice(NEUTRAL, size=8, replace=False))
        good = " ".join(rng.choice(premise, size=4, replace=False))
        rest = [w for w in NEUTRAL if w not in premise]
        bad = " ".join(rng.choice(rest, size=4, replace=False))
        label = int(rng.integers(0, 2))          # index of the good choice
        choices = (bad, good) if label else (good, bad)
        out.append({"premise": " ".join(premise),
                    "question": str(rng.choice(["cause", "effect"])),
                    "choices": choices, "label": label})
    return out


def squad_copy_examples(seed: int, n: int, answer_words: int = 4) -> List[Example]:
    """SQuAD-like extractive QA reduced to span copy: the answer is the
    ``answer_words``-word span following a cue word in the context."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ctx = list(rng.choice(NEUTRAL, size=14, replace=False))
        start = int(rng.integers(1, len(ctx) - answer_words))
        cue = ctx[start - 1]
        answer = ctx[start:start + answer_words]
        out.append({"context": " ".join(ctx),
                    "question": f"which words follow {cue}",
                    "answer": " ".join(answer), "label": 0})
    return out


# ------------------------------------------------------------ JSON backing
def json_examples(path: str) -> Generator:
    """Wrap a JSON file (list of example dicts with ``label``) as a
    generator; ``seed`` controls the deterministic subsample order."""
    def gen(seed: int, n: int) -> List[Example]:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, list) or not data:
            raise ValueError(f"{path}: expected a non-empty JSON list")
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, len(data), size=n) if n > len(data) else \
            rng.permutation(len(data))[:n]
        return [dict(data[int(i)]) for i in idx]
    return gen
