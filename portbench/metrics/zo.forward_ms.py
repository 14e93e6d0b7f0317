"""Milliseconds a step in the probes' forwards: the ``forward_pair``,
``forward+εz`` and ``forward-εz`` spans of ``repro_torch``'s
estimators, fenced as ``zo.perturb_update_ms`` is, summed a step."""

LAYER = "ZO estimator (estimators, core.zo)"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_tokens_per_s"


def read(r):
    s = r.spans["sums"]["forward"]
    return 1e3 * s / r.spans["steps"] if s > 0 else None
