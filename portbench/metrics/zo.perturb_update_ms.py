"""Milliseconds a step in the paper's stage: the ``perturb`` and
``update_axpy`` spans of ``repro_torch``'s estimators, fenced
(``Tracer(fence=True)``, each span synchronised before its clock stops)
into an in-memory ring, summed and taken a step."""

LAYER = "ZO estimator (estimators, core.zo)"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_tokens_per_s"


def read(r):
    s = r.spans["sums"]["perturb_update"]
    return 1e3 * s / r.spans["steps"] if s > 0 else None
