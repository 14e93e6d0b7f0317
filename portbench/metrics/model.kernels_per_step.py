"""Device records a step in the profiled window (``window.measure``:
between the step markers, records refused unless whole): the launches
the model step (``models.lm``, ``models.layers``, ``models.moe``) and
its kernels make, whose issue the host pays for."""

LAYER = "model step (models.lm, models.layers, models.moe)"
UNIT = "kernels"
BETTER = "lower"
MOVES = "train_tokens_per_s"


def read(r):
    return r.window["kernels"] or None
