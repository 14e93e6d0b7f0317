"""The device's idle share of the profiled window's steps: 1 - busy /
wall, busy the summed device time of the records between the step
markers, wall the host seconds of those steps."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "train_tokens_per_s"


def read(r):
    w = r.window
    return 100.0 * (1.0 - w["busy"] / w["wall"]) if w["wall"] > 0 else None
