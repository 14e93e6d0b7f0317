"""K1's share of its roofline: the least time K1's work needs over the
device time of its records in the profiled window.  The work is counted
from the configuration and each profiled step's layer selection, never
from launch arguments: each element of each row the algorithm sweeps is
read once and written once, in its own dtype, for each of the step's
sweeps (``work.K1_SWEEPS``: 3 on the materialized path): a bytes bound
at the card's HBM rate.  z's arithmetic is not counted: the data sheet
gives no integer-pipe peak."""

LAYER = "kernels (kernels.zo_axpy K1, fused.matmul K3/K4)"
UNIT = "%"
BETTER = "higher"
MOVES = "train_tokens_per_s"
KERNELS = ("zo_axpy_2d_kernel",)


def read(r):
    sec = sum(s for name, (s, _) in r.window["by_name"].items()
              if any(k in name for k in KERNELS))
    if sec <= 0:
        return None
    least = r.work["k1_bytes"] / r.peak["hbm_bytes_per_s"]
    return 100.0 * least / sec
