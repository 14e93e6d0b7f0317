"""The comparison that decides ``correct``: what the timed path made in
its first steps against the plain reference's same steps from the seed.

Five numbers, each held to its cell's limit (``limits/<cell>.json``;
a limit of null: read, not compared):

* ``loss_gap``: the widest relative gap of a probe's loss, over both
  probes of every checked step;
* ``loss_mean_gap``: the mean of those relative gaps;
* ``grad_gap``: the widest gap of a step's projected gradient, against
  the reference's or the cell's typical gradient (the limits file's
  ``scale``: the median |g| of the reference over the readings' seeds
  and steps), whichever is larger: a ZO gradient is near 0 on some
  seeds, where a gap against it alone reads the loss's rounding;
* ``change_gap``: by the worst (leaf, layer) row, the gap between the
  norms of the program's and the reference's change of the row over the
  checked steps, against the reference's norm of that row or the median
  of the rows that moved, whichever is larger.  A row that LeZO dropped
  on every checked step does not move in the reference, so any move of
  it in the program reads against the median;
* ``update_gap``: by the worst row, the gap between the program's and
  the reference's change projected on the row's own random direction
  (``weights.change``), against the same norm: the direction of the
  change, which a norm does not see (an update along -g moves a row as
  far as one along g).

The reference's updates take the projected gradient that it works out
from the program's losses of the step (``reference.common.run``'s
``follow``), so the two change numbers hold the program's update to
what its own losses ask for, and ``loss_gap`` holds those losses.
"""
from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "loss_mean_gap", "grad_gap", "change_gap",
           "update_gap")


def numbers(prog, ref, g_scale=None):
    """The numbers of a program's run ``prog`` against the
    reference's ``ref``; each holds {"l_plus", "l_minus", "g": [per
    step], "change": {row: (norm, projection)}}.  ``g_scale`` is the cell's typical
    gradient (the root mean square of ``ref``'s over the steps when
    None)."""
    gaps = [abs(p - r) / abs(r) for key in ("l_plus", "l_minus")
            for p, r in zip(prog[key], ref[key])]
    if g_scale is None:
        g_scale = math.sqrt(sum(g * g for g in ref["g"]) / len(ref["g"]))
    grad = [abs(p - r) / max(abs(r), g_scale)
            for p, r in zip(prog["g"], ref["g"])]
    if set(prog["change"]) != set(ref["change"]):
        raise ValueError("the program's rows are not the reference's")
    moved = [n for n, _ in ref["change"].values() if n > 0]
    med = statistics.median(moved) if moved else 1.0
    change, update = [], []
    for k, (n, proj) in ref["change"].items():
        pn, pproj = prog["change"][k]
        change.append(abs(pn - n) / max(n, med))
        update.append(abs(pproj - proj) / max(n, med))
    out = {"loss_gap": max(gaps), "loss_mean_gap": sum(gaps) / len(gaps),
           "grad_gap": max(grad), "change_gap": max(change),
           "update_gap": max(update)}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def judge(nums, limits):
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits file compares."""
    shown, ok = {}, True
    for name in NUMBERS:
        lim = limits["numbers"][name]["limit"]
        if lim is None:
            continue
        shown[name] = {"value": nums[name], "limit": lim}
        ok = ok and nums[name] <= lim
    return ok, shown
