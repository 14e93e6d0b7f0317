"""The integrity check behind ``chip_smoke.py``'s profiled windows
(``window_steps``, ``window_check``), on synthetic kernel records: a
whole window passes, whatever its edges kept; a window that lost one
layer's kernels in one step, a step's first or last records, or a kernel
its launch counters saw, raises.  ``edge_losses`` counts the fills each
edge lost."""
import os
import sys

import pytest

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))
import chip_smoke  # noqa: E402

LAYERS = 40
LAYER = ["layer_norm", "pmatmul_kernel<qkv>", "rope", "flash_fwd_kernel<128>",
         "pmatmul_kernel<o>", "add", "layer_norm", "pmatmul_kernel<fc1>",
         "gelu", "pmatmul_kernel<fc2>", "add"]
HEAD = ["layer_norm", "pmatmul_kernel<head>", "cross_entropy"]
MARK = f"void at::cuda::{chip_smoke.WINDOW_MARK}(long)"


def step_records(drop_layer=None, extra=()):
    out = ["embedding_gather"]
    for layer in range(LAYERS):
        if layer != drop_layer:
            out += LAYER
    return out + HEAD + list(extra)


def window(steps, drop=None, extra=None):
    """The records of a window of ``steps`` steps, each opened by the
    marker and one more marker closing the window: ``drop`` (step,
    layer) loses that layer's kernels, ``extra`` (step, names) adds
    kernels to a step."""
    recs = []
    for s in range(steps):
        recs.append(MARK)
        recs += step_records(drop[1] if drop and drop[0] == s else None,
                             extra[1] if extra and extra[0] == s else ())
    return recs + [MARK]


def launched(recs):
    return {k: sum(k in n for n in recs)
            for k in ("pmatmul_kernel", "flash_fwd_kernel")}


PAGE = ["index_copy", "memcpy"]             # a decode step opening a page

CASES = {
    # name: (records, steps, how steps compare, counted launches, raises)
    "whole": (window(3), 3, "equal", None, False),
    "whole, inside what is left of its edges": (
        ["fill"] * 7 + window(3) + ["fill"] * 256, 3, "equal", None, False),
    "whole, counters agree": (
        window(3), 3, "equal", launched(window(3)), False),
    "first step lost a layer": (
        window(3, drop=(0, 0)), 3, "equal", None, True),
    "middle step lost a layer": (
        window(3, drop=(1, 17)), 3, "equal", None, True),
    "last step lost a layer": (
        window(2, drop=(1, 39)), 2, "equal", None, True),
    "steady, a step opens a page": (
        window(10, extra=(4, PAGE)), 10, "steady", None, False),
    "steady, a step lost a layer": (
        window(10, drop=(0, 0)), 10, "steady", None, True),
    "first records lost": (
        window(3)[len(LAYER) + 2:], 3, "equal", None, True),
    "the first marker lost": (window(3)[1:], 3, "equal", None, True),
    "last records lost": (
        window(3)[:-len(HEAD) - 1], 3, "equal", None, True),
    "the closing marker lost": (window(3)[:-1], 3, "equal", None, True),
    "counters saw one launch more": (
        window(3), 3, "equal",
        {**launched(window(3)), "flash_fwd_kernel": 3 * LAYERS + 1}, True),
    "steady, a step lost a launch the counters saw": (
        window(10, drop=(9, 5)), 10, "steady", launched(window(10)), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_window_check(case):
    recs, steps, alike, counted, raises = CASES[case]
    if raises:
        with pytest.raises(SystemExit, match="lost"):
            chip_smoke.window_check(chip_smoke.window_steps(recs, steps),
                                    counted, alike=alike)
        return
    per_step = chip_smoke.window_steps(recs, steps)
    assert len(per_step) == steps
    got = chip_smoke.window_check(per_step, counted, alike=alike)
    assert sum(got.values()) == len(step_records())
    assert got["flash_fwd_kernel<128>"] == LAYERS


EDGE = chip_smoke.WINDOW_EDGE
FILL = "void at::native::vectorized_elementwise_kernel<FillFunctor<float>>"

EDGES = {
    # name: (fills kept at the opening edge, at the closing edge)
    "both edges whole": (EDGE, EDGE),
    "a prefix lost": (EDGE - 108, EDGE),
    "a suffix lost": (EDGE, EDGE - 672),
    "both lost, a marker kept": (1, 0),
}


@pytest.mark.parametrize("case", list(EDGES))
def test_edge_losses(case):
    kept_open, kept_close = EDGES[case]
    recs = [FILL] * kept_open + window(2) + [FILL] * kept_close
    assert chip_smoke.edge_losses(recs) == (EDGE - kept_open,
                                            EDGE - kept_close)
    assert len(chip_smoke.window_steps(recs, 2)) == 2
