"""``correct`` comes out false for the control and for each fault a
training cell can have, with the limits of the shipped cells, at a size
a CPU test holds; and true for the sound program."""
import json
import time

import pytest

from conftest import REPO, smoke_cell
from portbench.program import FAULTS

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2_300_000_017, 2_400_000_023, 3_000_000_029)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails(cell, seed):
    """The reference one precision below bfloat16 (float8 e4m3 weights
    and products) in the program's place is not correct."""
    from portbench import check, run
    from portbench.reference import common

    c = smoke_cell("dsv2-smoke" if "dsv2" in cell else "opt-smoke",
                   limits=cell)
    c.config = dict(c.config, torch_dtype="bfloat16")
    ctrl = common.run(c.family, c.config, c.traffic, seed, run.CHECK_STEPS,
                      "cpu", prec="fp8")
    ref = common.run(c.family, c.config, c.traffic, seed, run.CHECK_STEPS,
                     "cpu", follow=ctrl)
    ok, shown = check.judge(check.numbers(ctrl, ref), c.limits)
    assert not ok, shown


@pytest.mark.parametrize("fault", (None,) + FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_with_a_broken_step_is_not_correct(cell, fault):
    """The whole run but the look for a card, the program's step broken
    underneath: a step that returns its state unchanged; half of the
    batch left out and the mean taken over the rest; the update along
    -g or 2g while the step reports g.  The sound step is correct under
    the same limits."""
    from portbench import run

    c = smoke_cell("dsv2-smoke" if "dsv2" in cell else "opt-smoke",
                   limits=cell)
    r = run.run_cell(c, SEEDS[0], 0, False, "cpu", time.perf_counter(),
                     fault=fault)
    assert r["correct"] is (fault is None), r["check"]
