"""The plain reference against ``repro_torch``'s plain path at smoke sizes
on the CPU, and the frozen RNG and selection against the program's."""
import time

import pytest
import torch

from conftest import smoke_cell

SEED = 2_300_000_017          # above 2**31, as a run's seeds may be


@pytest.mark.parametrize("config", ["opt-smoke", "dsv2-smoke"])
def test_reference_matches_program(config):
    """Losses, projected gradients and every row's change, in norm and
    in direction, of three steps (the reference's updates following the
    program's losses) agree to float32 rounding."""
    from portbench import check, run
    from portbench.reference import common

    cell = smoke_cell(config)
    got = run.program_run(cell, SEED, 0, False, "cpu", time.perf_counter())
    ref = common.run(cell.family, cell.config, cell.traffic, SEED,
                     run.CHECK_STEPS, "cpu", follow=got["prog"])
    n = check.numbers(got["prog"], ref)
    assert n["loss_gap"] < 1e-5
    assert n["grad_gap"] < 1e-2
    assert n["change_gap"] < 1e-5
    assert n["update_gap"] < 1e-5
    moved = [v for v, _ in ref["change"].values() if v > 0]
    assert 0 < len(moved) < len(ref["change"])   # LeZO left rows unmoved


@pytest.mark.parametrize("config", ["opt-smoke", "dsv2-smoke", "opt-13b",
                                    "deepseek-v2-lite-16b"])
def test_reference_leaves_are_the_programs(config):
    """The reference's parameters (paths, shapes, dtypes) are the ones
    the program builds from the configuration's ``port`` section, at the
    published sizes too (on the meta device)."""
    import json

    from conftest import DATA, REPO
    from portbench import program, spec

    path = DATA / f"{config}.json"
    if not path.exists():
        path = REPO / "portbench" / "configs" / f"{config}.json"
    cfg = json.loads(path.read_text())
    fam = spec.family(cfg["family"])
    assert sorted(program.leaves(program.model_config(cfg))) == sorted(
        fam.leaves(cfg))


def test_frozen_rng_is_the_programs():
    """z, fold, the leaf key and the stratified selection of the frozen
    copy equal ``repro_torch.core``'s bit for bit."""
    from portbench import zrng
    from repro_torch.core import rng, zo
    from repro_torch.kernels import ref as kref

    for s, d in ((0, 0), (SEED, 7), (2 ** 32 - 1, 12345)):
        assert zrng.fold(s, d) == rng.fold_py(s, d)
    assert zrng.leaf_uid("stages/s0/b0/mix/wq") == rng.leaf_uid(
        "stages/s0/b0/mix/wq")
    seed = zrng.fold(zrng.fold(SEED, zrng.leaf_uid("embed/tok")), 3)
    want = kref.leaf_normal_nd(rng.fold_py(SEED, rng.leaf_uid("embed/tok")),
                               (4, 5000))[3]
    assert torch.equal(zrng.layer_z(SEED, "embed/tok", 3, 5000, "cpu"), want)
    assert torch.equal(zrng.counter_normal(seed, torch.arange(5000)), want)
    leaves = [("stages/s0/b0/mix/wq", (1, 4, 4), "float32"),
              ("stages/s1/b0/mix/wq", (26, 4, 4), "float32"),
              ("embed/tok", (8, 4), "float32")]
    params = {"stages": {"s0": {"b0": {"mix": {"wq": torch.zeros(1, 4, 4)}}},
                         "s1": {"b0": {"mix": {"wq": torch.zeros(26, 4, 4)}}}},
              "embed": {"tok": torch.zeros(8, 4)}}
    spec = zo.build_spec(params, lambda p: zrng.group_of(p))
    for t in range(5):
        step = zrng.step_seed(SEED, t)
        masks, _, _ = zo.stratified_select(spec, step, 20)
        got = zrng.select(zrng.groups(leaves), step, 20)
        assert got == {g: torch.nonzero(m).flatten().tolist()
                       for g, m in masks.items()}
