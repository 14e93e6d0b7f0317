"""The Jamba reference (``reference/jamba.py``) against ``repro_torch``'s
plain path on the CPU at a smoke size: the comparison and limits of
``test_portbench_reference.py``, the leaves at the smoke and published
sizes, and the expert share's tie to the whole layer."""
import json
import time

import pytest
import torch

from conftest import DATA, REPO, smoke_cell

SEED = 2_300_000_017          # above 2**31, as a run's seeds may be


def test_reference_matches_program():
    """Losses, projected gradients and every row's change, in norm and
    in direction, of three steps (the reference's updates following the
    program's losses) agree to float32 rounding."""
    from portbench import check, run
    from portbench.reference import common

    cell = smoke_cell("jamba-smoke")
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


@pytest.mark.parametrize("size", ["smoke", "published"])
def test_reference_leaves_are_the_programs(size):
    """The reference's parameters (paths, shapes, dtypes) are the ones
    the program builds from the configuration's ``port`` section, at the
    smoke size and as the cell runs it (``jamba2-mini-3p-ep2``: the
    published widths, 3 periods, 8 of 16 experts; on the meta device)."""
    from portbench import program, spec

    path = (DATA / "jamba-smoke.json" if size == "smoke" else
            REPO / "portbench" / "configs" / "jamba2-mini-3p-ep2.json")
    cfg = json.loads(path.read_text())
    fam = spec.family(cfg["family"])
    assert sorted(program.leaves(program.model_config(cfg))) == sorted(
        fam.leaves(cfg))


def test_reference_expert_shares_sum_to_all_experts():
    """The reference's MoE layer holding experts [0, 2) plus the one
    holding [2, 4) equals the one holding all four: every expert's
    terms counted once.  Tolerance: float32 rounding of the two sums
    (the shares add a token's two terms in another order)."""
    from portbench.reference import common, jamba

    cfg = json.loads((DATA / "jamba-smoke.json").read_text())
    D, F, E = cfg["hidden_size"], cfg["intermediate_size"], 4
    g = torch.Generator().manual_seed(1)
    w = {"norm/scale": 1 + 0.1 * torch.randn((1, D), generator=g),
         "router": torch.randn((1, D, E), generator=g),
         "we_g": torch.randn((1, E, D, F), generator=g) * D ** -0.5,
         "we_u": torch.randn((1, E, D, F), generator=g) * D ** -0.5,
         "we_d": torch.randn((1, E, F, D), generator=g) * F ** -0.5}
    xs = [torch.randn((3, 15, D), generator=g)]
    prec = common.Prec("f32")

    def layer(first, held):
        c = dict(cfg, expert_offset=first, num_experts=held)

        def getw(path, _):
            t = w[path.split("ffn/")[1]]
            if path.endswith(("we_g", "we_u", "we_d")):
                t = t[:, first:first + held]
            return t
        return jamba.moe(c, prec, getw, "stages/s0/b1/ffn/", 0, xs,
                         cfg["rms_norm_eps"])[0]

    torch.testing.assert_close(layer(0, 2) + layer(2, 2), layer(0, 4),
                               rtol=1e-5, atol=1e-6)
