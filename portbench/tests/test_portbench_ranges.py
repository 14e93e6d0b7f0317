"""``portbench/ranges.py`` on synthetic windows: device records charged
to the ranges open when their runtime call ran, idle gaps by their
middle, and the four readings over them."""
import pytest

from portbench import ranges as R

# host ranges (µs): a step holding a selection, a forward with an
# attention block that launches K2, a norm, then the update's K1
HOST = [(0, 100, "zo/step"), (1, 5, "zo/select"),
        (10, 60, "forward+eps_z"), (12, 30, "model/attn"),
        (20, 25, "kernel/flash_attention"), (32, 40, "model/norm"),
        (45, 50, "model/head_ce"), (70, 90, "update_axpy"),
        (72, 80, "kernel/zo_axpy_2d")]
LAUNCH = {1: 14, 2: 22, 3: 35, 4: 47, 5: 75, 6: 200}


def _window(records, steps=1, host=HOST):
    r = R.charge(records, LAUNCH, R.Ranges(host))
    r["steps"] = steps
    return r


def test_a_record_is_charged_to_the_chain_of_its_launch():
    r = _window([(30, 40, 1), (40, 50, 2)])
    assert r["device"] == {
        ("model/attn", "forward+eps_z", "zo/step"): 10e-6,
        ("kernel/flash_attention", "model/attn", "forward+eps_z",
         "zo/step"): 10e-6}
    assert r["busy"] == pytest.approx(20e-6) and r["unmatched"] == 0


def test_nested_ranges_are_counted_inclusively():
    r = _window([(30, 40, 1), (40, 50, 2), (50, 52, 3)])
    incl = R.by_range(r, "device")
    assert incl["model/attn"] == pytest.approx(20e-6)       # K2 inside
    assert incl["kernel/flash_attention"] == pytest.approx(10e-6)
    assert incl["forward+eps_z"] == pytest.approx(22e-6)
    assert incl["zo/step"] == pytest.approx(22e-6)
    assert incl["model/norm"] == pytest.approx(2e-6)


def test_a_launch_after_a_nested_range_closed_goes_to_its_parent():
    ranges = R.Ranges(HOST)
    assert ranges.chain(29) == ("model/attn", "forward+eps_z", "zo/step")
    assert ranges.chain(31) == ("forward+eps_z", "zo/step")
    assert ranges.chain(41) == ("forward+eps_z", "zo/step")
    assert ranges.chain(65) == ("zo/step",)
    assert ranges.chain(150) == R.OUTSIDE


def test_an_idle_gap_is_charged_by_its_middle():
    # gap 52..58 (middle 55: the forward, after the head closed);
    # gap 60..90 (middle 75: K1's wrapper in the update)
    r = _window([(50, 52, 3), (58, 60, 4), (90, 91, 5)])
    assert r["gaps"] == {("forward+eps_z", "zo/step"): 6e-6,
                         ("kernel/zo_axpy_2d", "update_axpy",
                          "zo/step"): 30e-6}
    assert r["idle"] == pytest.approx(36e-6)
    assert R.top_gaps(r) == [["kernel/zo_axpy_2d", 30e-6],
                             ["forward+eps_z", 6e-6]]


def test_a_gap_outside_every_range_goes_to_outside():
    r = _window([(90, 91, 5), (150, 160, 4), (300, 301, 6)])
    assert r["gaps"][R.OUTSIDE] == pytest.approx(59e-6 + 140e-6)
    assert R.coverage(r)["idle_outside"] == pytest.approx(1.0)
    assert R.top_gaps(r)[0][0] == "outside"


def test_overlapping_records_leave_no_gap():
    r = _window([(30, 50, 1), (35, 40, 2), (50, 60, 3)])
    assert r["idle"] == 0.0 and r["gaps"] == {}


def test_a_record_whose_call_was_not_seen_is_counted_unmatched():
    r = _window([(30, 40, 1), (40, 50, 99)])
    assert r["unmatched"] == 1
    assert r["busy"] == pytest.approx(20e-6)
    assert R.coverage(r)["in_step"] == pytest.approx(0.5)


def test_the_four_readings():
    # 2 steps: norm 2 µs + head 6 µs; idle 4 µs in the forward, 28 µs in
    # the update, 59 µs outside
    r = _window([(50, 52, 3), (54, 58, 4), (60, 62, 4), (90, 91, 5),
                 (150, 151, 6)], steps=2)
    got = {n: f(r) for n, f in R.METRICS.items()}
    assert got["model.norm_head_ms"] == pytest.approx(1e3 * 8e-6 / 2)
    assert got["model.moe_glue_ms"] is None        # no MoE range
    assert got["model.host_idle_ms"] == pytest.approx(1e3 * 4e-6 / 2)
    assert got["zo.host_idle_ms"] == pytest.approx(1e3 * 28e-6 / 2)


def test_moe_glue_leaves_the_expert_products_out():
    host = [(0, 100, "zo/step"), (10, 90, "forward_pair"),
            (10, 20, "model/moe/route"), (20, 30, "model/moe/dispatch"),
            (30, 40, "model/moe/experts"), (40, 50, "model/moe/combine")]
    launch = {1: 15, 2: 25, 3: 35, 4: 45}
    r = R.charge([(100, 110, 1), (110, 130, 2), (130, 230, 3),
                  (230, 240, 4)], launch, R.Ranges(host))
    r["steps"] = 1
    assert R.moe_glue_ms(r) == pytest.approx(1e3 * 40e-6)
    assert R.coverage(r)["in_step"] == pytest.approx(1.0)


def test_the_names_are_the_programs():
    from repro_torch.obs import trace as obs

    assert R.FORWARDS == tuple(obs.range_name(n) for n in (
        obs.FWD_PLUS, obs.FWD_MINUS, obs.FWD_PAIR))
    assert all(n.isascii() for n in R.FORWARDS)
    assert set((R.ZO_STEP,) + R.NORM_HEAD + R.MOE_GLUE) <= set(obs.RANGES)
