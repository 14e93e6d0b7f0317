"""The work counters against counts made by hand from the published
sizes."""
import json

import pytest

from conftest import REPO


def _load(name):
    from portbench import spec
    cfg = json.loads((REPO / "portbench" / "configs" /
                      f"{name}.json").read_text())
    fam = spec.family(cfg["family"])
    return cfg, fam, fam.leaves(cfg)


def _traffic(name):
    return json.loads((REPO / "portbench" / "traffic" /
                       f"{name}.json").read_text())


def test_opt13b_model_flops_count_the_tied_head():
    from portbench import work

    cfg, fam, leaves = _load("opt-13b")
    D, F, V, L, H = 5120, 20480, 50272, 40, 40
    n_active = L * (4 * D * D + 2 * D * F) + D * V       # head: embed/tok
    assert work.active_params(cfg, leaves) == n_active == 12_840_304_640
    B, S = 16, 63
    attn = 2 * B * L * H * (S * (S + 1) // 2) * (128 + 128)
    assert work.model_flops_per_step(cfg, fam, _traffic("lezo-b16-s64"),
                                     leaves) == 2 * (2 * n_active * B * S
                                                     + attn)


def test_dsv2lite_model_flops():
    from portbench import work

    cfg, fam, leaves = _load("deepseek-v2-lite-16b")
    D, H, dn, dr, dv, lora = 2048, 16, 128, 64, 128, 512
    mla = D * H * (dn + dr) + D * (lora + dr) + 2 * lora * H * dn + H * dv * D
    dense = 3 * D * 10944
    moe = D * 64 + 3 * 64 * D * 1408 * 6 / 64 + 3 * D * 2 * 1408
    n_active = mla + dense + 26 * (mla + moe) + D * 102400
    assert work.active_params(cfg, leaves) == pytest.approx(n_active,
                                                            rel=1e-12)
    assert 2.40e9 < n_active < 2.50e9
    B, S = 16, 255
    attn = 2 * B * 27 * H * (S * (S + 1) // 2) * (dn + dr + dv)
    assert work.model_flops_per_step(
        cfg, fam, _traffic("lezo-b16-s256"), leaves) == pytest.approx(
        2 * (2 * n_active * B * S + attn), rel=1e-12)


@pytest.mark.parametrize("sparsity,sweeps", [(0.75, 3), (0.0, 3)])
def test_k1_bytes_one_step(sparsity, sweeps):
    """LeZO keeps 10 of OPT-13B's 40 layers, MeZO all 40; each swept
    element read and written once, bf16 weights and float32 norms, the
    embeddings and the final norm every step."""
    from portbench import work, zrng

    cfg, _, leaves = _load("opt-13b")
    D, F = 5120, 20480
    sizes = zrng.groups(leaves)
    act = zrng.select(sizes, 12345, int(sparsity * 40))
    layers = 40 - int(sparsity * 40)
    assert sum(len(a) for a in act.values()) == layers
    layer_bytes = 2 * (4 * D * D + 2 * D * F) + 4 * (4 * D)
    always = 2 * (50272 * D + 2048 * D) + 4 * (2 * D)
    assert work.k1_bytes(leaves, [act], sweeps) == 2 * sweeps * (
        layers * layer_bytes + always)
