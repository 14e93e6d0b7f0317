"""Jamba as published on the port's normal path, on the CPU: the three
``ModelConfig`` fields it brings (``mamba_dtbc_norm``,
``moe_renormalize``, ``expert_shard``), the selective-scan kernel's
routing rule (``repro_torch.kernels.mamba_scan``) and the expert
share's tie to the whole MoE layer.

With every field off a zoo preset computes what it computed before the
fields existed: the smoke models' hidden states, loss, prefill and
decode logits are held bit for bit to digests taken from the port
before the change (2 intra-op threads, as every test here runs;
``_outputs`` prints them again).  The scan kernel itself runs only on
the card (``tests/test_torch_cuda.py``); here every call runs the plain
ops and launches nothing.
"""
import dataclasses
import hashlib

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import obs
from repro_torch.kernels import mamba_scan as kscan
from repro_torch.launch import analysis
from repro_torch.models import lm, moe, ssm

torch.set_num_threads(2)              # six xdist workers share the CPUs

# the port's smoke models before the fields existed (sha256 prefixes of
# the float32 bytes; the loss as float.hex), seed 0 weights, seed 1 tokens
TODAY = {
    "jamba-v0.1-52b": {"hidden": "df6ff055811ba875",
                       "loss": "0x1.91d50c0000000p+2",
                       "prefill": "0be44fd0d05ea859",
                       "decode": "06fe3c883027c1ab"},
    "granite-moe-1b-a400m": {"hidden": "708f845c3f129cff",
                             "loss": "0x1.8fe6c60000000p+2",
                             "prefill": "6eb395e4ac4c56c2",
                             "decode": "528939071e01605f"},
    "deepseek-v2-lite-16b": {"hidden": "683bd572e01e22bb",
                             "loss": "0x1.a419960000000p+2",
                             "prefill": "e654db41575d841c",
                             "decode": "0446254689259762"},
}


def _digest(t):
    return hashlib.sha256(
        t.detach().float().contiguous().numpy().tobytes()).hexdigest()[:16]


def _outputs(cfg):
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_mask": torch.ones((2, 16))}
    out = {}
    with torch.no_grad():
        out["hidden"] = _digest(lm.forward(cfg, params, batch["tokens"]))
        out["loss"] = float(lm.lm_loss(cfg, params, batch)).hex()
        first, caches = lm.prefill(cfg, params, toks[:, :8], max_seq=16)
        out["prefill"] = _digest(first)
        lg, _ = lm.serve_step(cfg, params, caches, toks[:, 8:9], 8)
        out["decode"] = _digest(lg)
    return out


@pytest.mark.parametrize("arch", sorted(TODAY))
def test_fields_off_keep_the_presets_outputs(arch):
    """Each field off, by default and when set to its off value (every
    expert held named explicitly), leaves the smoke preset's outputs
    bit-equal to the port's before the fields existed."""
    cfg = tconfigs.get(arch, "smoke")
    assert (cfg.mamba_dtbc_norm, cfg.moe_renormalize, cfg.expert_shard) \
        == (False, True, (0, 0))
    assert _outputs(cfg) == TODAY[arch]
    off = cfg.with_(expert_shard=(0, cfg.n_experts), moe_renormalize=True,
                    mamba_dtbc_norm=False)
    assert _outputs(off) == TODAY[arch]


def _jamba(**kw):
    return tconfigs.get("jamba-v0.1-52b", "smoke").with_(**kw)


def test_expert_shard_from_a_json_list_and_its_bounds():
    cfg = _jamba(expert_shard=[2, 2])
    assert cfg.expert_shard == (2, 2) and cfg.held_experts == (2, 2)
    assert _jamba().held_experts == (0, 4)
    with pytest.raises(ValueError, match="outside"):
        _jamba(expert_shard=(3, 2)).held_experts


@pytest.mark.parametrize("renormalize", [True, False])
def test_expert_shards_sum_to_all_experts(renormalize):
    """Experts [0, 2) and [2, 4) of 4, each share with its slice of the
    same expert leaves, add up to the layer holding all four; each
    share's leaves are (L, 2, ...).  Tolerance: float32 rounding of the
    batched expert products, whose batch of experts differs (1e-6); the
    combine adds each token's terms in the same order either way."""
    cfg = _jamba(moe_renormalize=renormalize)
    full = moe.moe_params(cfg, torch.Generator().manual_seed(3), 1, "cpu")
    x = torch.randn((3, 15, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    layer = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
                 else v[0]) for k, v in full.items()}
    want, aux = moe.moe_fwd(cfg, layer, x)
    got = torch.zeros_like(want)
    for first in (0, 2):
        share = cfg.with_(expert_shard=(first, 2))
        mine = moe.moe_params(share, torch.Generator().manual_seed(3), 1,
                              "cpu")
        assert mine["we_g"].shape == (1, 2, cfg.d_model, cfg.moe_d_ff)
        part = dict(layer, **{k: layer[k][first:first + 2]
                              for k in ("we_g", "we_u", "we_d")})
        y, a = moe.moe_fwd(share, part, x)
        assert torch.equal(a, aux)          # routing is over all experts
        got += y
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_route_renormalizes_only_when_asked():
    """Renormalized top-k weights are today's ``top / sum(top)``; without
    renormalization they are the softmax's own, ties to the lower
    expert either way."""
    probs = torch.softmax(torch.randn(
        (2, 5, 6), generator=torch.Generator().manual_seed(5)), -1)
    probs[0, 0, 1] = probs[0, 0, 4] = probs[0, 0].max() + 0.1
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, e = moe.route(probs, 2)
    assert torch.equal(e, idx[..., :2]) and e[0, 0].tolist() == [1, 4]
    assert torch.equal(w, top[..., :2] / top[..., :2].sum(-1, keepdim=True))
    w, e = moe.route(probs, 2, renormalize=False)
    assert torch.equal(w, top[..., :2]) and torch.equal(e, idx[..., :2])


def _mamba_layer(cfg, seed=6):
    p = ssm.mamba_params(cfg, torch.Generator().manual_seed(seed), 1, "cpu")
    return {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
                else v[0]) for k, v in p.items()}


def test_dtbc_norms_are_leaves_where_jamba_puts_them():
    """With ``mamba_dtbc_norm`` the mixer holds float32 ``dt_norm`` (R),
    ``b_norm`` and ``c_norm`` (St) scales (ones), and they act between
    ``x_proj`` and the scan: y is bilinear in (B, C), so B's scale times
    a and C's over a leave the output as it was (to float32 rounding),
    where dt's scale moves it.  Off, the mixer has none of them."""
    cfg = _jamba(mamba_dtbc_norm=True)
    p = _mamba_layer(cfg)
    R, St = cfg.mamba_dt_rank, cfg.mamba_d_state
    for name, d in (("dt_norm", R), ("b_norm", St), ("c_norm", St)):
        assert p[name]["scale"].dtype == torch.float32
        assert torch.equal(p[name]["scale"], torch.ones(d))
    assert not {"dt_norm", "b_norm", "c_norm"} & set(_mamba_layer(_jamba()))
    x = torch.randn((2, 12, cfg.d_model),
                    generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        y0, _ = ssm.mamba_fwd(cfg, p, x)
        p["b_norm"]["scale"] = torch.full((St,), 4.0)
        p["c_norm"]["scale"] = torch.full((St,), 0.25)
        y1, _ = ssm.mamba_fwd(cfg, p, x)
        p["dt_norm"]["scale"] = torch.full((R,), 3.0)
        y2, _ = ssm.mamba_fwd(cfg, p, x)
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-6)
    assert (y2 - y0).abs().max() > 1e-3


def _scan_args(Bn=2, S=9, Di=24, St=16, dtype=torch.float32, seed=8):
    g = torch.Generator().manual_seed(seed)
    proj = torch.randn((Bn, S, 4 + 2 * St), generator=g)
    xz = torch.randn((Bn, S, 2 * Di), generator=g).to(dtype)
    return dict(dt=torch.randn((Bn, S, Di), generator=g),
                dt_b=torch.randn((Di,), generator=g) * 0.1,
                A_log=torch.randn((Di, St), generator=g) * 0.1,
                x=xz[..., :Di], B=proj[..., 4:4 + St], C=proj[..., 4 + St:],
                Dskip=torch.randn((Di,), generator=g),
                z=xz[..., Di:], h0=torch.randn((Bn, Di, St), generator=g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_scan_runs_plain_ops_and_launches_nothing(dtype):
    """On the CPU the scan is the plain ops bit for bit (the last h only
    when asked for); no launch is counted and neither scan counter
    moves."""
    a = _scan_args(dtype=dtype)
    before = kscan.counter.launches
    tr = obs.Tracer()
    with obs.use(tr):
        y, h = kscan.mamba_scan(ssm._scan_plain, **a, final=True)
        y2, none = kscan.mamba_scan(ssm._scan_plain, **a)
    want_y, want_h = ssm._scan_plain(*a.values())
    assert y.dtype == dtype and torch.equal(y, want_y)
    assert torch.equal(h, want_h) and torch.equal(y2, y) and none is None
    assert kscan.counter.launches == before
    assert obs.CTR_SCAN_KERNEL not in tr.counters
    assert obs.CTR_SCAN_PLAIN not in tr.counters


def test_kernel_routing_rule():
    """The split views of ``in_proj``'s and ``x_proj``'s outputs fit the
    kernel; a state size outside ``STATES``, another dtype, mismatched
    x and z, a layout whose rows do not collapse to one stride, or an
    input that wants a gradient under autograd takes the plain ops."""
    a = _scan_args()
    assert kscan._fits(**a)
    assert kscan._fits(**dict(a, h0=None))
    assert not kscan._fits(**_scan_args(St=12))
    assert not kscan._fits(**dict(a, dt=a["dt"].double()))
    assert not kscan._fits(**dict(a, z=a["z"].bfloat16()))
    assert not kscan._fits(**dict(a, x=a["x"].transpose(0, 1).contiguous()
                                  .transpose(0, 1)))
    g = dict(a, dt=a["dt"].clone().requires_grad_())
    assert not kscan._fits(**g)
    with torch.no_grad():
        assert kscan._fits(**g)


def test_dry_run_counts_a_scan_as_one_launch():
    """Under the cost counter an off-card scan the card would launch
    counts the kernel's flops and bytes once, none of the plain ops:
    its inputs read once and y written once."""
    Bn, S, Di, St = 16, 63, 512, 16
    m = dict(device="meta")
    args = (torch.zeros((Bn, S, Di), **m), torch.zeros((Di,), **m),
            torch.zeros((Di, St), **m),
            torch.zeros((Bn, S, Di), dtype=torch.bfloat16, **m),
            torch.zeros((Bn, S, St), **m), torch.zeros((Bn, S, St), **m),
            torch.zeros((Di,), **m),
            torch.zeros((Bn, S, Di), dtype=torch.bfloat16, **m), None)
    c = analysis.analyze(
        lambda dt: kscan.mamba_scan(ssm._scan_plain, dt, *args[1:])[0],
        args[0])[1]
    assert c.kernels == {"mamba_scan": 1}
    assert (c.flops, c.bytes) == kscan.cost(args[0], args[3], args[4])
    assert c.bytes == Bn * S * Di * (4 + 2 + 2 + 2) + 2 * Bn * S * St * 4


def test_scan_range_inside_the_recurrent_mixer():
    """A Mamba layer's train forward opens ``model/mamba/scan`` once,
    inside ``model/recurrent``, under an annotating tracer."""
    cfg = _jamba(stages=(dataclasses.replace(
        _jamba().stages[0], repeat=1),))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    with obs.use(obs.Tracer(annotate=True)), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            torch.no_grad():
        lm.forward(cfg, params, toks)
    scans = [e for e in prof.events() if e.name == obs.trace.MAMBA_SCAN]
    n_mamba = sum(b.kind == "mamba" for b in cfg.stages[0].pattern)
    assert len(scans) == n_mamba
    for e in scans:
        q = e.cpu_parent
        while q is not None and q.name not in obs.RANGES:
            q = q.cpu_parent
        assert q is not None and q.name == "model/recurrent"
