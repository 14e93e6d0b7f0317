"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small and ragged shapes.  Marked ``cuda``: they skip on a
machine without a GPU and run on one with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: K1 masked rows bit-equal and active rows within 1 bf16 ulp
(z differs from the plain version by a few float32 ulp); K2-K4 within
one bf16 rounding step of the output (2^-7 relative, plus 2^-8 of the
largest magnitude near zero); K3 at any P bit-equal to P K4 calls; K2's
backward within two steps (stated at its test).  The serving engine on
the card: greedy tokens equal the lockstep's, or differ first where the
lockstep's top-2 gap is below the two paths' max |delta logits| (a
near-tie); sharing on equal to sharing off bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch import fused
from repro_torch.configs import opt
from repro_torch.core import zo
from repro_torch.fused import matmul as fmm
from repro_torch.fused import ref as fref
from repro_torch.kernels import flash_attn as kfa
from repro_torch.kernels import ref as kref
from repro_torch.kernels import zo_axpy as kzo
from repro_torch.models import lm

torch.set_num_threads(2)              # six xdist workers share the CPUs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, steps=1):
    got, want = got.float(), want.float()
    tol = steps * (2.0 ** -7 * want.abs() + 2.0 ** -8 * want.abs().max())
    assert torch.isfinite(got).all()
    assert bool(((got - want).abs() <= tol).all()), (got - want).abs().max()


def _ulps(a, b):
    def order(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (order(a) - order(b)).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zo_axpy_kernel(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    theta = torch.randn((5, 3001), generator=g, device=dev).to(dtype)
    mask = torch.tensor([True, False, True, True, False])
    got, want = theta.clone(), theta.clone()
    kzo.counter.launches = 0
    kzo.zo_axpy_2d_(got, mask, 0xC0FFEE, 1e-2, 0.99)
    kref.zo_axpy_2d_(want, mask, 0xC0FFEE, 1e-2, 0.99)
    assert kzo.counter.launches == 1
    m = mask.to(dev)
    assert torch.equal(got[~m], theta[~m])
    if dtype == torch.bfloat16:
        assert _ulps(got[m], want[m]) <= 1
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_zo_axpy_host_mask_does_not_wait_for_the_card(dev):
    """A host mask reaches the card without a stream synchronization:
    behind a long spin, the launch returns while the spin still runs,
    and the result is the plain version's."""
    theta = torch.randn((4, 1024), device=dev)
    mask = torch.tensor([True, False, False, True])
    want = theta.clone()
    kref.zo_axpy_2d_(want, mask, 0x5EED, 1e-2, 1.0)
    kzo.zo_axpy_2d_(theta.clone(), mask, 0x5EED, 1e-2, 1.0)   # built
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 30)             # a spin far longer than a launch
    kzo.zo_axpy_2d_(theta, mask, 0x5EED, 1e-2, 1.0)
    assert not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    torch.testing.assert_close(theta, want, rtol=1e-6, atol=1e-7)


def test_zo_axpy_host_mask_changed_in_place_is_copied_again(dev):
    """The pinned copy of a host mask is made again once the mask has
    changed in place, and a new mask object gets its own."""
    theta = torch.randn((4, 256), device=dev)
    want = theta.clone()
    mask = torch.tensor([True, False, False, False])
    for step in range(3):
        kzo.zo_axpy_2d_(theta, mask, 7 + step, 1e-2, 1.0)
        kref.zo_axpy_2d_(want, mask, 7 + step, 1e-2, 1.0)
        mask[step + 1] = True
    mask = torch.tensor([False, True, False, True])
    kzo.zo_axpy_2d_(theta, mask, 11, 1e-2, 1.0)
    kref.zo_axpy_2d_(want, mask, 11, 1e-2, 1.0)
    torch.testing.assert_close(theta, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("L,n,offset", [
    (3, 4096, 3),       # row bases 6 bytes past a 16-byte boundary
    (4, 7, 1),          # rows shorter than one vector: head and tail only
    (1, 12345, 5),      # an unstacked leaf as one row, odd n
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zo_axpy_kernel_layouts(dev, dtype, L, n, offset):
    """Misaligned row bases and odd n take the scalar head and tail."""
    g = torch.Generator(device=dev).manual_seed(5)
    buf = torch.randn((L * n + offset,), generator=g, device=dev).to(dtype)
    theta = buf[offset:].view(L, n)
    mask = torch.tensor([i % 2 == 0 for i in range(L)])
    want = theta.clone()
    got = buf.clone()[offset:].view(L, n)    # same misalignment as theta
    kzo.zo_axpy_2d_(got, mask, 0xABCDEF, -3e-2, 1.0)
    kref.zo_axpy_2d_(want, mask, 0xABCDEF, -3e-2, 1.0)
    m = mask.to(dev)
    assert torch.equal(got[~m], theta[~m])
    if dtype == torch.bfloat16:
        assert _ulps(got[m], want[m]) <= 1
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_counter_normal_parts_exhaustive(dev):
    """The kernels' r and c equal the plain versions' sqrtf(-2 logf(u))
    and cosf(2 pi u) bit for bit on every one of the 2^24 values of u."""
    res = kzo.counter_normal_parts_check(dev)
    assert res["inputs"] == 1 << 24
    assert (res["r_mismatches"], res["c_mismatches"]) == (0, 0), res


@pytest.mark.parametrize("q_offset,k_offset,Sk,G,dh", [
    (0, 0, 63, 1, 128), (8, 0, 90, 2, 64), (0, -5, 40, 1, 32)])
def test_flash_kernel(dev, q_offset, k_offset, Sk, G, dh):
    g = torch.Generator(device=dev).manual_seed(1)
    B, Sq, KV = 3, 37, 2
    q = torch.randn((B, Sq, KV, G, dh), generator=g, device=dev).bfloat16()
    k = torch.randn((B, Sk, KV, dh), generator=g, device=dev).bfloat16()
    v = torch.randn((B, Sk, KV, dh), generator=g, device=dev).bfloat16()
    kw = dict(causal=True, q_offset=q_offset, k_offset=k_offset)
    _close(kfa.flash_attention(q, k, v, **kw),
           kfa.flash_attention_plain(q, k, v, k_chunk=64, **kw))


@pytest.mark.parametrize("B,Sq,Sk,KV,G,dh,q_offset,k_offset,causal", [
    (2, 130, 130, 2, 1, 64, 0, 0, True),     # 3 query and 3 key tiles
    (2, 45, 100, 2, 1, 128, 0, 0, False),    # non-causal, 2 key tiles
    (2, 63, 63, 3, 2, 128, 0, 0, True),      # GQA, G = 2 at dh = 128
    (2, 63, 63, 8, 5, 128, 0, 0, True),      # Qwen3-14B's G = 5
    (2, 63, 63, 8, 7, 128, 0, 0, True),      # deepseek-coder-33b's G = 7
    (4, 1, 63, 2, 1, 128, 62, 0, True),      # one query at position 62
    (2, 37, 50, 2, 1, 32, 0, 40, True),      # no row sees a key: out = 0
    (2, 63, 63, 16, 1, 192, 0, 0, True),     # MLA's dn + dr on deepseek
    (2, 20, 90, 3, 1, 192, 70, 0, True),     # dh = 192 at an offset
    (1, 130, 130, 2, 1, 192, 0, 0, True),    # dh = 192, 3 x 3 tiles
])
def test_flash_kernel_paths(dev, B, Sq, Sk, KV, G, dh, q_offset, k_offset,
                            causal):
    g = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn((B, Sq, KV, G, dh), generator=g, device=dev).bfloat16()
    k = torch.randn((B, Sk, KV, dh), generator=g, device=dev).bfloat16()
    v = torch.randn((B, Sk, KV, dh), generator=g, device=dev).bfloat16()
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)
    kfa.counter.launches = 0
    got = kfa.flash_attention(q, k, v, **kw)
    assert kfa.counter.launches == 1
    want = kfa.flash_attention_plain(q, k, v, k_chunk=64, **kw)
    _close(got, want)
    if q_offset + Sq - 1 < k_offset:
        assert not got.float().abs().any()


def test_flash_kernel_at_dh_192_pads_v_with_exact_zeros(dev):
    """MLA's call: v zero-padded from dn = 128 to 192; the kernel's pad
    columns come out as exact zeros, the rest within one bf16 step of
    the plain version, at the lockstep prefill's (4, 1024, 16, 1, 192)
    too."""
    g = torch.Generator(device=dev).manual_seed(9)
    for B, S in ((16, 63), (4, 1024)):
        q = torch.randn((B, S, 16, 1, 192), generator=g,
                        device=dev).bfloat16()
        k = torch.randn((B, S, 16, 192), generator=g, device=dev).bfloat16()
        v = torch.nn.functional.pad(torch.randn(
            (B, S, 16, 128), generator=g, device=dev).bfloat16(), (0, 64))
        got = kfa.flash_attention(q, k, v, causal=True)
        assert not got[..., 128:].float().abs().any()
        _close(got, kfa.flash_attention_plain(q, k, v, causal=True,
                                              q_chunk=512, k_chunk=2048))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b"])
def test_moe_and_mla_forward_deterministic_on_card(dev, arch):
    """``moe_fwd`` (the sort-based dispatch and the ordered combine) and
    a whole bf16 model of each MoE arch run twice on the card give
    bit-equal, finite outputs: the smoke config widened to d_model 256
    so that K2 takes its head dim (64 on granite; MLA's 128 + 64 = 192
    on deepseek)."""
    from repro_torch import configs
    from repro_torch.models import moe
    wide = ({"d_head": 128, "rope_head_dim": 64}
            if arch == "deepseek-v2-lite-16b" else {})
    cfg = configs.get(arch, "smoke").with_(dtype="bfloat16", d_model=256,
                                           **wide)
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    p_gpu = lm.params_from_numpy(cfg, lm.params_to_numpy(p_cpu), dev)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((4, 63, cfg.d_model), generator=g).bfloat16().to(dev)
    blk = p_gpu["stages"][f"s{len(cfg.stages) - 1}"]["b0"]["ffn"].layer(0)
    y1, a1 = moe.moe_fwd(cfg, blk, x)
    y2, a2 = moe.moe_fwd(cfg, blk, x)
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))
    assert torch.equal(a1, a2)
    toks = torch.randint(0, cfg.vocab, (4, 63), generator=g)
    h1 = lm.forward(cfg, p_gpu, toks.to(dev))
    h2 = lm.forward(cfg, p_gpu, toks.to(dev))
    assert torch.equal(h1.view(torch.int16), h2.view(torch.int16))
    assert torch.isfinite(h1.float()).all()


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "deepseek-v2-lite-16b"])
def test_moe_and_mla_gradient_deterministic_on_card(dev, arch):
    """First-order training's gradient of a bf16 MoE model (the dispatch,
    the combine and K2's forward at 64 or 192 under its plain backward),
    taken twice on the card from the same weights and batch: every leaf's
    gradient bit-equal and finite."""
    from repro_torch import configs
    wide = ({"d_head": 128, "rope_head_dim": 64}
            if arch == "deepseek-v2-lite-16b" else {})
    cfg = configs.get(arch, "smoke").with_(dtype="bfloat16", d_model=256,
                                           **wide)
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    params = lm.params_from_numpy(cfg, lm.params_to_numpy(p_cpu), dev)
    leaves = lm.grad_leaves(params)
    toks = torch.randint(0, cfg.vocab, (4, 63),
                         generator=torch.Generator().manual_seed(4)).to(dev)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1),
             "loss_mask": torch.ones((4, 63), device=dev)}
    grads = []
    for _ in range(2):
        for _, _, t in leaves:
            t.grad = None
        lm.lm_loss(cfg, params, batch, grad=True).backward()
        grads.append([t.grad for _, _, t in leaves])
    for (path, layer, _), a, b in zip(leaves, *grads):
        assert (a is None) == (b is None), path
        if a is not None:
            assert torch.isfinite(a.float()).all(), (path, layer)
            assert torch.equal(a.view(torch.int8), b.view(torch.int8)), \
                (path, layer)


@pytest.mark.parametrize("M,K,N,trans,route", [
    (100, 72, 130, False, "thread"),     # W pitch 260 B: per-thread W loads
    (33, 200, 64, True, "tma"),
    (129, 256, 257, False, "thread"),
    (257, 128, 256, False, "tma"),       # M just past a tile
    (1008, 320, 200, False, "tma"),      # the main path's M; N % 128 != 0
    (300, 72, 136, False, "tma"),        # K not a multiple of BK = 64
    (1008, 256, 392, True, "tma"),       # the tied head's layout, ragged N
    (50, 100, 70, True, "thread"),       # x and tok pitch 200 B
])
def test_pmatmul_kernels(dev, M, K, N, trans, route):
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((2, M, K), generator=g, device=dev).bfloat16()
    w = (torch.randn((N, K) if trans else (K, N), generator=g, device=dev)
         * K ** -0.5).bfloat16()
    w = w.T if trans else w
    kw = dict(trans=trans, ld=K if trans else None, row_off=3, col_off=5)
    for c in fmm.route_counters.values():
        c.launches = 0
    # (True, False): the inactive probe's scale 0 must give x @ w exactly
    for active in ((True, True), (False, False), (True, False)):
        got = fmm.pmatmul_stack(x, w, (9, 9), (0.05, -0.05), active, **kw)
        _close(got, fref.pmatmul_stack(x, w, (9, 9), (0.05, -0.05), active,
                                       **kw))
        for p, s in enumerate((0.05, -0.05)):
            one = fmm.pmatmul(x[p], w, 9, s, active[p], **kw)
            assert torch.equal(one.view(torch.int16),
                               got[p].view(torch.int16))
    assert {k: c.launches for k, c in fmm.route_counters.items()} == {
        "tma": 9 * (route == "tma"), "thread": 9 * (route == "thread")}


@pytest.mark.parametrize("V,route", [(1001, "thread"), (1024, "tma")])
def test_pmatmul_untied_head(dev, V, route):
    """K4 on an untied head/w (D, V) read as stored (``trans=False``,
    ``ld = V``): an odd vocabulary's row pitch is not 16-byte aligned, so
    W takes per-thread loads; z equals the update sweep's z of head/w."""
    from repro_torch.kernels import ops as kops
    g = torch.Generator(device=dev).manual_seed(4)
    D = 256
    h = torch.randn((3, 21, D), generator=g, device=dev).bfloat16()
    w = (torch.randn((D, V), generator=g, device=dev) * D ** -0.5).bfloat16()
    seed = fref.layer_seed(31, "head/w", 0)
    for c in fmm.route_counters.values():
        c.launches = 0
    got = fmm.pmatmul(h, w, seed, 0.05, True)
    assert {k: c.launches for k, c in fmm.route_counters.items()} == {
        "tma": int(route == "tma"), "thread": int(route == "thread")}
    _close(got, fref.pmatmul(h, w, seed, 0.05, True))
    wp = kops.zo_axpy_(w.float().clone(), path="head/w", seed=31,
                       scale=0.05)
    _close(got, (h.float() @ wp.bfloat16().float()).bfloat16())


def test_small_model_pair_loss_matches_cpu(dev):
    cfg = opt.opt_tiny(layers=2, d_model=128, vocab=512).with_(
        dtype="bfloat16")
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    p_gpu = lm.params_from_numpy(cfg, lm.params_to_numpy(p_cpu), dev)
    r = np.random.default_rng(3)
    toks = r.integers(0, 512, (4, 31))
    out = {}
    for d, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        b = {"tokens": torch.tensor(toks, device=d),
             "labels": torch.tensor(toks, device=d),
             "loss_mask": torch.ones((4, 31), device=d)}
        m, _, _ = zo.stratified_select(zo.build_spec(p, lm.zo_group_fn), 7, 1)
        out[d] = lm.lm_loss(cfg, p, b, perturb=fused.make_pair_ctx(
            7, 1e-3, m, "virtual")).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-2, atol=0)


def test_paired_equals_unpaired_on_card(dev):
    """The pairing contract on the card: the paired forward's losses equal
    two single-probe virtual forwards bit for bit."""
    cfg = opt.opt_tiny(layers=2, d_model=128, vocab=512).with_(
        dtype="bfloat16")
    p = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(4), dev)
    toks = torch.tensor(np.random.default_rng(4).integers(0, 512, (4, 31)),
                        device=dev)
    b = {"tokens": toks, "labels": toks,
         "loss_mask": torch.ones((4, 31), device=dev)}
    m, _, _ = zo.stratified_select(zo.build_spec(p, lm.zo_group_fn), 9, 1)
    pair = lm.lm_loss(cfg, p, b, perturb=fused.make_pair_ctx(
        9, 1e-3, m, "virtual"))
    for i, s in enumerate((1e-3, -1e-3)):
        one = lm.lm_loss(cfg, p, b, perturb=fused.make_ctx(9, s, m,
                                                           "virtual"))
        assert torch.equal(one, pair[i]), (i, one.item(), pair[i].item())


@pytest.mark.parametrize("overrides", [
    {"runtime.backend": "pallas"},                     # K1 perturbs in place
    {"runtime.backend": "pallas", "runtime.forward_backend": "virtual"}])
def test_swarm_probe_leaves_params_bit_equal_on_card(dev, overrides):
    """The swarm's shard probe on the card never changes θ, through K1's
    in-place ±εz (materialized) or K3/K4 (virtual); the commit is K1."""
    from repro_torch import api
    from repro_torch.swarm import shardstep
    from repro_torch.train.trainer import Trainer
    spec = api.with_overrides(api.preset("swarm-smoke"), overrides)
    cfg = api.derive(spec).model_cfg.with_(dtype="bfloat16")
    p = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(5), dev)
    tr = Trainer.from_spec(spec, device=dev, params=p)
    data = tr.make_dataset(16)
    batch = tr._model_batch({k: data[k][:8] for k in
                             ("tokens", "labels", "loss_mask")})
    before = {n: t.detach().clone() for n, t in zo.leaf_items(tr.params)}
    kzo.counter.launches = kfa.counter.launches = 0
    for sh in shardstep.shard_batch(batch, 2):
        got = tr._step.probe_shard(tr.params, sh, 17)
        assert got.shape == (2,) and np.isfinite(got).all()
    assert kfa.counter.launches > 0
    assert (kzo.counter.launches > 0) == (
        spec.runtime.forward_backend == "materialized")
    for n, t in zo.leaf_items(tr.params):
        assert torch.equal(t.view(torch.int16) if t.dtype == torch.bfloat16
                           else t, before[n].view(torch.int16)
                           if t.dtype == torch.bfloat16 else before[n]), n
    kzo.counter.launches = 0
    tr._step.apply_commit(tr.params, 17, 0.5)
    assert kzo.counter.launches == len(before)


@pytest.mark.parametrize("P,M,K,N,trans", [
    (3, 100, 72, 130, False),            # per-thread W loads
    (4, 257, 128, 256, False),
    (16, 63, 128, 200, False),
    (5, 40, 256, 392, True),             # the tied head's layout
])
def test_pmatmul_stack_any_p_equals_single_calls(dev, P, M, K, N, trans):
    """K3 at P > 2 with mixed active flags and distinct seeds: each probe
    equals its single-probe call bit for bit and its plain version
    within one bf16 step; launches = the probe groups."""
    g = torch.Generator(device=dev).manual_seed(P)
    x = torch.randn((P, M, K), generator=g, device=dev).bfloat16()
    w = (torch.randn((N, K) if trans else (K, N), generator=g, device=dev)
         * K ** -0.5).bfloat16()
    w = w.T if trans else w
    kw = dict(trans=trans, ld=K if trans else None, row_off=3, col_off=5)
    seeds = tuple(1000 + 7 * p for p in range(P))
    scales = tuple((-1) ** p * 0.05 for p in range(P))
    active = tuple(p % 4 in (0, 3) for p in range(P))
    fmm.stack_counter.launches = 0
    got = fmm.pmatmul_stack(x, w, seeds, scales, active, **kw)
    assert fmm.stack_counter.launches == len(fmm.probe_groups(active))
    _close(got, fref.pmatmul_stack(x, w, seeds, scales, active, **kw))
    for p in range(P):
        one = fmm.pmatmul(x[p], w, seeds[p], scales[p], active[p], **kw)
        assert torch.equal(one.view(torch.int16), got[p].view(torch.int16)), p


def test_flash_backward_matches_autograd_of_plain(dev):
    """K2's backward (row stats from the kernel, tensor-op backward)
    against autograd through its plain version, at the training shape,
    within two bf16 steps: each side rounds its gradient to bf16, and
    autograd through the plain version also rounds dP to bf16 where the
    forward casts P for P·V."""
    g = torch.Generator(device=dev).manual_seed(8)
    B, S, H, dh = 4, 63, 8, 128
    q, k, v = (torch.randn(shape, generator=g, device=dev).bfloat16()
               for shape in ((B, S, H, 1, dh), (B, S, H, dh), (B, S, H, dh)))
    dout = torch.randn((B, S, H, 1, dh), generator=g, device=dev).bfloat16()
    grads = []
    for fn in (kfa.flash_attention, kfa.flash_attention_plain):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        kfa.counter.launches = 0
        out = fn(*ins, causal=True)
        out.backward(dout)
        grads.append([t.grad for t in ins])
    assert kfa.counter.launches == 0      # the plain run launched nothing
    for got, want in zip(*grads):
        _close(got, want, steps=2)


@pytest.mark.parametrize("kind", ["lora", "prefix"])
def test_peft_forward_on_the_card(dev, kind):
    """A bf16 model read through a LoRA merge or prefix keys (K2 at
    k_offset = -P): the card's forward against the CPU's plain one."""
    from repro_torch.peft import lora, prefix
    cfg = opt.opt_tiny(layers=2, d_model=128, vocab=512).with_(
        dtype="bfloat16")
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    p_gpu = lm.params_from_numpy(cfg, lm.params_to_numpy(p_cpu), dev)
    gen = torch.Generator().manual_seed(4)
    if kind == "lora":
        lcfg = lora.LoRAConfig()
        tree = lora.init_lora(p_cpu, lcfg, gen)
        for ab in tree.values():
            ab["B"].normal_(generator=gen).mul_(0.05)
        model = lambda p, t: lora.merge(p, t, lcfg)
    else:
        tree = prefix.init_prefix(cfg, gen, prefix.PrefixConfig(), "cpu")
        model = prefix.inject
    tree_gpu = {k: ({n: x.to(dev) for n, x in v.items()}
                    if isinstance(v, dict) else v.to(dev))
                for k, v in tree.items()}
    toks = torch.randint(0, 512, (3, 40), generator=gen)
    want = lm.forward(cfg, model(p_cpu, tree), toks)
    kfa.counter.launches = 0
    got = lm.forward(cfg, model(p_gpu, tree_gpu), toks.to(dev))
    assert kfa.counter.launches == cfg.num_layers
    _close(got.cpu(), want, steps=4)


@pytest.mark.parametrize("B,S,KV,dh", [(1, 700, 8, 128), (4, 1024, 4, 128),
                                       (2, 257, 4, 64)])
def test_flash_kernel_at_prefill_shapes(dev, B, S, KV, dh):
    """K2 as the lockstep prefill calls it: Sq = Sk = the prompt, q_offset
    0, ragged last tiles."""
    g = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn((B, S, KV, 1, dh), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, KV, dh), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, KV, dh), generator=g, device=dev).bfloat16()
    kfa.counter.launches = 0
    got = kfa.flash_attention(q, k, v, causal=True, q_offset=0)
    assert kfa.counter.launches == 1
    _close(got, kfa.flash_attention_plain(q, k, v, causal=True, q_chunk=512,
                                          k_chunk=2048))


def _lockstep_logits(cfg, p, prompt, steps, dev):
    """The lockstep path's logits (lm.prefill, then lm.serve_step, the
    calls ``generate`` makes), greedy, at batch 1."""
    toks = torch.tensor([prompt], device=dev)
    logits, caches = lm.prefill(cfg, p, toks, max_seq=len(prompt) + steps)
    out = [logits[0].float()]
    for i in range(steps - 1):
        tok = torch.argmax(logits, -1)[:, None]
        logits, caches = lm.serve_step(cfg, p, caches, tok, len(prompt) + i)
        out.append(logits[0].float())
    return out


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_engine_greedy_equals_lockstep_on_card(dev, prefix_cache):
    """The engine at a smoke size in bf16 (2 layers, d_model 128: heads of
    32, which K2 takes; the smoke variant's 16 it does not): each
    request's greedy tokens equal the lockstep's, or their first
    difference is a near-tie.  With prefix sharing the copy-on-write page
    copy runs on the card and the tokens equal sharing off's."""
    from repro_torch import api, serving
    from repro_torch.launch import serve
    cfg = opt.opt_tiny(layers=2, d_model=128, vocab=512).with_(
        dtype="bfloat16")
    p = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(5), dev)
    rng = np.random.default_rng(0)
    system = rng.integers(0, 512, 12).tolist()          # 3 pages
    prompts = [system + rng.integers(0, 512, int(rng.integers(1, 9)))
               .tolist() for _ in range(5)]
    gens = [int(rng.integers(2, 7)) for _ in range(5)]

    def run(share):
        eng = serving.Engine(cfg, p, api.Serving(
            page_size=4, n_pages=32, max_lanes=3, prefill_chunk=8,
            max_seq=64, prefix_cache=share), device=dev)
        seen, sample = {}, eng._sample

        def tapped(logits, seeds, positions):
            for i, (s, q) in enumerate(zip(seeds.tolist(),
                                           positions.tolist())):
                seen[(s, q)] = logits[i].float()
            return sample(logits, seeds, positions)
        eng._sample = tapped
        out = eng.run([serving.Request(rid=i, tokens=t, max_new_tokens=g,
                                       seed=1000 + i)
                       for i, (t, g) in enumerate(zip(prompts, gens))])
        assert eng.n_compiles() == 2
        return {r.rid: r.tokens for r in out}, seen, eng

    got, seen, eng = run(prefix_cache)
    if prefix_cache:
        assert eng.sched.cow_copies > 0
        assert got == run(False)[0]
    for i, (prompt, n) in enumerate(zip(prompts, gens)):
        want = serve.generate(cfg, p, torch.tensor([prompt], device=dev), n,
                              max_seq=64)[0].tolist()
        first = next((t for t in range(n) if got[i][t] != want[t]), None)
        if first is None:
            continue
        lsl = _lockstep_logits(cfg, p, prompt, first + 1, dev)[first]
        delta = (seen[(1000 + i, len(prompt) + first)] - lsl).abs().max()
        top2 = lsl.topk(2).values
        assert top2[0] - top2[1] < delta, (i, first, delta.item())


def _ulp_dist(a, b):
    """Per element distance in steps of a's dtype (bf16 or float32)."""
    if a.dtype == torch.bfloat16:
        i, j, m = a.view(torch.int16), b.view(torch.int16), 0x7FFF
    else:
        i, j, m = a.view(torch.int32), b.view(torch.int32), 0x7FFFFFFF

    def order(t):
        t = t.to(torch.int64)
        return torch.where(t < 0, -(t & m), t)
    return (order(i) - order(j)).abs()


@pytest.mark.parametrize("kind,shape,dtype,layout,G", [
    ("layer", (1008, 5120), torch.bfloat16, "rows", None),   # OPT-13B cells
    ("layer", (1008, 5120), torch.float32, "rows", None),
    ("rms", (4080, 2048), torch.bfloat16, "rows", None),     # DeepSeek cell
    ("rms", (4080, 2048), torch.float32, "rows", None),
    ("rms", (16, 255, 512), torch.bfloat16, "kv_slice", None),  # stride 576
    ("rms", (16, 63, 40, 128), torch.bfloat16, "rows", None),   # qk-norm
    ("layer", (37, 1001), torch.bfloat16, "rows", None),     # odd D, a CTA
    ("layer", (37, 1001), torch.float32, "rows", None),
    ("rms", (50, 77), torch.bfloat16, "rows", None),         # odd D, a warp
    ("layer", (64, 1024), torch.bfloat16, "misaligned", None),
    ("layer", (2, 504, 5120), torch.bfloat16, "rows", 2),    # paired probes
    ("rms", (2, 504, 2048), torch.float32, "rows", 2),
    ("rms", (8, 16384), torch.float32, "rows", None),        # 512 threads
    ("layer", (8, 12288), torch.bfloat16, "rows", None),     # 256 threads
])
def test_norm_kernel_against_plain(dev, kind, shape, dtype, layout, G):
    """The norm kernel against the plain float32 ops on the same card,
    and two launches bit for bit.  bf16: within one step on all but
    0.01 % of elements, and all but 0.1 % equal (the two means are
    summed in another order).  float32: a last-bit change of mu moves
    x - mu by many float32 steps where it cancels, so each is held to a
    float64 oracle instead: the kernel's largest error at most the plain
    ops' plus one float32 step of the largest output."""
    from repro_torch.kernels import norm as knorm
    g = torch.Generator(device=dev).manual_seed(11)
    D = shape[-1]
    rnd = lambda s: torch.randn(s, generator=g, device=dev) * 2 + 0.3
    if layout == "kv_slice":
        x = rnd(shape[:-1] + (D + 64,)).to(dtype)[..., :D]
    elif layout == "misaligned":           # row bases 2 or 4 bytes off
        x = rnd((int(np.prod(shape)) + 1,)).to(dtype)[1:].view(shape)
    else:
        x = rnd(shape).to(dtype)
    ps = tuple(1 + 0.1 * torch.randn((D,) if G is None else (G, 1, D),
                                     generator=g, device=dev)
               for _ in range(2 if kind == "layer" else 1))
    fn, plain = ((knorm.layer_norm, knorm.layer_norm_plain)
                 if kind == "layer"
                 else (knorm.rms_norm, knorm.rms_norm_plain))
    before = knorm.counter.launches
    got, again, want = fn(x, *ps), fn(x, *ps), plain(x, *ps)
    assert knorm.counter.launches == before + 2
    assert got.shape == x.shape and got.dtype == dtype
    assert torch.equal(got, again)
    if dtype == torch.bfloat16:
        u = _ulp_dist(got, want)
        assert (u > 1).float().mean().item() <= 1e-4, u.max().item()
        assert (u > 0).float().mean().item() <= 1e-3
        return
    xd = x.double()
    if kind == "layer":
        xd = xd - xd.mean(-1, keepdim=True)
    ref = xd / torch.sqrt((xd * xd).mean(-1, keepdim=True) + 1e-5) * ps[0]
    if kind == "layer":
        ref = ref + ps[1]
    err_k, err_p = ((t.double() - ref).abs().max().item() for t in (got, want))
    assert err_k <= err_p + 2.0 ** -23 * ref.abs().max().item(), (err_k, err_p)


def test_norm_kernel_takes_a_one_rank_mesh_block_by_block(dev):
    """A replicated DTensor on a one-rank mesh launches the kernel on its
    block: the same bits as the plain tensor's call, placements kept."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels import norm as knorm
    from repro_torch.launch import dryrun
    from repro_torch.models import layers
    dryrun.fake_world(1)
    try:
        mesh = init_device_mesh("cuda", (1,))
        g = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn((4, 63, 5120), generator=g, device=dev).bfloat16()
        s, b = (1 + 0.1 * torch.randn((5120,), generator=g, device=dev)
                for _ in range(2))
        dt = lambda t: DTensor.from_local(t, mesh, (Replicate(),),
                                          run_check=False)
        before = knorm.counter.launches
        y = layers.layer_norm(dt(x), dt(s), dt(b))
        assert knorm.counter.launches == before + 1
        assert isinstance(y, DTensor) and y.placements == (Replicate(),)
        assert torch.equal(y.to_local(), layers.layer_norm(x, s, b))
    finally:
        torch.distributed.destroy_process_group()


def test_norm_counters_in_a_zo_step_on_card(dev):
    """A two-point ZO step of a tiny bf16 OPT with materialized probes
    runs every norm through the kernel: 2 a layer and the final norm, a
    forward, two forwards; none takes the plain ops.  Under an annotating
    tracer and a profiler each launch opens ``kernel/norm`` directly
    inside ``model/norm``."""
    from repro_torch import obs
    from repro_torch.estimators import EstimatorConfig, make_step
    from repro_torch.kernels import norm as knorm
    L = 3
    cfg = opt.opt_tiny(layers=L, d_model=128, vocab=512).with_(
        dtype="bfloat16")
    p = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(6), dev)
    step, init = make_step(
        lambda q, b, perturb=None: lm.lm_loss(cfg, q, b, perturb=perturb),
        zo.build_spec(p, lm.zo_group_fn),
        EstimatorConfig(eps=1e-3, lr=1e-4, n_drop=1, backend="pallas",
                        forward_backend="materialized"))
    toks = torch.tensor(np.random.default_rng(6).integers(0, 512, (4, 31)),
                        device=dev)
    b = {"tokens": toks, "labels": toks,
         "loss_mask": torch.ones((4, 31), device=dev)}
    before = knorm.counter.launches
    tr = obs.Tracer()
    with obs.use(tr):
        step(p, init(), b, 0, 7)
    assert tr.counters.get(obs.CTR_NORM_PLAIN, 0) == 0
    assert tr.counters[obs.CTR_NORM_KERNEL] == 4 * L + 2
    assert knorm.counter.launches - before == 4 * L + 2
    with obs.use(obs.Tracer(annotate=True)), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(p, init(), b, 1, 7)
    kr = [e for e in prof.events() if e.name == obs.trace.KERNEL_NORM]
    assert len(kr) == 4 * L + 2
    assert all(e.cpu_parent is not None
               and e.cpu_parent.name == obs.trace.MODEL_NORM for e in kr)


def _scan_inputs(dev, Bn, S, Di, St, dtype, h0, seed=9):
    """The scan's arguments as ``mamba_fwd`` hands them over: x and z
    the two halves of one (Bn, S, 2 Di) projection, B and C slices of
    one (Bn, S, R + 2 St) float32 projection (row strides 2 Di and R +
    2 St), at Jamba's ranges (delta about 0.3-1.3, A about -1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    R = 8
    xz = torch.randn((Bn, S, 2 * Di), generator=g, device=dev).to(dtype)
    proj = torch.randn((Bn, S, R + 2 * St), generator=g, device=dev)
    return (torch.randn((Bn, S, Di), generator=g, device=dev),
            0.1 * torch.randn((Di,), generator=g, device=dev),
            0.1 * torch.randn((Di, St), generator=g, device=dev),
            xz[..., :Di], proj[..., R:R + St], proj[..., R + St:],
            torch.randn((Di,), generator=g, device=dev), xz[..., Di:],
            None if not h0 else torch.randn((Bn, Di, St), generator=g,
                                             device=dev))


@pytest.mark.parametrize("Bn,S,Di,St,dtype,h0,final", [
    (16, 63, 8192, 16, torch.bfloat16, False, False),  # Jamba's train shape
    (2, 37, 300, 16, torch.bfloat16, True, True),      # ragged S and Di
    (3, 100, 4096, 16, torch.float32, True, True),     # a TP rank's half
    (2, 1, 130, 8, torch.bfloat16, True, True),        # one step, St 8
    (1, 33, 64, 4, torch.float32, False, True),        # a tile and one
])
def test_mamba_scan_kernel_against_plain(dev, Bn, S, Di, St, dtype, h0,
                                         final):
    """The selective-scan kernel against ``ssm._scan_plain`` (softplus,
    the doubling ``_mamba_scan``, the skip and the gate) on the card, in
    train (no final state) and prefill (the last h), from h0 zero and
    not, at S off the kernel's 32-step tile and a channel count off its
    128.  Tolerance: y within one bf16 rounding step of the plain result
    (``_close``), or 1e-4 relative in float32 (the sequential scan sums
    in another order than the doubling scan and takes exp and log from
    the SFU, a few float32 ulp a step compounded over S); h within
    1e-4."""
    from repro_torch.kernels import mamba_scan as kscan
    from repro_torch.models import ssm
    args = _scan_inputs(dev, Bn, S, Di, St, dtype, h0)
    before = kscan.counter.launches
    y, h = kscan.mamba_scan(ssm._scan_plain, *args, final=final)
    assert kscan.counter.launches == before + 1
    torch.cuda.synchronize()
    want_y, want_h = ssm._scan_plain(*args)
    assert y.dtype == dtype and y.shape == (Bn, S, Di)
    if dtype == torch.bfloat16:
        _close(y, want_y)
    else:
        torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-5)
    if final:
        torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-5)
    else:
        assert h is None


def test_mamba_scan_counters_and_bypass(dev):
    """Under a tracer a scan the kernel takes counts one launch in
    ``obs.CTR_SCAN_KERNEL``; one recorded by autograd (an input that
    wants a gradient) runs the plain ops and counts in
    ``obs.CTR_SCAN_PLAIN``; a Jamba smoke ZO step on the card (the
    published fields on, bf16) launches the kernel once a Mamba layer a
    forward and bypasses it never (the smoke widened to d_model 128, K2's
    head dim 32)."""
    from repro_torch import configs, obs
    from repro_torch.estimators import EstimatorConfig, make_step
    from repro_torch.kernels import mamba_scan as kscan
    from repro_torch.models import ssm
    args = _scan_inputs(dev, 2, 20, 256, 16, torch.bfloat16, False)
    tr = obs.Tracer()
    with obs.use(tr):
        kscan.mamba_scan(ssm._scan_plain, *args)
        grad = (args[0].clone().requires_grad_(),) + args[1:]
        y, _ = kscan.mamba_scan(ssm._scan_plain, *grad)
    assert y.requires_grad
    assert tr.counters == {obs.CTR_SCAN_KERNEL: 1, obs.CTR_SCAN_PLAIN: 1}
    cfg = configs.get("jamba-v0.1-52b", "smoke").with_(
        dtype="bfloat16", d_model=128, mamba_dtbc_norm=True,
        moe_renormalize=False, expert_shard=(1, 2), pos_emb="none")
    p = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(6), dev)
    step, init = make_step(
        lambda q, b, perturb=None: lm.lm_loss(cfg, q, b, perturb=perturb),
        zo.build_spec(p, lm.zo_group_fn),
        EstimatorConfig(eps=1e-3, lr=1e-4, n_drop=1, backend="pallas",
                        forward_backend="materialized"))
    toks = torch.tensor(np.random.default_rng(6).integers(0, cfg.vocab,
                                                          (4, 31)),
                        device=dev)
    b = {"tokens": toks, "labels": toks,
         "loss_mask": torch.ones((4, 31), device=dev)}
    n_mamba = sum(st.repeat for st in cfg.stages for blk in st.pattern
                  if blk.kind == "mamba")
    before = kscan.counter.launches
    tr = obs.Tracer()
    with obs.use(tr):
        _, _, m = step(p, init(), b, 0, 7)
    assert tr.counters.get(obs.CTR_SCAN_PLAIN, 0) == 0
    assert tr.counters[obs.CTR_SCAN_KERNEL] == 2 * n_mamba
    assert kscan.counter.launches - before == 2 * n_mamba
    assert np.isfinite(float(m["l_plus"])) and np.isfinite(
        float(m["l_minus"]))


def test_jamba_published_loss_on_card_matches_cpu(dev):
    """Jamba's smoke model in bf16, widened to d_model 128 (K2's head
    dim 32), with the published fields (dt/B/C norms, top-2
    unrenormalized, experts 1-2 of 4 held, no rope): the card's loss
    (the scan kernel, the norm kernel, K2) against the CPU's plain ops
    within 1e-2, as ``test_small_model_pair_loss_matches_cpu`` holds
    OPT's (bf16 activations rounded at other places on the two)."""
    from repro_torch import configs
    cfg = configs.get("jamba-v0.1-52b", "smoke").with_(
        dtype="bfloat16", d_model=128, mamba_dtbc_norm=True,
        moe_renormalize=False, expert_shard=(1, 2), pos_emb="none")
    p_cpu = lm.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    p_gpu = lm.params_from_numpy(cfg, lm.params_to_numpy(p_cpu), dev)
    toks = torch.tensor(np.random.default_rng(7).integers(0, cfg.vocab,
                                                          (4, 63)))
    b = {"tokens": toks, "labels": toks, "loss_mask": torch.ones((4, 63))}
    with torch.no_grad():
        want = float(lm.lm_loss(cfg, p_cpu, b))
        got = float(lm.lm_loss(cfg, p_gpu, {k: v.to(dev)
                                            for k, v in b.items()}))
    assert abs(got - want) <= 1e-2 * abs(want), (got, want)


def test_port_loads_no_jax_or_reference():
    """Importing every port module (and chip_smoke.py), the swarm's
    worker entry among them, loads no module of jax or of the JAX
    package: checked in a fresh interpreter."""
    import os
    import subprocess
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                               'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.tasks, repro_torch.peft, repro_torch.launch\n"
        "import repro_torch.launch.cli, repro_torch.peft.lora\n"
        "import repro_torch.obs, repro_torch.launch.report\n"
        "import repro_torch.launch.replay\n"
        "import repro_torch.swarm, repro_torch.swarm.shardstep\n"
        "import repro_torch.swarm.coordinator, repro_torch.swarm.worker\n"
        "import repro_torch.swarm.driver\n"
        "import repro_torch.serving, repro_torch.launch.serve\n"
        "from repro_torch.launch import cli\n"
        "cli.build_parser().parse_args(['swarm', '--attach', 'h:1'])\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(sum(m.startswith('repro_torch') for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(root, "src"), root]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, check=True)
    assert int(out.stdout.strip()) > 30
