"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small and ragged shapes.  Marked ``cuda``: they skip on a
machine without a GPU and run on one with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: K1 masked rows bit-equal and active rows within 1 bf16 ulp
(z differs from the plain version by a few float32 ulp); K2-K4 within
one bf16 rounding step of the output (2^-7 relative, plus 2^-8 of the
largest magnitude near zero); K3 at any P bit-equal to P K4 calls; K2's
backward within two steps (stated at its test).
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
    (4, 1, 63, 2, 1, 128, 62, 0, True),      # one query at position 62
    (2, 37, 50, 2, 1, 32, 0, 40, True),      # no row sees a key: out = 0
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


def test_port_loads_no_jax_or_reference():
    """Importing every port module (and chip_smoke.py) loads no module
    of jax or of the JAX package: checked in a fresh interpreter."""
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
