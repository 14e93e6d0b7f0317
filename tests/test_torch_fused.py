"""Port parity: the virtual-perturbation matmuls (kernels K3/K4's plain
versions on the CPU) and perturbed embeddings against ``repro.fused.ref``.

Within the port: an inactive probe equals the plain matmul bit for bit,
and a stacked call equals per-probe calls bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fused import ref as jref
from repro_torch.fused import matmul as tmm
from repro_torch.fused import ref as tref

SEED = 0x5EED


def _xw(M, K, N, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((M, K)).astype(np.float32),
            r.standard_normal((K, N)).astype(np.float32) * K ** -0.5)


@pytest.mark.parametrize("M,K,N,trans,ld,row0,col0", [
    (8, 16, 24, False, None, 0, 0),
    (5, 7, 13, False, 40, 3, 11),            # window into a wider leaf
    (6, 12, 20, True, None, 0, 0),           # tied head: w is tok.T
    (4, 10, 9, True, 30, 2, 2 ** 32 - 5),    # uint32 counter wrap
])
def test_pmatmul_matches_reference(M, K, N, trans, ld, row0, col0):
    x, w = _xw(M, K, N)
    want = np.asarray(jref.pmatmul(jnp.asarray(x), jnp.asarray(w),
                                   jnp.uint32(SEED), 1e-2, trans=trans,
                                   ld=ld, row0=row0, col0=col0))
    wt = torch.tensor(w.T.copy()).T if trans else torch.tensor(w)
    got = tmm.pmatmul(torch.tensor(x), wt, SEED, 1e-2, True, trans=trans,
                      ld=ld, row_off=row0, col_off=col0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    zt = tref.zmat(SEED, K, N, row0=row0, col0=col0, ld=ld, trans=trans)
    zj = np.asarray(jref.zmat(jnp.uint32(SEED), K, N, row0=row0, col0=col0,
                              ld=ld, trans=trans))
    np.testing.assert_allclose(zt.numpy(), zj, rtol=0, atol=4 * 2.0 ** -21)


def test_inactive_equals_plain_matmul_bitwise():
    x, w = (torch.tensor(a) for a in _xw(9, 16, 12))
    assert torch.equal(tmm.pmatmul(x, w, SEED, 1e-3, False), x @ w)
    out = tmm.pmatmul_stack(torch.stack([x, x]), w, (SEED, SEED),
                            (1e-3, -1e-3), (False, False))
    assert torch.equal(out[0], x @ w) and torch.equal(out[1], x @ w)


@pytest.mark.parametrize("trans", [False, True])
def test_stack_equals_per_probe_bitwise(trans):
    r = np.random.default_rng(3)
    x = torch.tensor(r.standard_normal((2, 3, 5, 16)).astype(np.float32))
    w = torch.tensor(r.standard_normal((16, 24)).astype(np.float32))
    w = w.T.contiguous().T if trans else w
    for active in ((True, True), (True, False)):
        got = tmm.pmatmul_stack(x, w, (SEED, SEED), (1e-3, -1e-3), active,
                                trans=trans)
        for p, s in enumerate((1e-3, -1e-3)):
            want = tmm.pmatmul(x[p], w, SEED, s, active[p], trans=trans)
            assert torch.equal(got[p], want)
    want = np.asarray(jref.pmatmul_stack(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray([SEED, SEED], jnp.uint32),
        jnp.asarray([1e-3, -1e-3], jnp.float32),
        jnp.asarray([True, False]), trans=trans))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pvec_pembed_ppos_match_reference():
    r = np.random.default_rng(4)
    w = r.standard_normal((40,)).astype(np.float32)
    np.testing.assert_allclose(
        tref.pvec(torch.tensor(w), SEED, 1e-2).numpy(),
        np.asarray(jref.pvec(jnp.asarray(w), jnp.uint32(SEED), 1e-2)),
        rtol=1e-6, atol=1e-7)
    tok = r.standard_normal((50, 8)).astype(np.float32)
    toks = r.integers(0, 50, (3, 7)).astype(np.int32)
    np.testing.assert_allclose(
        tref.pembed(torch.tensor(tok), torch.tensor(toks), SEED,
                    1e-2).numpy(),
        np.asarray(jref.pembed(jnp.asarray(tok), jnp.asarray(toks),
                               jnp.uint32(SEED), 1e-2)),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tref.ppos(torch.tensor(tok), 4, 7, SEED, -1e-2).numpy(),
        np.asarray(jref.ppos(jnp.asarray(tok), 4, 7, jnp.uint32(SEED),
                             -1e-2)),
        rtol=1e-6, atol=1e-7)
    stack = tref.pembed_stack(torch.tensor(tok), torch.tensor(toks),
                              (SEED, SEED), (1e-2, -1e-2))
    for p, s in enumerate((1e-2, -1e-2)):
        assert torch.equal(stack[p], tref.pembed(
            torch.tensor(tok), torch.tensor(toks), SEED, s))


def test_layer_seed_matches_reference():
    for path, layer in (("embed/tok", 0), ("stages/s0/b0/mix/wq", 7)):
        assert tref.layer_seed(SEED, path, layer) == int(
            jref.layer_seed(jnp.uint32(SEED), path, layer))


@pytest.mark.parametrize("K,N,trans,want", [
    (64, 20480, False, (True, True)),        # FFN up projection's pitch
    (24, 5120, False, (True, True)),         # FFN down projection's pitch
    (5120, 72, True, (True, True)),          # tied head, tok.T
    (72, 130, False, (True, False)),         # W pitch 260 B
    (100, 70, True, (False, False)),         # x and tok pitch 200 B
    (256, 257, False, (True, False)),
])
def test_pmatmul_load_routes(K, N, trans, want):
    """K3/K4 load an operand by TMA only where its base and row pitch are
    16-byte aligned; the others take per-thread loads."""
    x = torch.zeros((2, 3, K), dtype=torch.bfloat16)
    w = torch.zeros((N, K) if trans else (K, N), dtype=torch.bfloat16)
    assert tmm.load_routes(x, w.T if trans else w) == want
    shifted = torch.zeros(K * N + 1, dtype=torch.bfloat16)[1:].view(w.shape)
    assert tmm.load_routes(x, shifted.T if trans else shifted)[1] is False
