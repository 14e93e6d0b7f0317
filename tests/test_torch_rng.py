"""Port parity: the counter RNG of ``repro_torch.core.rng`` against
``repro.core.rng``.  Integer hashes bit for bit; normals within 4 ulp of
max(|z|, 1) (the two frameworks' log/cos round differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rng as jrng
from repro.kernels import ref as jref
from repro_torch.core import rng as trng
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)              # six xdist workers share the CPUs


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, size=n,
                                                dtype=np.uint64).astype(
                                                    np.uint32)


def test_mix32_bit_exact():
    w = _words(1 << 16, 0)
    want = np.asarray(jrng.mix32(jnp.asarray(w))).astype(np.int64)
    assert np.array_equal(trng.mix32(w.astype(np.int64)).numpy(), want)


def test_fold_bit_exact():
    s, d = _words(4096, 1), _words(4096, 2)
    want = np.asarray(jrng.fold(jnp.asarray(s), jnp.asarray(d)))
    got = trng.fold(s.astype(np.int64), d.astype(np.int64)).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    for a, b in zip(s[:64].tolist(), d[:64].tolist()):
        assert trng.fold_py(a, b) == jrng.fold_py(a, b)


@pytest.mark.parametrize("path", ["embed/tok", "stages/s0/b0/mix/wq",
                                  "final_norm/scale", "sel/s0.b0", ""])
def test_leaf_uid_matches(path):
    assert trng.leaf_uid(path) == jrng.leaf_uid(path)


@pytest.mark.parametrize("seed", [0, 7, 0x9E3779B9, 2 ** 32 - 1])
def test_counter_normal_within_4_ulp(seed):
    c = np.arange(1 << 18, dtype=np.uint32) * np.uint32(2654435761)
    want = np.asarray(jrng.counter_normal(jnp.uint32(seed), jnp.asarray(c)))
    got = trng.counter_normal(seed, c.astype(np.int64)).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert np.all(np.abs(got - want) <= 4 * ulp), _which_side_moved(
        seed, c, got, want, ulp)


def _which_side_moved(seed, c, got, want, ulp):
    """The failing elements, each side's distance in ulps from the
    float64 value of the same uniforms (either is ~2 ulp at most when
    healthy), and both sides' hashes to hold against a passing run."""
    import hashlib
    bad = np.flatnonzero(np.abs(got - want) > 4 * ulp)[:8]
    u = [trng._uniform01(trng.mix32(x)).double().numpy()[bad] for x in (
        (torch.as_tensor(c.astype(np.int64)) * trng.GOLDEN + seed)
        & trng.MASK32,
        (((torch.as_tensor(c.astype(np.int64)) + trng.S2) & trng.MASK32)
         * trng.GOLDEN + (seed ^ trng.S2)) & trng.MASK32)]
    arg = (np.float32(trng.TWO_PI) * u[1].astype(np.float32)).astype(
        np.float64)
    exact = np.sqrt(-2.0 * np.log(u[0])) * np.cos(arg)
    md5 = lambda a: hashlib.md5(a.tobytes()).hexdigest()[:8]
    return (f"elements {bad.tolist()}: port {got[bad].tolist()}, jax "
            f"{want[bad].tolist()}, float64 {exact.tolist()}; port off by "
            f"{((got[bad] - exact) / ulp[bad]).round(2).tolist()} ulp, jax "
            f"by {((want[bad] - exact) / ulp[bad]).round(2).tolist()}; "
            f"md5 port {md5(got)} jax {md5(want)}")


def test_leaf_normal_nd_matches_reference():
    want = np.asarray(jref.leaf_normal_nd(jnp.uint32(5), (3, 4, 6)))
    got = tref.leaf_normal_nd(5, (3, 4, 6)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 2.0 ** -23 * 4)


def test_moments():
    z = tref.leaf_normal_nd(7, (4, 200_000)).numpy().ravel()
    assert abs(z.mean()) < 0.01
    assert abs(z.std() - 1.0) < 0.01
    assert abs(((z - z.mean()) ** 3).mean()) < 0.02
    assert abs(((z - z.mean()) ** 4).mean() - 3.0) < 0.05


def test_rows_decorrelated_and_seeded():
    z = tref.leaf_normal_nd(3, (8, 50_000)).numpy()
    for i in range(7):
        assert abs(np.corrcoef(z[i], z[i + 1])[0, 1]) < 0.02
    a = tref.leaf_normal_nd(1, (2, 1000))
    b = tref.leaf_normal_nd(2, (2, 1000))
    assert torch.all(a != b)
    assert torch.equal(a, tref.leaf_normal_nd(1, (2, 1000)))


def test_uniform01_takes_every_grid_value_once():
    """The premise of the kernels' exhaustive z check: uniform01 maps the
    2^24 values of ``bits >> 8`` to exactly (k + 1) 2^-24, 2^24 distinct
    floats in (0, 1], none 0."""
    m = torch.arange(1 << 24, dtype=torch.int64)
    u = trng._uniform01(m << 8)
    assert u.dtype == torch.float32
    assert torch.equal(u.double(), (m + 1).double() * 2.0 ** -24)
    assert bool((u[1:] > u[:-1]).all()) and u[0].item() > 0
    assert u[-1].item() == 1.0


def test_uniform01_matches_reference():
    bits = np.concatenate([_words(1 << 16, 5), np.array(
        [0, 255, 256, 2 ** 32 - 1, 2 ** 31, 2 ** 31 - 1], dtype=np.uint32)])
    want = np.asarray(jrng._uniform01(jnp.asarray(bits)))
    got = trng._uniform01(torch.tensor(bits.astype(np.int64))).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
