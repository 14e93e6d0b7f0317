"""FO numerics on a bfloat16 model: where the port parts from the
reference on purpose.

The reference's clipped update multiplies the bf16 gradients by a
float32 clip scale (``repro/core/fo.py:58-66``), which promotes every
leaf: from step 2 on its forward runs in float32, a different model
from the one it was asked to train (a reference caveat).  The port
keeps the forward in the leaves' dtype and the update on float32
masters (``core/fo.py``).  Three FO-SGD steps with ``grad_clip`` on
``qwen3-14b``/``smoke`` in bfloat16 pin both behaviours:

  * the reference's leaves come back float32 after step 1, and stay so;
  * the port's own three steps keep every bf16 leaf bf16, each the bf16
    rounding of its float32 master;
  * the masters hold the reference's values: driven by the reference's
    gradients at each step (its forward's, float32 from step 2), the
    port's update leaves every master within PARAM_ATOL of the
    reference's float32 leaf, step after step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.core import fo as jfo
from repro.core import zo as jzo
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.core import fo as tfo
from repro_torch.core import zo as tzo
from repro_torch.models import lm as tlm

torch.set_num_threads(2)              # six xdist workers share the CPUs

ARCH, STEPS, B, S = "qwen3-14b", 3, 2, 16
KW = dict(optimizer="sgd", lr=3e-2, weight_decay=0.01, grad_clip=0.5)
PARAM_ATOL = 1e-6                     # tests/test_torch_modes.py


def _setup():
    jc = jconfigs.get(ARCH, "smoke").with_(dtype="bfloat16")
    tc = tconfigs.get(ARCH, "smoke").with_(dtype="bfloat16")
    jp = jlm.init_params(jc, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "loss_mask": np.ones((B, S), np.float32)}
    return jc, tc, jp, batch


def _flat(tree):
    return {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_fo_bf16_reference_promotes_port_keeps_bf16_with_masters():
    jc, tc, jp0, batch = _setup()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    jcfg, tcfg = jfo.FOConfig(**KW), tfo.FOConfig(**KW)
    jstep = jax.jit(jfo.make_fo_step(lambda p, b: jlm.lm_loss(jc, p, b),
                                     jcfg))
    jgrad = jax.jit(jax.grad(lambda p, b: jlm.lm_loss(jc, p, b)))
    bf16 = [p for p, v in _flat(jp0).items() if v.dtype == jnp.bfloat16]
    assert bf16

    # the reference, and the port driven by its gradients
    tp = tlm.params_from_numpy(tc, _flat(jp0), "cpu")
    forced = tfo.init_state(tp, tcfg)
    jp, js = jp0, jfo.init_state(jp0, jcfg)
    for t in range(STEPS):
        g = _flat(jgrad(jp, jb))
        jp, js, _ = jstep(jp, js, jb, jnp.int32(t))
        ref = _flat(jp)
        assert all(ref[p].dtype == np.float32 for p in bf16), t
        forced = tfo.apply_update(forced, [
            torch.tensor(np.asarray(g[p] if l is None else g[p][l],
                                    np.float32))
            for p, l, _ in forced.leaves], tcfg, tcfg.lr)
        for (p, l, leaf), m in zip(forced.leaves, forced.master):
            want = ref[p] if l is None else ref[p][l]
            if p in bf16:
                assert leaf.dtype == torch.bfloat16 and m is not None, p
                np.testing.assert_allclose(m.numpy(), want, rtol=0,
                                           atol=PARAM_ATOL, err_msg=p)
            else:
                assert m is None, p

    # the port's own steps: bf16 leaves, each its master rounded
    tp = tlm.params_from_numpy(tc, _flat(jp0), "cpu")
    ts = tfo.init_state(tp, tcfg)
    step = tfo.make_fo_step(lambda p, b: tlm.lm_loss(tc, p, b, grad=True),
                            tcfg)
    for t in range(STEPS):
        tp, ts, m = step(tp, ts, tb, t)
        assert np.isfinite(float(m["loss"]))
        assert all(v.dtype == torch.bfloat16
                   for p, v in tzo.leaf_items(tp) if p in bf16)
        for (p, l, leaf), mst in zip(ts.leaves, ts.master):
            if p in bf16:
                assert mst.dtype == torch.float32, p
                assert torch.equal(leaf.detach(), mst.to(torch.bfloat16)), p
