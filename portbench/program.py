"""The system under test: the ZO step of ``repro_torch`` for a cell.

The window drives ``estimators.make_step`` over ``models.lm.lm_loss``,
the step ``train.trainer.Trainer`` runs for a ZO spec, with K1 as the
axpy (``backend=pallas``) and the cell's forward backend.  The
parameters are the benchmark's weights (``weights.make_row``) in the
program's own tree, built from the configuration file's ``port``
section.  From the program the benchmark takes only this step, its
``obs.trace`` spans and its kernels' launch counters.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from portbench import weights, zrng

# trace names of the kernels whose wrappers count their launches
KERNELS = {"zo_axpy_2d_kernel": ("zo_axpy_2d",),
           "flash_fwd_kernel": ("flash_attention",),
           "pmatmul_kernel": ("pmatmul_stack", "pmatmul")}


def model_config(cfg):
    """The port's ``ModelConfig`` from the configuration's ``port``."""
    from repro_torch.models.config import BlockCfg, ModelConfig, StageCfg

    kw = dict(cfg["port"])
    kw["stages"] = tuple(StageCfg(r, tuple(BlockCfg(*b) for b in pat))
                         for r, pat in kw["stages"])
    return ModelConfig(**kw)


def leaves(mcfg):
    """[(path, shape, dtype name)] of the program's parameter tree."""
    from repro_torch.core import zo
    from repro_torch.models import lm

    meta = lm.init_params(mcfg, None, "meta")
    return [(p, tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in zo.leaf_items(meta)]


def make_params(mcfg, seed, device):
    """The program's parameters, each row made by ``weights.make_row``."""
    from repro_torch.models import lm

    tree = {}
    for path, shape, dt in leaves(mcfg):
        node = tree
        *parents, name = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = weights.make_leaf(seed, path, shape,
                                       weights.dtype_of(dt), device)
    return lm.LM(mcfg, tree)


def build_step(mcfg, traffic, params):
    """``step(params, state, batch, t, base) -> (params, state,
    metrics)`` and its initial state, for the traffic's estimator."""
    from repro_torch import estimators
    from repro_torch.core import zo
    from repro_torch.models import lm

    spec = zo.build_spec(params, lm.zo_group_fn)
    est = estimators.EstimatorConfig(
        name=traffic["estimator"], eps=traffic["eps"], lr=traffic["lr"],
        n_drop=int(traffic["sparsity"] * spec.num_layers),
        backend=traffic["backend"],
        forward_backend=traffic["forward_backend"])
    step, init = estimators.make_step(
        lambda p, b, perturb=None: lm.lm_loss(mcfg, p, b, perturb=perturb),
        spec, est)
    return step, init()


def launches():
    """{trace name part: launches so far} from the kernels' counters."""
    from repro_torch.fused import matmul as fmm
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.kernels import zo_axpy as kzo

    c = {"zo_axpy_2d": kzo.counter, "flash_attention": kfa.counter,
         "pmatmul_stack": fmm.stack_counter, "pmatmul": fmm.single_counter}
    return {name: sum(c[k].launches for k in ks)
            for name, ks in KERNELS.items()}


@torch.no_grad()
def changes(params, seed, device):
    """{"path:layer": (norm, projection) of theta - theta_0} over every
    row (``weights.change``), theta_0 made again from the seed."""
    from repro_torch.core import zo

    out = {}
    for path, t in zo.leaf_items(params):
        shape = tuple(t.shape)
        for layer in range(weights.rows(path, shape)):
            row = t[layer] if zrng.group_of(path) else t
            t0 = weights.make_row(seed, path, shape, t.dtype, layer, device)
            out[f"{path}:{layer}"] = weights.change(row, t0, seed, path,
                                                    layer)
    return out


def spans():
    """A fenced tracer over an in-memory ring, and the stage names."""
    from repro_torch.obs import sinks
    from repro_torch.obs import trace as obs

    ring = sinks.RingSink(1 << 16)
    return obs.use(obs.Tracer(sinks=[ring], fence=True)), ring, {
        "perturb_update": (obs.PERTURB, obs.UPDATE),
        "forward": (obs.FWD_PAIR, obs.FWD_PLUS, obs.FWD_MINUS)}


# ------------------------------------------------- faults (checks only)
FAULTS = ("unchanged", "half_batch", "neg_update", "double_update")


@contextlib.contextmanager
def fault(name):
    """The program's step broken underneath, for the checks that show
    ``correct`` fails: ``unchanged`` a step that returns the state it
    was given (every sweep's scale 0); ``half_batch`` the loss over the
    first half of the batch rows, the mean over those; ``neg_update``
    and ``double_update`` the projected gradient that the update takes
    altered where the estimator makes it, to -g and 2g (the gradient it
    reports, and the losses, left as they are)."""
    from repro_torch.core import zo
    from repro_torch.estimators import two_point
    from repro_torch.models import lm

    saved = []

    def patch(mod, attr, fn):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, fn)

    if name == "unchanged":
        axpy = zo.tree_axpy_
        patch(zo, "tree_axpy_", lambda p, spec, seed, scale, *a, **k:
              axpy(p, spec, seed, 0.0, *a, **k))
    elif name == "half_batch":
        loss = lm.lm_loss

        def half(cfg, params, batch, *a, **k):
            n = batch["labels"].shape[0] // 2
            return loss(cfg, params, {key: v[:n] for key, v in batch.items()},
                        *a, **k)
        patch(lm, "lm_loss", half)
    elif name in ("neg_update", "double_update"):
        estimate = two_point.TwoPointSPSA.estimate
        k = np.float32(-1.0 if name == "neg_update" else 2.0)

        def altered(self, *a, **kw):
            params, dirs, metrics = estimate(self, *a, **kw)
            dirs = dataclasses.replace(
                dirs, coeffs=tuple(k * c for c in dirs.coeffs))
            return params, dirs, metrics
        patch(two_point.TwoPointSPSA, "estimate", altered)
    elif name is not None:
        raise ValueError(f"fault {name!r} not in {FAULTS}")
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
