"""First-order baselines, the paper's "FT" rows: SGD, momentum and AdamW
with global-norm clipping (counterpart of ``repro/core/fo.py``).

The gradient comes from autograd through the model (``lm_loss(...,
grad=True)``; attention through kernel K2's ``torch.autograd.Function``).
The trainable leaves are :func:`models.lm.grad_leaves`: every stacked
leaf split into per-layer views, so each layer's gradient is a tensor of
its own (a PEFT dict tree's leaves are trained whole).

Stored precision follows the reference's.  Its update multiplies the
gradients by a float32 clip scale (``grad_clip`` set, the default) and
AdamW divides by float32 bias corrections, so a bfloat16 parameter comes
out of its first update in float32.  For such a leaf the state holds a
float32 master copy and float32 moments; the update runs on the master
in the reference's op order (rounded as :data:`PLAIN` on the card, as
:data:`XLA_CPU` on the CPU), and the bfloat16 leaf the forward reads is
rewritten from it after each step.  (One difference stays: the
reference's forward runs in float32 from step 1 on, the port's in the
leaf's dtype, as K2 and the card's GEMMs take bfloat16.)  Other leaves
(float32, or bfloat16 under SGD/momentum without clipping, which the
reference keeps in bfloat16) are updated in place, with moments in
their dtype.

Memory, the point of the comparison: FO holds parameters, gradients,
the saved activations, the master copies and (AdamW) two moments,
against ZO's parameters and activations of one forward.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import torch

from repro_torch.core import zo
from repro_torch.models import lm

F32 = torch.float32
CHUNK = 1 << 24          # elements a leaf is updated at a time


class FOState(NamedTuple):
    leaves: List            # [(path, layer | None, tensor)], lm.grad_leaves
    master: List            # float32 master copy per leaf, or None
    mu: Optional[List]      # first moment / momentum buffer per leaf
    nu: Optional[List]      # second moment per leaf (adamw)
    count: int


@dataclasses.dataclass(frozen=True)
class FOConfig:
    optimizer: str = "adamw"     # sgd | momentum | adamw
    lr: float = 1e-5
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0


def init_state(params, cfg: FOConfig) -> FOState:
    """Make ``params`` trainable (``lm.grad_leaves`` for a model, every
    leaf of a PEFT dict tree) and allocate the master copies and the
    optimizer's moments."""
    if isinstance(params, lm.ParamNode):
        leaves = lm.grad_leaves(params)
    else:
        leaves = [(path, None, t.requires_grad_())
                  for path, t in zo.leaf_items(params)]
    # the reference's update makes a narrower float leaf float32 where a
    # clip scale or AdamW's bias corrections meet it
    promotes = cfg.grad_clip is not None or cfg.optimizer == "adamw"
    master = [t.detach().to(F32, copy=True)
              if promotes and t.dtype.itemsize < 4 else None
              for _, _, t in leaves]
    zeros = lambda: [torch.zeros_like(t if m is None else m,
                                      requires_grad=False)
                     for (_, _, t), m in zip(leaves, master)]
    mu = zeros() if cfg.optimizer in ("momentum", "adamw") else None
    nu = zeros() if cfg.optimizer == "adamw" else None
    return FOState(leaves, master, mu, nu, 0)


def _global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares) over every gradient, summed in float32."""
    tot = None
    for g in grads:
        s = torch.sum(torch.square(g.to(F32)))
        tot = s if tot is None else tot + s
    return torch.sqrt(tot)


def _f32(x) -> float:
    """A Python scalar rounded to float32, as a jnp weak scalar meets a
    float32 array."""
    return float(torch.tensor(x, dtype=F32))


class Arith(NamedTuple):
    """How the update's float32 arithmetic rounds."""
    fma: Callable           # (a, b, c) -> a * b + c
    adam_dir: Callable      # (m, v, bc1, bc2, eps) -> m^ / (sqrt(v^) + eps)
    first_wd_in_dtype: bool  # first update: decay rounded to the leaf dtype


def _fma64(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a*b + c with one rounding to float32, computed in float64, where
    the product of two float32 values is exact."""
    f64 = torch.float64
    a = a.to(f64) if isinstance(a, torch.Tensor) else a
    return (a * b.to(f64) + c.to(f64)).to(F32)


def _adam_dir_xla(m, v, bc1, bc2, eps):
    den = torch.sqrt((v / bc2).double()).to(F32)   # correctly rounded
    return m / (bc1 * (den + eps))


# The reference's source order, each operation rounded: what the card runs.
PLAIN = Arith(lambda a, b, c: a * b + c,
              lambda m, v, bc1, bc2, eps: (m / bc1) / (torch.sqrt(v / bc2)
                                                       + eps),
              False)
# What the reference's jitted update computes on XLA's CPU backend: its
# multiply-adds contracted into FMAs, ``(m / bc1) / (sqrt(v / bc2) +
# eps)`` rewritten as ``m / (bc1 * (...))``, sqrt correctly rounded, and
# the decay, a weak scalar, rounded to bf16 against a bf16 parameter.
# CPU tensors take it, so the port's update equals the reference's there
# to the float32 ulp.
XLA_CPU = Arith(_fma64, _adam_dir_xla, True)


@torch.no_grad()
def apply_update(state: FOState, grads, cfg: FOConfig, lr,
                 arith: Optional[Arith] = None) -> FOState:
    """One optimizer step in place, in the reference's op order: clip,
    then SGD / momentum / AdamW in float32, on each leaf's master copy
    (then rounded into the leaf) or on the leaf itself.  ``arith``
    defaults to :data:`XLA_CPU` for CPU leaves, :data:`PLAIN` otherwise."""
    if arith is None:
        cpu = state.leaves and state.leaves[0][2].device.type == "cpu"
        arith = XLA_CPU if cpu else PLAIN
    fma = arith.fma
    scale = None
    if cfg.grad_clip is not None:
        gn = _global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    count = state.count + 1
    lr32, b1, b2, eps = (_f32(x) for x in (lr, cfg.beta1, cfg.beta2,
                                            cfg.eps))
    c1, c2 = _f32(1 - cfg.beta1), _f32(1 - cfg.beta2)
    if cfg.optimizer == "adamw":
        t = torch.tensor(float(count), dtype=F32)
        bc1 = 1.0 - torch.pow(torch.tensor(cfg.beta1, dtype=F32), t)
        bc2 = 1.0 - torch.pow(torch.tensor(cfg.beta2, dtype=F32), t)
    for i, ((_, _, leaf), grad) in enumerate(zip(state.leaves, grads)):
        master = state.master[i]
        wd = _f32(float(torch.tensor(cfg.weight_decay, dtype=leaf.dtype))
                  if arith.first_wd_in_dtype and master is not None
                  and state.count == 0 else cfg.weight_decay)
        flat = [None if t is None else t.detach().view(-1) for t in (
            leaf, grad, master, state.mu and state.mu[i],
            state.nu and state.nu[i])]
        for a in range(0, leaf.numel(), CHUNK):   # bounds the temporaries
            p, g, mst, mu, nu = (None if t is None else t[a:a + CHUNK]
                                 for t in flat)
            g = g.to(F32) if scale is None else g.to(F32) * scale
            pf = p.to(F32) if mst is None else mst
            if cfg.optimizer == "sgd":
                step = fma(wd, pf, g)                    # g + wd * p
            elif cfg.optimizer == "momentum":
                m = fma(b1, mu.to(F32), g)
                mu.copy_(m)
                step = fma(wd, pf, m)
            else:
                m = fma(b1, mu.to(F32), c1 * g)
                v = fma(b2, nu.to(F32), (c2 * g) * g)
                mu.copy_(m)
                nu.copy_(v)
                d = arith.adam_dir(m, v, bc1.to(g.device), bc2.to(g.device),
                                   eps)
                step = fma(wd, pf, d)
            new = fma(-lr32, step, pf)                   # p - lr * step
            if mst is not None:
                mst.copy_(new)
            p.copy_(new)
    return state._replace(count=count)


def make_fo_step(loss_fn: Callable, cfg: FOConfig,
                 lr_schedule: Optional[Callable] = None):
    """``step(params, state, batch, step_idx) -> (params, state,
    metrics)``; ``loss_fn(params, batch)`` must record the graph."""
    sched = lr_schedule or (lambda t: cfg.lr)

    def step(params, state: FOState, batch, step_idx: int):
        loss = loss_fn(params, batch)
        loss.backward()
        leaves = [t for _, _, t in state.leaves]
        grads = [t.grad if t.grad is not None else torch.zeros_like(t)
                 for t in leaves]
        lr = sched(step_idx)
        state = apply_update(state, grads, cfg, lr)
        for t in leaves:
            t.grad = None
        return params, state, {"loss": loss.detach(), "lr": lr}

    return step
