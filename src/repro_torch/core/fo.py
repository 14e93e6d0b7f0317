"""First-order baselines, the paper's "FT" rows: SGD, momentum and AdamW
with global-norm clipping (counterpart of ``repro/core/fo.py``).

The gradient comes from autograd through the model (``lm_loss(...,
grad=True)``; attention through kernel K2's ``torch.autograd.Function``).
The trainable leaves are :func:`models.lm.grad_leaves`: every stacked
leaf split into per-layer views, so each layer's gradient is a tensor of
its own.  The moments are kept in the parameters' dtype (as
``jnp.zeros_like`` makes them), one per leaf; the update runs in float32
and is rounded back into the parameter's storage in place.

Memory, the point of the comparison: FO holds parameters, gradients,
the saved activations and (AdamW) two moments, against ZO's parameters
and activations of one forward.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional

import torch

from repro_torch.models import lm

F32 = torch.float32


class FOState(NamedTuple):
    leaves: List            # [(path, layer | None, tensor)], lm.grad_leaves
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
    """Make ``params`` trainable (``lm.grad_leaves``) and allocate the
    optimizer's moments."""
    leaves = lm.grad_leaves(params)
    zeros = lambda: [torch.zeros_like(t, requires_grad=False)
                     for _, _, t in leaves]
    mu = zeros() if cfg.optimizer in ("momentum", "adamw") else None
    nu = zeros() if cfg.optimizer == "adamw" else None
    return FOState(leaves, mu, nu, 0)


def _global_norm(grads) -> torch.Tensor:
    """sqrt(sum of squares) over every gradient, summed in float32."""
    tot = None
    for g in grads:
        s = torch.sum(torch.square(g.to(F32)))
        tot = s if tot is None else tot + s
    return torch.sqrt(tot)


@torch.no_grad()
def apply_update(state: FOState, grads, cfg: FOConfig, lr) -> FOState:
    """One optimizer step on ``state.leaves`` in place, in the
    reference's op order: clip, then SGD / momentum / AdamW."""
    scale = None
    if cfg.grad_clip is not None:
        gn = _global_norm(grads)
        scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    count = state.count + 1
    wd = cfg.weight_decay
    if cfg.optimizer == "adamw":
        t = torch.tensor(float(count), dtype=F32)
        bc1 = 1.0 - torch.pow(torch.tensor(cfg.beta1, dtype=F32), t)
        bc2 = 1.0 - torch.pow(torch.tensor(cfg.beta2, dtype=F32), t)
    for i, ((_, _, p), g) in enumerate(zip(state.leaves, grads)):
        g = g.to(F32) if scale is None else g.to(F32) * scale
        pf = p.to(F32)
        if cfg.optimizer == "sgd":
            step = g + wd * pf
        elif cfg.optimizer == "momentum":
            m = cfg.beta1 * state.mu[i].to(F32) + g
            state.mu[i].copy_(m)
            step = m + wd * pf
        else:
            m = cfg.beta1 * state.mu[i].to(F32) + (1 - cfg.beta1) * g
            v = cfg.beta2 * state.nu[i].to(F32) + (1 - cfg.beta2) * g * g
            state.mu[i].copy_(m)
            state.nu[i].copy_(v)
            step = ((m / bc1.to(g.device))
                    / (torch.sqrt(v / bc2.to(g.device)) + cfg.eps)
                    + wd * pf)
        p.copy_(pf - lr * step)
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
