"""Virtual-perturbation fused forward of the port (counterpart of
``repro/fused``).

With a counter-based RNG the perturbed weights ``theta + s*eps*z`` need
never exist in memory: the forward makes z inside its matmul tiles
(kernels K3/K4, ``fused/matmul.py``) and a two-point step becomes one
paired forward plus one update axpy, with no perturb or restore writes.

Select it with ``forward_backend="virtual"`` (the kernels) or
``"virtual_ref"`` (the plain versions).  A ctx carries one probe
(``make_ctx``), the ±εz pair (``make_pair_ctx``) or P independent probes
(``make_stack_ctx``, one_sided's q-chunks).
"""
from __future__ import annotations

from repro_torch.estimators.costs import FORWARD_BACKENDS
from repro_torch.fused import ref
from repro_torch.fused.matmul import pmatmul, pmatmul_stack
from repro_torch.fused.view import LayerPerturb, PerturbCtx, ProbePair

__all__ = ["FORWARD_BACKENDS", "LayerPerturb", "PerturbCtx",
           "ProbePair", "make_ctx", "make_pair_ctx", "make_stack_ctx",
           "pmatmul", "pmatmul_stack", "ref"]


def _impl_of(forward_backend: str) -> str:
    if forward_backend not in FORWARD_BACKENDS[1:]:
        raise ValueError(
            f"not a virtual forward backend: {forward_backend!r}; "
            f"pick from {FORWARD_BACKENDS[1:]}")
    return "ref" if forward_backend == "virtual_ref" else "pallas"


def make_ctx(seed: int, scale: float, masks,
             forward_backend: str) -> PerturbCtx:
    """The perturbation lens for one probe of ``forward_backend``."""
    return PerturbCtx(seed=seed, scale=scale, masks=masks,
                      impl=_impl_of(forward_backend))


def make_pair_ctx(seed: int, eps: float, masks,
                  forward_backend: str) -> PerturbCtx:
    """The antithetic ±εz pair as ONE stacked ctx: probe 0 is +eps,
    probe 1 is -eps, both drawing the same z.  ``lm_loss`` under it
    returns ``[l_plus, l_minus]``."""
    sm = (None if masks is None else
          {g: m[None].expand(2, *m.shape) for g, m in masks.items()})
    return PerturbCtx(seed=(seed, seed), scale=(eps, -eps), masks=sm,
                      impl=_impl_of(forward_backend), pair=ProbePair(n=2))


def make_stack_ctx(seeds, scale: float, masks,
                   forward_backend: str) -> PerturbCtx:
    """P independent probes of one scale stacked on one forward:
    ``seeds`` length P, ``masks`` group -> (P, L_g).  Each probe keeps
    its own z stream; ``lm_loss`` returns a (P,) loss vector."""
    seeds = tuple(int(s) for s in seeds)
    return PerturbCtx(seed=seeds, scale=(float(scale),) * len(seeds),
                      masks=masks, impl=_impl_of(forward_backend),
                      pair=ProbePair(n=len(seeds)))
