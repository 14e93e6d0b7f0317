"""Per-device cost counter for the roofline (counterpart of
``repro/launch/analysis.py``, whose HLO walk it replaces).

:class:`CostCounter` is a ``TorchDispatchMode`` that runs a program (the
dry run's step over meta-tensor shards) and counts, with the
reference's accounting rules:

  * flops: a dot (``mm``, ``bmm``, ``addmm``, ``baddbmm``, which
    ``matmul`` and ``einsum`` lower to) = 2 * numel(result) *
    prod(contracting dims); an elementwise op (``Tag.pointwise``, dtype
    conversions) = numel(result); a reduction = numel(operand).
  * bytes: each op's tensor operands plus its result; view ops move
    nothing; gathers and scatters move twice the slice they move
    (slice-proportional, as the reference's dynamic-slice rule).
  * collectives by kind, all-reduce at 2x its size, others at result
    size, and by the mesh axis they run over.
  * kernels: a kernel wrapper that takes its plain version off the card
    wraps it in ``kernels/_build.py::plain_region``: the counter then
    adds the kernel's own flops and bytes once (the card runs one
    launch, as the reference's HLO holds one custom call) and ignores
    the plain version's ops.
  * memory: the peak of live allocations over the program (the storages
    its ops make: an output on an input's storage is a view or an alias;
    its arguments excluded), a region's allocations counted only where
    they outlive it.

Only ops on ``device_type`` (``meta`` in the dry run) count: the host's
selection work on CPU tensors is not the card's.

Per device, never global.  Under DTensor every op reaches a dispatch
mode twice: first with DTensor arguments at the global shape, then, from
inside DTensor's dispatch, as the local op on each rank's shard.  The
counter returns ``NotImplemented`` on the first (so DTensor runs the op)
and counts only the second: the local program, once, as the reference's
post-partitioning HLO is.  Eager PyTorch runs the layer loop in Python,
so each layer's ops are seen once a layer and no loop multiplier is
needed.  ``.item()`` on a counted tensor returns 0 (a meta tensor holds
no value; the step's host arithmetic only needs a number).
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

_DOTS = {aten.mm.default: 0, aten.bmm.default: 0, aten.addmm.default: 1,
         aten.baddbmm.default: 1}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "var", "std", "argmax", "argmin", "_softmax",
               "_log_softmax", "cumsum", "linalg_vector_norm", "norm", "any",
               "all", "var_mean", "std_mean"}
_GATHERS = {"index", "index_select", "gather", "embedding", "take",
            "take_along_dim"}
_SCATTERS = {"index_put", "index_put_", "index_copy", "index_copy_",
             "scatter", "scatter_", "scatter_add", "scatter_add_",
             "index_add", "index_add_", "_index_put_impl_"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "detach",
         "alias", "lift_fresh", "_local_scalar_dense", "wait_tensor", "set_",
         "resize_", "_unsafe_view", "_wrap_tensor_autograd"}
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "reduce_scatter_tensor":
    "reduce-scatter", "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts the per-device cost of the ops run under it (see the
    module docstring).  ``mesh`` names the axes collectives run over."""

    def __init__(self, device_type: str = "meta", mesh=None):
        super().__init__()
        self.device_type = device_type
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, float] = {}
        self.coll_axes: Dict[str, float] = {}
        self.detail: Dict[str, float] = {}
        self.kernels: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._region: Optional[list] = None
        self._groups = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._groups[mesh.get_group(i).group_name] = name

    # ------------------------------------------------------------ regions
    @contextlib.contextmanager
    def kernel(self, name: str, flops: float, nbytes: float):
        """One launch of kernel ``name``: its flops and bytes once; the
        ops inside (its plain version) are not counted."""
        if self._region is not None:
            yield
            return
        self.flops += flops
        self.bytes += nbytes
        self.kernels[name] = self.kernels.get(name, 0) + 1
        self._region = []
        try:
            yield
        finally:
            made, self._region = self._region, None
            for ref, n in made:
                t = ref()
                if t is not None:
                    self._alloc(t, n)

    def __enter__(self):
        from repro_torch.kernels import _build
        self._prev_region = _build.COST_REGION
        _build.COST_REGION = self.kernel
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import _build
        _build.COST_REGION = self._prev_region
        return super().__exit__(*exc)

    # ------------------------------------------------------------- memory
    def _free(self, n: int):
        self.live -= n

    def _alloc(self, t: torch.Tensor, n: int):
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _track(self, outs, args):
        # an output on an input's storage (a view, an alias, an in-place
        # result) allocates nothing
        seen = {a.untyped_storage()._cdata for a in args}
        for t in outs:
            key = t.untyped_storage()._cdata
            if key in seen:
                continue
            seen.add(key)
            n = _nbytes(t)
            if self._region is not None:
                self._region.append((weakref.ref(t), n))
            else:
                self._alloc(t, n)

    # ------------------------------------------------------------ counting
    def _count(self, func, args, kwargs, outs):
        name = func.overloadpacket.__name__
        ins = _tensors((args, kwargs))
        res = sum(_nbytes(t) for t in outs)
        opb = sum(_nbytes(t) for t in ins)
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            wire = res * (2.0 if kind == "all-reduce" else 1.0)
            axis = self._groups.get(args[-1], "?")
            self.coll[kind] = self.coll.get(kind, 0.0) + wire
            self.coll_axes[axis] = self.coll_axes.get(axis, 0.0) + wire
            key = f"{kind} {axis} {tuple(outs[0].shape) if outs else ()}"
            self.detail[key] = self.detail.get(key, 0.0) + wire
            self.bytes += res + opb
            return
        if func.is_view or name in _FREE:
            return
        if func in _DOTS:
            a = args[_DOTS[func]]
            self.flops += 2.0 * outs[0].numel() * a.shape[-1]
        elif torch.Tag.pointwise in func.tags or (
                name == "_to_copy" and ins and outs
                and outs[0].dtype != ins[0].dtype):
            self.flops += sum(t.numel() for t in outs)
        elif torch.Tag.reduction in func.tags or name in _REDUCTIONS:
            self.flops += ins[0].numel() if ins else 0
        if name in _GATHERS:
            self.bytes += 2.0 * res
        elif name in _SCATTERS:
            src = ins[-1] if ins else None
            self.bytes += 2.0 * (_nbytes(src) if src is not None else res)
        else:
            self.bytes += res + opb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # count the local op instead
        ins = _tensors((args, kwargs))
        ours = any(t.device.type == self.device_type for t in ins)
        if func is aten._local_scalar_dense.default and ours:
            a = ins[0]
            return (False if a.dtype == torch.bool else
                    0.0 if a.is_floating_point() else 0)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not (ours or any(t.device.type == self.device_type
                            for t in outs)):
            return out
        if self._region is None:
            self._count(func, args, kwargs, outs)
        self._track(outs, ins)
        return out

    def totals(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": dict(self.coll),
                "collective_axes": dict(self.coll_axes),
                "kernels": dict(self.kernels), "temp_bytes": self.peak}


def analyze(fn, *args, device_type: str = "meta", mesh=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter`; return
    (its result, the counter)."""
    counter = CostCounter(device_type, mesh)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter


# --------------------------------------------------- estimator cost model
_HBM_BW_DEFAULT = 3.35e12  # H100 SXM bytes/s — matches launch/dryrun.py


def estimator_step_cost(terms: Dict, name: str, q: int = 1,
                        param_bytes: Optional[float] = None,
                        fused_update: bool = True,
                        hbm_bw: float = _HBM_BW_DEFAULT,
                        forward_backend: str = "materialized") -> Dict:
    """Project the lowered step's roofline terms onto another ZO
    estimator (the reference's function; only the default bandwidth is
    the card's).

    The step the dry run lowers is a fused two-point step
    (``costs.BASELINE``: 2 forwards + 3 axpy sweeps).  Other estimators
    change only the counts of those two primitives: forward-scaling
    work (flops, activation traffic, per-layer collectives) scales with
    the forward count; with ``param_bytes`` (per device) each sweep is
    re-priced as ~2x the parameter bytes through HBM.  A virtual forward
    backend removes the probe sweeps from the counts.
    """
    from repro_torch.estimators import costs

    base = costs.step_counts(costs.BASELINE, fused_update=True)
    est = costs.step_counts(name, q=q, fused_update=fused_update,
                            forward_backend=forward_backend)
    f = est["forwards"] / base["forwards"]
    out = {"estimator": name, "q": q, "forwards": est["forwards"],
           "axpy_sweeps": est["axpy_sweeps"],
           "forward_backend": forward_backend}
    out["compute_s"] = terms["compute_s"] * f
    out["collective_s"] = terms["collective_s"] * f
    if param_bytes:
        sweep_s = 2.0 * param_bytes / hbm_bw
        fwd_mem = max(0.0, terms["memory_s"] - base["axpy_sweeps"] * sweep_s)
        out["memory_s"] = fwd_mem * f + est["axpy_sweeps"] * sweep_s
    else:
        out["memory_s"] = terms["memory_s"] * f
    return out
