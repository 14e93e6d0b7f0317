"""Production mesh construction (counterpart of ``repro/launch/mesh.py``).

Single pod: 16x16 = 256 cards, axes (data, model).
Multi-pod:  2x16x16 = 512 cards, axes (pod, data, model): the ``pod``
axis carries pure data parallelism, which for ZO fine-tuning costs one
scalar all-reduce a forward (DESIGN.md §3).

Both build a ``DeviceMesh`` over the default process group, which the
caller initialises first: NCCL over real cards, gloo for CPU ranks, or
the ``fake`` backend of the dry run, where one process stands for every
rank.  Functions, never module-level constants, so that importing this
module touches no device state.
"""
from __future__ import annotations


def _device_type() -> str:
    """The card's for NCCL and for the dry run's fake group (which moves
    no data, so no card is touched), the CPU's for gloo."""
    import torch.distributed as dist
    return "cpu" if dist.get_backend() == "gloo" else "cuda"


def make_mesh(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(model_parallel: int = 1):
    """(world // model_parallel, model_parallel) over every rank of the
    default group (tests / CPU runs / the one card)."""
    import torch.distributed as dist
    n = dist.get_world_size()
    assert n % model_parallel == 0
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"))
