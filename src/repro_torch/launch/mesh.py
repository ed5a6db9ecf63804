"""Production mesh construction (the reference's ``repro.launch.mesh``),
on ``torch.distributed.device_mesh.init_device_mesh``.

A mesh needs the default process group, one rank per mesh position:
``init_process_group`` first, with its address, world size and rank (on
the CPU, the ``fake`` backend gives any world size in one process --
``init_process_group("fake", rank=0, world_size=256, store=FakeStore())``
from ``torch.testing._internal.distributed.fake_pg`` -- which is all the
sharding rules need, as they read only a mesh's axis names and shape).
Without a process group, or with a world that the mesh does not fill
exactly, these functions raise.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.sharding.logical import mesh_axis_sizes

__all__ = ["make_production_mesh", "make_cpu_mesh", "mesh_axis_sizes"]


def _make_mesh(shape, axes, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs the default process "
            f"group: call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 = 256 ranks per pod; 2 pods = 512 ranks.

    Axes: (pod,) data, model.  ``pod`` is an outer data-parallel axis whose
    collectives cross pods; ``data`` is in-pod data parallelism; ``model``
    is tensor parallelism over the fastest links.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_cpu_mesh(data: int = 1, model: int = 1, device_type: str = "cpu"):
    """A small ``(data, model)`` mesh over the process group's ranks."""
    return _make_mesh((data, model), ("data", "model"), device_type)
