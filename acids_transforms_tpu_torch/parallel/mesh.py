"""Device-mesh helpers (twin of the JAX ``parallel/mesh.py``).

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group: one process a device, as ``torchrun`` starts
them.  The group is the caller's (``torchrun``, or an explicit
``torch.distributed.init_process_group``); these helpers never start one.
``device_type=None`` means ``"cuda"`` (NCCL) and raises without a card;
``"cpu"`` gives a gloo mesh.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch.distributed as dist

from .._device import resolve_device

__all__ = ["make_mesh", "local_mesh"]


def _world_size() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a device mesh needs the default process group: start the program "
            "under torchrun, or call torch.distributed.init_process_group(...) "
            "before building the mesh"
        )
    return dist.get_world_size()


def make_mesh(shape: Optional[Dict[str, int]] = None, device_type: Optional[str] = None):
    """Build a named mesh over the process group's ranks.

    ``shape`` maps axis names to sizes, e.g. ``{"data": 4, "seq": 2}``; by
    default all ranks go on one ``"data"`` axis.  Axis order follows dict
    order (outer to inner), so neighbouring ``seq`` shards are consecutive
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = resolve_device(device_type).type
    world = _world_size()
    if shape is None:
        shape = {"data": world}
    sizes = tuple(int(v) for v in shape.values())
    if math.prod(sizes) != world:
        raise ValueError("mesh shape %r does not cover %d devices" % (shape, world))
    return init_device_mesh(device_type, sizes, mesh_dim_names=tuple(shape.keys()))


def local_mesh(n: Optional[int] = None, axis: str = "data", device_type: Optional[str] = None):
    """1-D mesh over ``n`` ranks (all of the process group's by default)."""
    n = _world_size() if n is None else int(n)
    return make_mesh({axis: n}, device_type)
