"""The host's mesh (port of ``repro/launch/mesh.py``'s
``make_host_mesh``).

The reference's ``HW`` table (TPU v5e constants) and its 256-chip
``make_production_mesh`` are not the port's: they wait for the dry run
(ROADMAP queue 1 item 5c).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device


def make_host_mesh(model_axis: int = 1, *, device: DeviceLike = None):
    """A ``(world // model_axis, model_axis)`` ``("data", "model")``
    ``DeviceMesh`` over the ranks of the initialised process group, on
    ``device``'s type (``None``: CUDA); ``None`` with no process group:
    one device, which shards nothing (the reference's mesh over its one
    device).  Building it is collective: every rank calls it."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"{world} ranks")
    shape = (world // model_axis, model_axis)
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(world).reshape(shape),
                      mesh_dim_names=("data", "model"))

