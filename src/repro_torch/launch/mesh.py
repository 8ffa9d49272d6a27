"""Meshes and the card's roofline constants (port of
``repro/launch/mesh.py``).

``HW`` is the roofline table of one NVIDIA H100 SXM5 80GB at its 700 W
limit, from NVIDIA's data sheet: dense bf16 989e12 FLOP/s, HBM3
3.35e12 B/s, 80 GB, NVLink 450e9 B/s each way.  It is the one table of
these rates in the port: ``bench/case_studies.HW_GENS`` reads its H100
row from here.  A card set below 700 W runs slower under load.

:func:`make_production_mesh` is the reference's production mesh, shape
for shape and axis for axis:

  single-pod : (16, 16)      axes ("data", "model")
  multi-pod  : (2, 16, 16)   axes ("pod", "data", "model")

as a ``DeviceMesh`` over the world of the running process group, which
must have 256 (512) ranks: the dry run makes it over a fake group
(:func:`repro_torch.distributed.launch.fake_world`), so rank 0's shards,
and so each record, are the reference's cell for cell.  256 GPUs are 32
hosts of eight: the mesh crosses nodes, whose links (InfiniBand, tens
of GB/s a card) are slower than NVLink, so the collective term at
``ici_bandwidth`` is a lower bound, not a prediction.

:func:`make_host_mesh` is the reference's mesh over the devices at hand:
here the ranks of the initialised group.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

#: NVIDIA H100 SXM5 80GB at 700 W, data sheet: the roofline's rates
#: (the reference's keys; ``ici_bandwidth`` is NVLink's, each way)
HW = {
    "peak_bf16_flops": 989e12,     # FLOP/s, dense
    "hbm_bandwidth": 3.35e12,      # B/s
    "ici_bandwidth": 450e9,        # B/s
    "hbm_bytes": 80e9,
}

#: the reference's production meshes: multi_pod -> (shape, axis names)
PRODUCTION: dict = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_mesh(shape: Sequence[int], names: Sequence[str], *,
              device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` with axis ``names`` over every rank of
    the initialised process group, on ``device``'s type (``None``:
    CUDA).  Building it is collective: every rank calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                         f"group has {world}")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(world).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def production_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...],
                                                        Tuple[str, ...]]:
    """(shape, axis names) of the reference's production mesh."""
    return PRODUCTION[bool(multi_pod)]


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """The reference's (16, 16) or (2, 16, 16) mesh over the running
    group's 256 or 512 ranks."""
    shape, names = production_shape(multi_pod)
    return make_mesh(shape, names, device=device)


def make_host_mesh(model_axis: int = 1, *, device: DeviceLike = None):
    """A ``(world // model_axis, model_axis)`` ``("data", "model")``
    ``DeviceMesh`` over the ranks of the initialised process group, on
    ``device``'s type (``None``: CUDA); ``None`` with no process group:
    one device, which shards nothing (the reference's mesh over its one
    device).  Building it is collective: every rank calls it."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    world = dist.get_world_size()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"{world} ranks")
    return make_mesh((world // model_axis, model_axis), ("data", "model"),
                     device=device)
