"""Parameter metadata trees (port of ``repro/models/params.py``).

A model is declared as a nested dict of :class:`ParamMeta` leaves (shape,
``torch.dtype``, logical axes, init scheme).  The meta tree is the single
source of truth for

* abstract params (meta-device tensors: shape and dtype, no memory;
  DTensors of their local shape when sharded),
* materialisation (:func:`init_params`, from an explicit
  ``torch.Generator``), and
* analytic parameter counts.

Trees are nested dicts.  :func:`tree_map` visits keys in sorted order, as
JAX flattens a dict, so :func:`init_params` draws its leaves in the
reference's order and every tree it returns lists its keys sorted.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


class ParamMeta(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype
    axes: Tuple[Optional[str], ...]   # logical axis per dim
    init: str = "normal"              # normal | zeros | ones | embed | scaled
    fan_in: int = 0                   # for "scaled": stddev = 1/sqrt(fan_in)

    def scaled_std(self) -> float:
        if self.init == "embed":
            return 0.02  # GPT-2-style embedding init (sane tied-logit scale)
        fi = self.fan_in or (self.shape[-2] if len(self.shape) >= 2 else self.shape[-1])
        return 1.0 / math.sqrt(max(fi, 1))


def is_meta(x) -> bool:
    return isinstance(x, ParamMeta)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (keys in sorted order), with
    the leaves at the same keys of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of nested dicts, keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def meta(shape: Sequence[int], axes: Sequence[Optional[str]],
         init: str = "scaled", dtype: torch.dtype = torch.float32,
         fan_in: int = 0) -> ParamMeta:
    return ParamMeta(tuple(int(s) for s in shape), dtype, tuple(axes), init, fan_in)


def stack_metas(m: ParamMeta, n: int, axis_name: str = "layers") -> ParamMeta:
    """Add a leading stacked-layers dim (one slice a layer of a segment)."""
    return ParamMeta((n,) + m.shape, m.dtype, (axis_name,) + m.axes, m.init, m.fan_in)


def stack_tree(tree, n: int, axis_name: str = "layers"):
    return tree_map(lambda m: stack_metas(m, n, axis_name), tree)


def abstract_params(meta_tree, shardings=None):
    """Meta tree -> tree of meta-device tensors (shape and dtype only; no
    memory is allocated).  With ``shardings`` (the same tree, a
    :class:`~repro_torch.distributed.sharding.Sharding` or ``None`` a
    leaf, as ``sharding_for_meta`` gives it) a sharded leaf is a DTensor
    with those placements over the mesh, holding this rank's local
    shape."""
    def whole(m: ParamMeta) -> torch.Tensor:
        return torch.empty(m.shape, dtype=m.dtype, device="meta")

    if shardings is None:
        return tree_map(whole, meta_tree)
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import local_slice
    from repro_torch.distributed.spmd import contiguous_strides

    def one(m: ParamMeta, sh) -> torch.Tensor:
        if sh is None:
            return whole(m)
        mesh, placements = sh
        local = local_slice(torch.empty(m.shape, device="meta"), mesh,
                            placements).shape
        x = torch.empty(local, dtype=m.dtype, device="meta")
        return DTensor.from_local(x, mesh, placements, run_check=False,
                                  shape=torch.Size(m.shape),
                                  stride=contiguous_strides(m.shape))

    return tree_map(one, meta_tree, shardings)


def count_params(meta_tree) -> int:
    return sum(math.prod(m.shape) for m in tree_leaves(meta_tree))


def init_params(meta_tree, *, generator: torch.Generator,
                device: DeviceLike = None):
    """Materialise a meta tree on ``device`` (``None`` is CUDA), drawing
    from ``generator``, which must live on that device.  The reference's
    init kinds and standard deviations: ``zeros``, ``ones``, ``embed``
    (0.02), ``scaled`` (``1/sqrt(fan_in)``), ``normal`` (0.02); normal
    draws are made in f32 and cast to the leaf's dtype."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")

    def one(m: ParamMeta) -> torch.Tensor:
        if m.init == "zeros":
            return torch.zeros(m.shape, dtype=m.dtype, device=dev)
        if m.init == "ones":
            return torch.ones(m.shape, dtype=m.dtype, device=dev)
        std = m.scaled_std() if m.init in ("scaled", "embed") else 0.02
        x = torch.empty(m.shape, dtype=torch.float32, device=dev)
        x.normal_(0.0, std, generator=generator)
        return x if m.dtype == torch.float32 else x.to(m.dtype)

    return tree_map(one, meta_tree)
