"""Logical-axis sharding rules (port of the rule table of
``repro/distributed/sharding.py``).

Every parameter and annotated activation carries *logical* axis names
(``"batch"``, ``"heads"``, ``"mlp"``, ...); a rule table maps each to mesh
axis names.  Mesh axes missing from a mesh are dropped, so one table
serves a 1-D ``("data",)`` mesh and a 2-D ``("data", "model")`` one.

A mesh is read only through its axis names and per-axis sizes
(:func:`mesh_axes`): a ``torch.distributed.device_mesh.DeviceMesh``
(``mesh_dim_names``, ``size(i)``) or any stand-in with ``axis_names``
and a ``shape`` mapping, such as :class:`MeshShape`.

The active-mesh plumbing (:func:`use_mesh`, :func:`current_mesh`,
:func:`active_rules`) is thread-local, as in the reference.
:func:`resolve_spec` maps logical axes to DTensor placements (one per
mesh dim), dropping a dim the mesh axes do not divide into the
:func:`dropped_shardings` registry; :func:`shard` places a tensor by
logical axes.  A plain tensor holds the whole value on every rank, so
:func:`shard` takes each rank's own slice (``DTensor.from_local``): the
placement moves no data and adds no collective, as a sharding
constraint on generated data adds none in the reference.

Inside :func:`use_mesh` with a mesh, plain tensors that meet a DTensor
count as replicated (``implicit_replication``), and every functional
collective runs as gloo can (:class:`GlooCollectives`): through host
memory, and an unsigned dtype as its signed view of the same bits.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import (Any, Dict, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch
from torch.utils._python_dispatch import TorchDispatchMode

AxisVal = Union[None, str, Tuple[str, ...]]

# ---------------------------------------------------------------------------
# Default rule table (merged with per-config overrides)
# ---------------------------------------------------------------------------

DEFAULT_RULES: Dict[str, AxisVal] = {
    # data axes -----------------------------------------------------------
    "batch": ("pod", "data"),
    # proxy motif inputs: the non-batch dim of a motif input leaf shards
    # over the model axis on 2-D meshes; absent from 1-D ("data",) meshes
    "motif_width": "model",
    "seq": None,
    "kv_seq": "model",        # decode-time KV caches: shard the length
    "frames": None,
    # width axes ----------------------------------------------------------
    "embed": None,             # activation d_model stays replicated
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qk_dim": None,
    "mlp": "model",
    "expert": "model",         # expert parallelism
    "expert_mlp": None,
    "kv_lora": None,
    "q_lora": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "lru_width": "model",
    "conv": None,
    "layers": None,
    "pos": None,
    # optimizer-state extra sharding (ZeRO-1): applied to moments only
    "zero": ("pod", "data"),
}


@dataclass(frozen=True)
class MeshShape:
    """A mesh as the rule arithmetic sees it: ordered axis names and
    their sizes, no devices.  ``MeshShape(("data", "model"), (2, 2))``."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.names, self.sizes))


def mesh_axes(mesh) -> Tuple[Tuple[str, int], ...]:
    """``((axis name, size), ...)`` of ``mesh`` in axis order: a
    ``DeviceMesh`` through ``mesh_dim_names`` and ``size(i)``, anything
    else through ``axis_names`` and ``shape[name]``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple((str(a), int(mesh.size(i))) for i, a in enumerate(names))
    return tuple((str(a), int(mesh.shape[a])) for a in mesh.axis_names)


@dataclass(frozen=True)
class ShardingRules:
    table: Mapping[str, AxisVal] = field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def with_overrides(self, overrides: Mapping[str, AxisVal]
                       ) -> "ShardingRules":
        t = dict(self.table)
        t.update(overrides)
        return ShardingRules(t)

    def mesh_axes_for(self, logical: Optional[str], mesh) -> Tuple[str, ...]:
        if logical is None:
            return ()
        v = self.table.get(logical, None)
        if v is None:
            return ()
        if isinstance(v, str):
            v = (v,)
        present = {a for a, _ in mesh_axes(mesh)}
        return tuple(a for a in v if a in present)

    def structural_key(self) -> Tuple:
        """A hashable fingerprint of the rule table, for cache keys: two
        rule tables with equal keys resolve every logical axis to the
        same mesh axes, so they partition any program identically."""
        def norm(v: AxisVal) -> Tuple:
            if v is None:
                return ()
            return (v,) if isinstance(v, str) else tuple(v)
        return tuple(sorted((k, norm(v)) for k, v in self.table.items()))


# ---------------------------------------------------------------------------
# Active-context plumbing
# ---------------------------------------------------------------------------

_state = threading.local()


def current_mesh():
    return getattr(_state, "mesh", None)


def active_rules() -> ShardingRules:
    return getattr(_state, "rules", None) or ShardingRules()


#: unsigned dtype -> the signed dtype of the same width a collective runs on
_SIGNED = {torch.uint32: torch.int32, torch.uint16: torch.int16,
           torch.uint64: torch.int64}


class GlooCollectives(TorchDispatchMode):
    """Run each functional collective the way gloo can:

    * on host memory: gloo stages a CUDA tensor through the host anyway,
      and on torch 2.11 waiting on a functional collective over a CUDA
      tensor crashes the process, so a CUDA operand is copied to the
      host, the collective runs and is waited on there, and the result
      goes back to the card (a ``wait_tensor`` on it is then a no-op);
    * on signed types: gloo has no unsigned ones, so an unsigned operand
      travels as its signed view (the same bits: a gather, a broadcast or
      a wrapping sum is exact), a min or max all-reduce on its values
      widened to int64.

    A mode inside this one (the signature's profiler) sees the collective
    as the program issued it: its kind, dtype and bytes."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented  # its local ops and collectives come back
        kwargs = kwargs or {}
        if func.namespace != "_c10d_functional":
            return func(*args, **kwargs)
        x = args[0]
        if func.overloadpacket.__name__ == "wait_tensor":
            # every collective on a CUDA or unsigned tensor was waited on
            # here when it was issued
            if x.is_cuda or x.dtype in _SIGNED:
                return x
            return func(*args, **kwargs)
        if not (x.is_cuda or x.dtype in _SIGNED):
            return func(*args, **kwargs)
        name = func.overloadpacket.__name__
        wire = x.cpu()
        if x.dtype in _SIGNED:
            ordered = (name.startswith("all_reduce")
                       and str(args[1]).lower() in ("min", "max"))
            wire = (wire.to(torch.int64) if ordered and x.dtype != torch.uint64
                    else wire.view(_SIGNED[x.dtype]))
        out = torch.ops._c10d_functional.wait_tensor(
            func(wire, *args[1:], **kwargs))
        out = (out.to(x.dtype) if out.dtype == torch.int64
               and x.dtype != torch.int64 else out.view(x.dtype))
        out = out.to(x.device)
        if name.endswith("_"):  # in place: the operand takes the result
            return x.copy_(out)
        return out


def whole(t: torch.Tensor) -> torch.Tensor:
    """A tensor's whole value, detached: a DTensor gathered (a collective
    over its mesh, on the host as gloo needs: :class:`GlooCollectives`),
    on the device it was on; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        with GlooCollectives():
            t = t.full_tensor()
    return t.detach()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[ShardingRules] = None):
    """Activate (mesh, rules) for :func:`shard` on this thread.  With a
    mesh, plain tensors meeting a DTensor count as replicated and
    collectives run as gloo can (:class:`GlooCollectives`)."""
    prev = (current_mesh(), getattr(_state, "rules", None))
    _state.mesh = mesh
    _state.rules = rules or ShardingRules()
    try:
        if mesh is not None:
            from torch.distributed.tensor.experimental import (
                implicit_replication)

            from repro_torch.distributed.spmd import register_rules

            register_rules()
            with implicit_replication(), GlooCollectives():
                yield
        else:
            yield
    finally:
        _state.mesh, _state.rules = prev


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------

_DROPPED: Dict[Tuple, int] = {}  # (logical, dim) -> count, for reporting


def resolve_entries(shape: Sequence[int],
                    logical_axes: Sequence[Optional[str]], mesh,
                    rules: ShardingRules) -> Tuple:
    """Logical axes -> the reference's PartitionSpec entries, one per
    tensor dim (``None``, a mesh axis name, or a tuple of them), dropping
    a dim the mapped mesh axes do not divide (then a prefix of them that
    divides, else replication, counted in :func:`dropped_shardings`)."""
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    sizes = dict(mesh_axes(mesh))
    used: set = set()
    spec = []
    for dim, logical in zip(shape, logical_axes):
        axes = rules.mesh_axes_for(logical, mesh)
        axes = tuple(a for a in axes if a not in used)
        if axes:
            total = 1
            for a in axes:
                total *= sizes[a]
            if dim % total != 0:
                # try a prefix of the axes that divides
                while axes:
                    axes = axes[:-1]
                    total = 1
                    for a in axes:
                        total *= sizes[a]
                    if axes and dim % total == 0:
                        break
                if not axes or dim % total != 0:
                    _DROPPED[(logical, dim)] = _DROPPED.get((logical, dim),
                                                            0) + 1
                    spec.append(None)
                    continue
        if not axes:
            spec.append(None)
            continue
        used.update(axes)
        spec.append(axes if len(axes) > 1 else axes[0])
    return tuple(spec)


def entries_to_placements(entries: Sequence, mesh) -> Tuple:
    """PartitionSpec entries -> DTensor placements, one per mesh dim: a
    mesh axis that shards tensor dim d is ``Shard(d)``, every other mesh
    axis ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for d, e in enumerate(entries):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a, _ in mesh_axes(mesh))


def resolve_spec(shape: Sequence[int],
                 logical_axes: Sequence[Optional[str]], mesh,
                 rules: ShardingRules) -> Tuple:
    """Logical axes -> DTensor placements (one per mesh dim), dropping
    indivisible dims as the reference does (:func:`resolve_entries`)."""
    return entries_to_placements(
        resolve_entries(shape, logical_axes, mesh, rules), mesh)


def named_sharding(shape: Sequence[int],
                   logical_axes: Sequence[Optional[str]], mesh=None,
                   rules: Optional[ShardingRules] = None) -> Optional[Tuple]:
    """The placements of a ``shape`` tensor by logical axes on ``mesh``
    (default: the active one), or ``None`` without a mesh."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    return resolve_spec(shape, logical_axes, mesh, rules or active_rules())


def local_slice(x: torch.Tensor, mesh, placements: Sequence) -> torch.Tensor:
    """This rank's part of the whole tensor ``x`` under ``placements``,
    mesh dim by mesh dim (``Shard`` on the same tensor dim twice splits
    left to right, as DTensor does), made contiguous: a split of dim 0
    is a view, a split of a later dim a copy (the kernels take
    contiguous operands).  Even splits only."""
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if pl.is_shard():
            d, n = pl.dim, mesh.size(i)
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split {n} ways")
            step = x.shape[d] // n
            x = x.narrow(d, coord[i] * step, step)
    return x.contiguous()


def place(x: torch.Tensor, mesh, placements: Sequence):
    """``x`` as a DTensor with ``placements``.  A plain tensor is the
    whole value on every rank: each rank keeps its own slice, so no data
    moves; a DTensor is redistributed."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(mesh, tuple(placements))
    return DTensor.from_local(local_slice(x, mesh, placements), mesh,
                              tuple(placements), run_check=False,
                              shape=x.shape, stride=x.stride())


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, and its gradient too:
    the reference's sharding constraint, which holds in the backward
    pass as well (its transpose).  A gradient arriving as a partial sum
    is reduced here, as the reference's partitioner reduces it, instead
    of flowing on as a partial sum that DTensor would meet by gathering
    the weights it multiplies."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.placements = mesh, placements
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.placements), None, None


def shard(x: torch.Tensor, *logical_axes: Optional[str]):
    """Place ``x`` by logical axes on the active mesh (:func:`place`);
    the identity without one.  On a DTensor that takes part in autograd
    the placement holds for its gradient too (:class:`_Constrain`)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    placements = named_sharding(x.shape, logical_axes, mesh)
    if x.requires_grad and hasattr(x, "placements"):
        return _Constrain.apply(x, mesh, tuple(placements))
    return place(x, mesh, placements)


def dropped_shardings() -> Dict[Tuple, int]:
    """Logical axes that had to be replicated because their dim did not
    divide.  An axis whose mesh axes are absent from the mesh is
    "unmapped", not dropped."""
    return dict(_DROPPED)


def clear_dropped() -> None:
    """Reset the dropped-sharding registry (it is process-global)."""
    _DROPPED.clear()


# ---------------------------------------------------------------------------
# Param-meta helpers (see repro_torch.models.params)
# ---------------------------------------------------------------------------


class Sharding(NamedTuple):
    """Where a leaf lives: a mesh and one DTensor placement per mesh dim.
    It unpacks as the ``(mesh, placements)`` pair that
    ``CheckpointManager.restore(shardings=)`` and ``distribute_tensor``
    take; :meth:`spec` gives the reference's PartitionSpec entries."""

    mesh: Any
    placements: Tuple

    def spec(self, ndim: int) -> Tuple:
        """The PartitionSpec entries of an ``ndim``-dim leaf: per tensor
        dim ``None``, the mesh axis that shards it, or a tuple of them
        in mesh order."""
        by_dim: Dict[int, list] = {}
        for (axis, _), pl in zip(mesh_axes(self.mesh), self.placements):
            if pl.is_shard():
                by_dim.setdefault(pl.dim, []).append(axis)
        out = []
        for d in range(ndim):
            axes = by_dim.get(d, ())
            out.append(None if not axes else
                       axes[0] if len(axes) == 1 else tuple(axes))
        return tuple(out)


def zero_entries(shape: Sequence[int], entries: Sequence, mesh,
                 rules: ShardingRules) -> Tuple:
    """The reference's ZeRO-1 rule on PartitionSpec ``entries``: the
    first dim that is unsharded and divisible by the ``zero`` mesh axes
    not already used (and at least as long as their product) also
    shards over them."""
    zero_axes = rules.mesh_axes_for("zero", mesh)
    spec = list(entries)
    used = set()
    for e in spec:
        if e is not None:
            used.update(e if isinstance(e, tuple) else (e,))
    avail = tuple(a for a in zero_axes if a not in used)
    if avail:
        sizes = dict(mesh_axes(mesh))
        total = 1
        for a in avail:
            total *= sizes[a]
        for i, (dim, e) in enumerate(zip(shape, spec)):
            if e is None and dim % total == 0 and dim >= total:
                spec[i] = avail if len(avail) > 1 else avail[0]
                break
    return tuple(spec)


def sharding_for_meta(meta_tree, mesh=None,
                      rules: Optional[ShardingRules] = None,
                      extra_zero: bool = False):
    """Map a ``ParamMeta`` tree to a tree of :class:`Sharding` leaves over
    ``mesh`` (default: the active one), or of ``None`` leaves without a
    mesh.  ``mesh`` is a ``DeviceMesh`` or a :class:`MeshShape` (the
    rule's arithmetic without devices).  ``extra_zero=True`` applies the
    ZeRO-1 rule (:func:`zero_entries`), as the optimizer moments take
    it."""
    from repro_torch.models.params import tree_map

    mesh = mesh or current_mesh()
    rules = rules or active_rules()
    if mesh is None:
        return tree_map(lambda m: None, meta_tree)

    def one(m) -> Sharding:
        entries = resolve_entries(m.shape, m.axes, mesh, rules)
        if extra_zero:
            entries = zero_entries(m.shape, entries, mesh, rules)
        return Sharding(mesh, entries_to_placements(entries, mesh))

    return tree_map(one, meta_tree)
