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

Not ported yet: ``use_mesh``, ``shard``, ``resolve_spec`` and the rest
of the active-mesh plumbing, which need real sharded execution.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple, Union

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
