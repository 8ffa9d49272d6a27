"""Cluster scenarios — the paper's "changing cluster configurations" axis
(§III-D) and cross-architecture trend consistency (§III-E); port of
``repro/core/cluster.py`` onto ``torch.distributed``.

A :class:`ClusterScenario` names one point of the paper's evaluation
grid: device count x mesh shape x input-data scale.  Its mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the first
``device_count`` ranks of the process group (every rank runs the same
program, SPMD; ranks outside a scenario's mesh skip its cells).  Both the
real workload ``step`` and the proxy's eval form run sharded over that
mesh through one logical-axis rule table
(:mod:`repro_torch.distributed.sharding`):

* workload inputs place their leading dim by the per-argument logical
  axes on the :class:`~repro_torch.workloads.base.Workload`
  (``input_axes``), resolved to DTensor placements by :func:`shard_args`;
* proxy motif inputs take the same ``"batch"`` logical axis inside the
  proxy runner (``proxy_graph._shard_batch``), so the sharded motifs emit
  collectives and the profiled :class:`~repro_torch.core.signature.
  Signature` carries nonzero ``collective_bytes``, the paper's
  network/disk-I/O analog.

The single-device scenario has **no mesh at all**
(:meth:`ClusterScenario.mesh` returns ``None``): every sharding hook is
the identity without an active mesh, so the 1-device scenario is the
single-device path bit for bit.

A mesh is read only through its axis names and per-axis sizes
(:func:`repro_torch.distributed.sharding.mesh_axes`), so the arithmetic
below (:func:`mesh_structural_key`, the quanta, :func:`quantize_proxy`)
also takes a stand-in such as
:class:`~repro_torch.distributed.sharding.MeshShape`.

Under SPMD every rank of a mesh must agree on what it measured, or the
tuners of different ranks would walk different trees and deadlock in a
collective: :func:`agree` gives every rank the mesh's first rank's
profile, and the wall time of a sharded program is the maximum over the
mesh's ranks (:func:`repro_torch.core.signature.timed_wall`), since an
SPMD step ends with its slowest rank.

:func:`trend_consistency` scores the §III-D/§III-E claim itself.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import (
    ShardingRules,
    mesh_axes,
    place,
    resolve_spec,
    use_mesh,
)
from repro_torch.distributed.spmd import settle

#: how many ranks a program starts when it sets up its own process group
#: (``bench/scenario_matrix.py``, ``bench/stress_matrix.py``), the
#: reference's variable
EMU_DEVICES_ENV = "REPRO_EMU_DEVICES"


class ClusterError(ValueError):
    """Bad scenario definition or scenario/host mismatch."""


@dataclass(frozen=True)
class ClusterScenario:
    """One cluster configuration of the paper's §III-D evaluation grid.

    ``device_count`` is redundant with ``prod(mesh_shape)`` on purpose:
    construction fails loudly when the mesh shape does not factor it (the
    "indivisible mesh" error).  ``data_scale`` multiplies the workload's
    input scale — the paper grows the data with the cluster."""

    name: str
    device_count: int
    mesh_shape: Tuple[int, ...] = ()
    axis_names: Tuple[str, ...] = ("data",)
    data_scale: float = 1.0
    description: str = ""

    def __post_init__(self):
        shape = self.mesh_shape or (self.device_count,)
        object.__setattr__(self, "mesh_shape", tuple(int(s) for s in shape))
        if self.device_count < 1 or any(s < 1 for s in self.mesh_shape):
            raise ClusterError(
                f"{self.name}: device_count and mesh dims must be >= 1")
        if len(self.mesh_shape) != len(self.axis_names):
            raise ClusterError(
                f"{self.name}: mesh_shape {self.mesh_shape} needs "
                f"{len(self.mesh_shape)} axis names, got {self.axis_names}")
        if math.prod(self.mesh_shape) != self.device_count:
            raise ClusterError(
                f"{self.name}: mesh shape {self.mesh_shape} does not factor "
                f"device_count={self.device_count} (indivisible mesh)")

    # -------------------------------------------------------------------
    def mesh(self, device_type: Optional[str] = None):
        """The scenario's ``DeviceMesh`` over the first ``device_count``
        ranks of the default process group, or ``None`` for the
        single-device scenario (every sharding hook is then the
        identity).

        Raises :class:`ClusterError` when the process group has fewer
        ranks than the scenario needs (no group counts as one rank).
        Building a mesh creates process groups, a collective call: every
        rank must call this for the same scenarios in the same order.
        Meshes are kept by (device type, shape, names), so a second call
        returns the first one's mesh.  ``device_type`` defaults to
        ``"cuda"`` when the process has a CUDA device, else ``"cpu"``."""
        if self.device_count == 1:
            return None
        dist = torch.distributed
        world = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 1)
        if world < self.device_count:
            raise ClusterError(
                f"scenario {self.name!r} needs {self.device_count} ranks "
                f"but the process group has {world}; start "
                f"{self.device_count} or more ranks (scenario_matrix and "
                f"stress_matrix start {EMU_DEVICES_ENV} of them)")
        if device_type is None:
            device_type = "cuda" if torch.cuda.is_available() else "cpu"
        key = (device_type, self.mesh_shape, self.axis_names)
        if key not in _MESHES:
            _MESHES[key] = _build_mesh(device_type, self.mesh_shape,
                                       self.axis_names)
        return _MESHES[key]


#: (device type, mesh shape, axis names) -> DeviceMesh, built once a
#: process
_MESHES: Dict[Tuple, Any] = {}
#: ranks (a tuple) -> the process group over them
_GROUPS: Dict[Tuple[int, ...], Any] = {}


def _build_mesh(device_type: str, shape: Tuple[int, ...],
                names: Tuple[str, ...]):
    """A DeviceMesh over ranks ``0 .. prod(shape) - 1``, plus one process
    group over all of them (:func:`mesh_group`).  Collective: every rank
    calls it, in the same order."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    ranks = tuple(range(n))
    if ranks not in _GROUPS:
        _GROUPS[ranks] = (torch.distributed.group.WORLD
                          if n == torch.distributed.get_world_size()
                          else torch.distributed.new_group(list(ranks)))
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def mesh_ranks(mesh) -> Tuple[int, ...]:
    """The global ranks of a ``DeviceMesh``, in mesh order."""
    return tuple(int(r) for r in mesh.mesh.flatten().tolist())


def mesh_group(mesh):
    """The process group over every rank of ``mesh``: the default group
    when the mesh spans it, else the group :meth:`ClusterScenario.mesh`
    made with it."""
    ranks = mesh_ranks(mesh)
    if len(ranks) == torch.distributed.get_world_size():
        return torch.distributed.group.WORLD
    if tuple(sorted(ranks)) not in _GROUPS:
        raise ClusterError(f"no process group over ranks {ranks}: build "
                           f"the mesh with ClusterScenario.mesh()")
    return _GROUPS[tuple(sorted(ranks))]


def in_mesh(mesh) -> bool:
    """Whether this process is one of ``mesh``'s ranks (``None``, the
    single-device scenario, has every rank)."""
    return mesh is None or torch.distributed.get_rank() in mesh_ranks(mesh)


def agree(obj: Any, mesh) -> Any:
    """The mesh's first rank's ``obj`` on every rank of ``mesh`` (one
    object broadcast); ``obj`` itself without a mesh."""
    if mesh is None:
        return obj
    box = [obj]
    torch.distributed.broadcast_object_list(
        box, src=mesh_ranks(mesh)[0], group=mesh_group(mesh))
    return box[0]


def mesh_max(value: float, mesh) -> float:
    """The largest ``value`` over the ranks of ``mesh`` (``value``
    without a mesh): an SPMD step ends with its slowest rank."""
    if mesh is None:
        return value
    out = [None] * len(mesh_ranks(mesh))
    torch.distributed.all_gather_object(out, value, group=mesh_group(mesh))
    return max(out)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

SCENARIOS: "OrderedDict[str, ClusterScenario]" = OrderedDict()


def register_scenario(s: ClusterScenario) -> ClusterScenario:
    SCENARIOS[s.name] = s
    return s


def get_scenario(name: str) -> ClusterScenario:
    if name not in SCENARIOS:
        raise ClusterError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    return SCENARIOS[name]


register_scenario(ClusterScenario(
    "single", 1, (1,), ("data",),
    description="the legacy single-device path (no mesh at all)"))
register_scenario(ClusterScenario(
    "dp2", 2, (2,), ("data",),
    description="2-way data parallelism"))
register_scenario(ClusterScenario(
    "dp4", 4, (4,), ("data",),
    description="4-way data parallelism"))
register_scenario(ClusterScenario(
    "dp2xmp2", 4, (2, 2), ("data", "model"),
    description="2-way data x 2-way model mesh"))
register_scenario(ClusterScenario(
    "dp2_mp2", 4, (2, 2), ("data", "model"),
    description="2-way data x 2-way model mesh (canonical 2-D scenario "
                "name; same topology as dp2xmp2)"))
register_scenario(ClusterScenario(
    "dp4_mp2", 8, (4, 2), ("data", "model"),
    description="4-way data x 2-way model mesh (larger emulated hosts)"))
register_scenario(ClusterScenario(
    "dp2_mp1", 2, (2, 1), ("data", "model"),
    description="degenerate 2-D mesh: 2-way data x 1-way model — the "
                "2-device 2-D scenario CI smoke can afford; exercises "
                "the data x model axis plumbing with a unit model axis"))
register_scenario(ClusterScenario(
    "dp1_mp2", 2, (1, 2), ("data", "model"),
    description="degenerate 2-D mesh: 1-way data x 2-way model — all "
                "parallelism on the model axis, zero batch quantum "
                "growth (stress tier: the 1xN hostile topology)"))
register_scenario(ClusterScenario(
    "dp2_2xdata", 2, (2,), ("data",), data_scale=2.0,
    description="2 devices with doubled input data (paper: data grows "
                "with the cluster)"))
register_scenario(ClusterScenario(
    "dp2_4xdata", 2, (2,), ("data",), data_scale=4.0,
    description="2 devices with quadrupled input data — a second "
                "2-device point so trend consistency over mesh-tuned "
                "proxies can run on 2-device CI hosts"))
register_scenario(ClusterScenario(
    "dp4_2xdata", 4, (4,), ("data",), data_scale=2.0,
    description="4-way data parallelism with doubled input data"))
register_scenario(ClusterScenario(
    "dp8", 8, (8,), ("data",),
    description="8-way data parallelism (larger emulated hosts)"))


def shrink_scenario(scn: ClusterScenario, drop: int = 1,
                    name: Optional[str] = None) -> ClusterScenario:
    """The changing-cluster repro: ``scn`` minus ``drop`` devices.

    The shrunken scenario keeps the axis names and every non-leading axis
    size (model parallelism is a property of the program); only the
    leading (data) axis absorbs the loss.  Raises :class:`ClusterError`
    when the remaining device count cannot keep the non-leading axes."""
    n = scn.device_count - int(drop)
    if n < 1:
        raise ClusterError(
            f"cannot drop {drop} of {scn.device_count} devices from "
            f"scenario {scn.name!r}: no devices would remain")
    rest = scn.mesh_shape[1:]
    rest_prod = int(math.prod(rest)) if rest else 1
    if n % rest_prod:
        raise ClusterError(
            f"cannot shrink scenario {scn.name!r} from "
            f"{scn.device_count} to {n} devices: the non-leading mesh "
            f"axes {dict(zip(scn.axis_names[1:], rest))} need device "
            f"counts divisible by {rest_prod}; re-tune under an "
            f"explicit ({n},)-shaped scenario instead")
    shape = (n // rest_prod,) + rest
    return ClusterScenario(
        name or f"{scn.name}_minus{drop}", n, shape, scn.axis_names,
        scn.data_scale,
        description=f"{scn.name} after losing {drop} device(s): "
                    f"mesh {scn.mesh_shape} -> {shape}")


# ---------------------------------------------------------------------------
# Mesh identity for the executable cache
# ---------------------------------------------------------------------------


def mesh_structural_key(mesh) -> Optional[Tuple]:
    """The mesh's contribution to the executable-cache key, or ``None``.

    Two meshes with equal keys partition a program identically: only the
    axis names and the per-axis sizes count, never which device backs
    which coordinate.  ``None`` (no mesh) yields ``None``."""
    if mesh is None:
        return None
    axes = mesh_axes(mesh)
    return ("__mesh__", tuple(a for a, _ in axes),
            tuple(n for _, n in axes))


def axis_quantum(mesh, logical: str,
                 rules: Optional[ShardingRules] = None) -> int:
    """Number of ways the logical axis ``logical`` splits on ``mesh``: the
    product of the sizes of every mesh axis the rule table maps it onto
    and that is present on the mesh.  1 for no mesh, and 1 for a logical
    axis whose mapped mesh axes are all absent."""
    if mesh is None:
        return 1
    rules = rules or ShardingRules()
    sizes = dict(mesh_axes(mesh))
    q = 1
    for a in rules.mesh_axes_for(logical, mesh):
        q *= sizes[a]
    return q


def batch_quantum(mesh, rules: Optional[ShardingRules] = None) -> int:
    """Number of ways the logical ``batch`` axis splits on ``mesh`` (1 for
    no mesh): the divisibility quantum for data-parallel dims."""
    return axis_quantum(mesh, "batch", rules)


def model_quantum(mesh, rules: Optional[ShardingRules] = None) -> int:
    """Number of ways the logical ``motif_width`` axis splits on ``mesh``:
    the quantum for the proxy's width dims on 2-D ``data x model`` meshes,
    1 on 1-D meshes."""
    return axis_quantum(mesh, "motif_width", rules)


def mesh_task_quantum(mesh) -> int:
    """Total parallel device lanes a mesh offers, the product of its axis
    sizes (1 for no mesh): the ``num_tasks`` seeding quantum.  Unlike
    :func:`batch_quantum` it counts every axis."""
    if mesh is None:
        return 1
    return int(math.prod(n for _, n in mesh_axes(mesh)))


#: P fields subject to mesh quantization: the data-volume dims a cluster
#: scenario shards across its ``batch`` axis.  Every other tunable P
#: entry is free.
QUANTIZED_FIELDS: Tuple[str, ...] = ("data_size", "batch_size")


def quantize_proxy(pb, mesh, rules: Optional[ShardingRules] = None):
    """Round a proxy's ``QUANTIZED_FIELDS`` up to the nearest multiple of
    the mesh's batch quantum (at most ``quantum - 1`` more a field and
    node); every other P entry is untouched.  Identity when ``mesh`` is
    ``None`` or the quantum is 1.  The quantum is axis-aware: on a 2-D
    ``data x model`` mesh it is the data axis alone."""
    q = batch_quantum(mesh, rules)
    if q <= 1:
        return pb
    out = pb
    for node in pb.nodes:
        p = node.p
        updates = {}
        for f in QUANTIZED_FIELDS:
            v = int(getattr(p, f))
            if v % q:
                updates[f] = v + q - v % q
        if updates:
            out = out.with_node(node.id, **updates)
    return out


def make_quantizer(mesh, rules: Optional[ShardingRules] = None):
    """The tuner-facing rounding rule for one mesh: a ``ProxyBenchmark ->
    ProxyBenchmark`` closure over :func:`quantize_proxy`, or ``None``
    when it would be the identity (no mesh, or a 1-way batch quantum), so
    the tuner's no-quantize path stays untouched."""
    if batch_quantum(mesh, rules) <= 1:
        return None
    return lambda pb: quantize_proxy(pb, mesh, rules)


# ---------------------------------------------------------------------------
# Workload-side sharding
# ---------------------------------------------------------------------------


def _is_placements(tree) -> bool:
    return (isinstance(tree, tuple) and len(tree) > 0
            and all(hasattr(p, "is_replicate") for p in tree))


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples; a tuple
    of DTensor placements is one leaf."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_placements(tree):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_args(args: Sequence[Any], input_axes: Sequence[Optional[str]],
               mesh, rules: Optional[ShardingRules] = None):
    """Per-argument placements for a workload ``step``, or ``None``
    without a mesh.

    ``input_axes[i]`` names the logical axis of argument i's *leading*
    dim (``"batch"`` for data-parallel inputs, ``None`` for replicated
    state like parameters); the rule table maps it onto the mesh.  Every
    tensor leaf of an argument (a dict of parameters, say) takes the
    argument's axis; scalars and indivisible dims replicate.  Each entry
    mirrors its argument's structure with a placements tuple a leaf."""
    if mesh is None:
        return None
    rules = rules or ShardingRules()
    axes = list(input_axes) + [None] * (len(args) - len(input_axes))

    def placements_for(leaf, logical):
        shape = tuple(getattr(leaf, "shape", ()) or ())
        if not shape or logical is None:
            return resolve_spec((), (), mesh, rules)
        return resolve_spec(shape, (logical,) + (None,) * (len(shape) - 1),
                            mesh, rules)

    return tuple(
        _tree_map(lambda leaf, lg=logical: placements_for(leaf, lg), arg)
        for arg, logical in zip(args, axes))


def place_args(args: Sequence[Any], placements: Sequence[Any], mesh):
    """``args`` as DTensors by :func:`shard_args`' placements: each rank
    keeps its own slice of every leaf (no collective).  A workload whose
    arguments all replicate runs on plain tensors: every rank then runs
    the whole step, which needs no collective either."""
    flat = []
    _tree_map(flat.append, tuple(placements))
    if all(all(p.is_replicate() for p in pl) for pl in flat):
        return tuple(args)

    def walk(arg, pl):
        if isinstance(arg, dict):
            return {k: walk(arg[k], pl[k]) for k in arg}
        if isinstance(arg, (list, tuple)) and not _is_placements(pl):
            return type(arg)(walk(a, p) for a, p in zip(arg, pl))
        if isinstance(arg, torch.Tensor):
            return place(arg, mesh, pl)
        return arg

    return tuple(walk(a, p) for a, p in zip(args, placements))


def splits_inputs(args: Sequence[Any], input_axes: Sequence[Optional[str]],
                  mesh, rules: Optional[ShardingRules] = None) -> bool:
    """Whether any input leaf of a ``step`` splits on ``mesh`` (False
    without a mesh, or when every leading dim is indivisible: the step
    then runs whole on every rank and moves no collective)."""
    if mesh is None:
        return False
    flat = []
    _tree_map(flat.append, shard_args(args, input_axes, mesh, rules))
    return any(p.is_shard() for pl in flat for p in pl)


def workload_signature(step, args: Sequence[Any],
                       input_axes: Sequence[Optional[str]] = (),
                       mesh=None, *, run: bool = True, iters: int = 5,
                       rules: Optional[ShardingRules] = None):
    """Signature of ``step(*args)`` under one cluster scenario.

    With ``mesh=None`` this is exactly ``signature_of_call`` — the
    single-device profile.  With a mesh, inputs are placed per
    ``input_axes`` and the profile is one rank's (the mesh's first rank's,
    on every rank: :func:`agree`), carrying the collectives the sharded
    step issued, partial sums among its outputs all-reduced as an SPMD
    program's are; the wall time is the slowest rank's.  A step whose
    inputs all stay whole (:func:`splits_inputs`) runs unsharded on every
    rank and keeps the single-device timing."""
    from repro_torch.core.signature import profile_call, timed_wall

    if mesh is None:
        from repro_torch.core.signature import signature_of_call

        return signature_of_call(step, *args, run=run, iters=iters)
    device = _first_device(args)
    if not splits_inputs(args, input_axes, mesh, rules):
        # nothing divides: every rank runs the whole step, unsharded
        from repro_torch.core.signature import signature_of_call

        sig = signature_of_call(step, *args, run=run, iters=iters)
        wall = None if sig.wall_time is None else mesh_max(sig.wall_time,
                                                           mesh)
        sig = agree(sig, mesh)
        sig.wall_time = wall
        return sig
    placed = place_args(args, shard_args(args, input_axes, mesh, rules),
                        mesh)

    def sharded():  # its outputs as an SPMD program returns them
        return settle(step(*placed))

    with use_mesh(mesh, rules):
        sig = agree(profile_call(sharded, device=device), mesh)
        if run:
            sig.wall_time, sig.timing = timed_wall(sharded, iters=iters,
                                                   device=device)
    return sig


def _first_device(args) -> torch.device:
    found = []
    _tree_map(lambda t: found.append(t.device)
              if isinstance(t, torch.Tensor) else None, tuple(args))
    return found[0] if found else torch.device("cpu")


# ---------------------------------------------------------------------------
# Trend consistency (paper §III-D / §III-E)
# ---------------------------------------------------------------------------


def _avg_ranks(vals: np.ndarray) -> np.ndarray:
    """Average ranks (ties share their mean rank) — Spearman's rho input."""
    order = np.argsort(vals, kind="stable")
    ranks = np.empty(len(vals), np.float64)
    i = 0
    while i < len(vals):
        j = i
        while j + 1 < len(vals) and vals[order[j + 1]] == vals[order[i]]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0
        i = j + 1
    return ranks


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    flat_a = bool(np.all(a == a[0]))
    flat_b = bool(np.all(b == b[0]))
    if flat_a or flat_b:
        # both flat: trivially consistent.  Exactly one flat: it does not
        # track the other at all, which scores 0, not "undefined -> 1.0"
        return 1.0 if (flat_a and flat_b) else 0.0
    ra, rb = _avg_ranks(a), _avg_ranks(b)
    va, vb = ra - ra.mean(), rb - rb.mean()
    denom = float(np.sqrt((va * va).sum() * (vb * vb).sum()))
    if denom == 0.0:
        return 0.0
    return float((va * vb).sum() / denom)


def trend_consistency(real: Mapping[str, Mapping[str, float]],
                      proxy: Mapping[str, Mapping[str, float]],
                      scenarios: Optional[Sequence[str]] = None,
                      metrics: Optional[Sequence[str]] = None,
                      rel_eps: float = 0.02) -> Dict[str, Any]:
    """Do proxy metrics move the way real metrics move across scenarios?

    ``real``/``proxy`` map scenario name -> metric vector.  For each
    metric present in both tables across all scenarios: **sign
    agreement**, over consecutive scenario pairs the fraction where the
    real and proxy deltas have the same direction (a delta within
    ``rel_eps`` of the metric's magnitude is flat; flat-vs-flat agrees,
    flat-vs-moving does not), and **rank agreement**, Spearman's rho of
    the scenario orderings the two induce.  Returns per-metric scores
    and their means."""
    names = list(scenarios if scenarios is not None else real.keys())
    if len(names) < 2:
        raise ClusterError("trend consistency needs >= 2 scenarios")
    if metrics is None:
        metrics = sorted(
            set.intersection(*(set(real[s]) for s in names),
                             *(set(proxy[s]) for s in names)))

    def sign(delta: float, base: float) -> int:
        if abs(delta) <= rel_eps * max(abs(base), 1e-12):
            return 0
        return 1 if delta > 0 else -1

    per_metric: Dict[str, Dict[str, float]] = {}
    for m in metrics:
        r = np.asarray([float(real[s][m]) for s in names], np.float64)
        p = np.asarray([float(proxy[s][m]) for s in names], np.float64)
        agree = [
            sign(r[i + 1] - r[i], r[i]) == sign(p[i + 1] - p[i], p[i])
            for i in range(len(names) - 1)
        ]
        per_metric[m] = {
            "sign_agreement": float(np.mean(agree)),
            "rank_agreement": _spearman(r, p),
        }
    if not per_metric:
        raise ClusterError("no shared metrics across the scenario tables")
    return {
        "scenarios": names,
        "per_metric": per_metric,
        "mean_sign_agreement": float(np.mean(
            [v["sign_agreement"] for v in per_metric.values()])),
        "mean_rank_agreement": float(np.mean(
            [v["rank_agreement"] for v in per_metric.values()])),
    }
