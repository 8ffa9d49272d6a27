"""Proxy-benchmark IR: a DAG whose nodes are data sets and whose edges are
data-motif invocations (paper §II-B); port of
``repro/core/proxy_graph.py``.

A :class:`ProxyBenchmark` is a tuple of :class:`MotifNode`; each node names
the motif+variant it applies, its parameter vector P, and the upstream
nodes whose *intermediate data* it consumes.  Execution is one eager
function over the nodes in topological order.

Intermediate-data flow: an upstream output leaf that matches a downstream
input leaf in name+shape+dtype is forwarded directly; every remaining
input is *data-chained* — perturbed by a checksum of the upstream outputs
— so each node depends on its upstream nodes' results.

Under an active mesh (:func:`repro_torch.distributed.sharding.use_mesh`)
each node's generated inputs are placed on it (:func:`_shard_batch`), so
the motifs run as DTensors and the profile carries the collectives their
sharded forms need.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.motifs.base import (
    LIFT_REPEATS,
    LIFT_SCALE,
    LIFT_SPARSITY,
    LIFT_ZIPF,
    MOTIFS,
    PVector,
    _tree_checksum,
    _tree_map,
    _tree_perturb,
    get_motif,
)
from repro_torch.core.cluster import batch_quantum, model_quantum
from repro_torch.data.generators import derive_seed
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import active_rules, current_mesh, shard
from repro_torch.distributed.spmd import settle


def _shard_batch(tree):
    """Place motif input leaves on the active mesh by logical axes (the
    identity without one).

    A proxy inherits the cluster scenario this way: its input data splits
    across the mesh's data axis like the real workload's batch inputs, so
    the sharded motifs emit the same collective classes (all-reduce for
    cross-shard reductions, all-gather for whole-axis sorts, ...).  The
    ``batch`` dim is the FIRST one divisible by the batch quantum; on a
    2-D ``data x model`` mesh a second dim divisible by the model quantum
    takes ``motif_width``.  A leaf with no divisible dim stays whole on
    every rank (``quantize_proxy`` exists to avoid that).  Each rank
    generated the whole leaf and keeps its own slice, so placing moves no
    data."""
    mesh = current_mesh()
    if mesh is None:
        return tree
    rules = active_rules()
    quantum = batch_quantum(mesh, rules)
    wq = model_quantum(mesh, rules)
    if quantum <= 1 and wq <= 1:
        return tree

    def one(x):
        if not isinstance(x, torch.Tensor) or x.ndim < 1:
            return x
        axes = [None] * x.ndim
        bdim = None
        if quantum > 1:
            for d in range(x.ndim):
                if x.shape[d] % quantum == 0 and x.shape[d] >= quantum:
                    axes[d] = "batch"
                    bdim = d
                    break
        if wq > 1:
            for d in range(x.ndim):
                if d == bdim:
                    continue
                if x.shape[d] % wq == 0 and x.shape[d] >= wq:
                    axes[d] = "motif_width"
                    break
        if all(a is None for a in axes):
            return x  # no divisible dim: whole on every rank
        return shard(x, *axes)

    return _tree_map(one, tree)


@dataclass(frozen=True)
class MotifNode:
    id: str
    motif: str
    variant: str = ""
    p: PVector = PVector()
    deps: Tuple[str, ...] = ()

    def replace(self, **kw) -> "MotifNode":
        return dataclasses.replace(self, **kw)


class GraphError(ValueError):
    pass


@dataclass(frozen=True)
class ProxyBenchmark:
    """A qualified (or in-tuning) proxy benchmark."""

    name: str
    nodes: Tuple[MotifNode, ...]
    meta: Mapping[str, Any] = field(default_factory=dict)

    # -- well-formedness ----------------------------------------------------
    def validate(self) -> None:
        ids = [n.id for n in self.nodes]
        if len(set(ids)) != len(ids):
            raise GraphError(f"duplicate node ids in {self.name}")
        known = set()
        for n in self.nodes:
            if n.motif not in MOTIFS:
                raise GraphError(f"{n.id}: unknown motif {n.motif!r}")
            get_motif(n.motif).resolve_variant(n.variant)
            for d in n.deps:
                if d not in known:
                    raise GraphError(
                        f"{n.id}: dep {d!r} missing or not topologically "
                        f"ordered (nodes must be listed in topo order)")
            known.add(n.id)

    def topo_order(self) -> Tuple[MotifNode, ...]:
        self.validate()
        return self.nodes  # validate() enforces topological listing

    # -- editing --------------------------------------------------------------
    def with_node(self, node_id: str, **p_updates) -> "ProxyBenchmark":
        """Return a copy with one node's P fields replaced."""
        nodes = tuple(
            n.replace(p=n.p.replace(**p_updates)) if n.id == node_id else n
            for n in self.nodes)
        return dataclasses.replace(self, nodes=nodes)

    def node(self, node_id: str) -> MotifNode:
        for n in self.nodes:
            if n.id == node_id:
                return n
        raise KeyError(node_id)

    def with_substrate(self, substrate: str) -> "ProxyBenchmark":
        """Copy with every node's execution substrate set; ``self`` when
        every node already runs on ``substrate``."""
        if all(n.p.substrate == substrate for n in self.nodes):
            return self
        nodes = tuple(n.replace(p=n.p.replace(substrate=substrate))
                      for n in self.nodes)
        return dataclasses.replace(self, nodes=nodes)

    # -- structural identity ------------------------------------------------
    def shape_signature(self, include_repeats: bool = True) -> Tuple:
        """Canonical key of what the eval form runs: equal signatures run
        the same ops at the same shapes, so their profiles are equal.  The
        lifted knobs (raw weight, sparsity, dist_scale, zipf_alpha) never
        appear."""
        return tuple(
            (n.id, n.motif, get_motif(n.motif).resolve_variant(n.variant),
             n.deps, n.p.structural_key(include_repeats))
            for n in self.nodes)

    def lifted_values(self, device: DeviceLike = None) -> torch.Tensor:
        """The lifted-argument tensor ``f32[n_nodes, 4]``: columns
        (repeats, sparsity, dist_scale, zipf_alpha)."""
        return torch.tensor([n.p.lifted_row() for n in self.nodes],
                            dtype=torch.float32,
                            device=resolve_device(device))

    # -- execution --------------------------------------------------------------
    def _graph_runner(self, lift_reps: bool, lift_data: bool,
                      device: DeviceLike) -> Callable:
        order = self.topo_order()
        dev = resolve_device(device)

        def run(seed: int, lifted: Optional[torch.Tensor] = None,
                max_reps: Optional[Sequence[int]] = None) -> Dict[str, Any]:
            if lifted is not None and lift_reps and max_reps is None:
                # outside vmap the host can read the counts itself
                max_reps = [int(r) for r in
                            lifted[:, LIFT_REPEATS].tolist()]
            outputs: Dict[str, Any] = {}
            for i, node in enumerate(order):
                motif = get_motif(node.motif)
                p_run = node.p
                reps = cap = None
                if lifted is not None:
                    if lift_data:
                        p_run = p_run.replace(
                            sparsity=lifted[i, LIFT_SPARSITY],
                            dist_scale=lifted[i, LIFT_SCALE],
                            zipf_alpha=lifted[i, LIFT_ZIPF])
                    if lift_reps:
                        reps, cap = lifted[i, LIFT_REPEATS], max_reps[i]
                inputs = _shard_batch(
                    motif.make_inputs(p_run, derive_seed(seed, i), dev))
                if node.deps:
                    _, inputs = _forward_intermediate(
                        inputs, [outputs[d] for d in node.deps])
                    eps = torch.zeros((), dtype=torch.float32, device=dev)
                    for d in node.deps:
                        eps = eps + _tree_checksum(outputs[d])
                    inputs = _tree_perturb(inputs, eps)
                outputs[node.id] = motif.weighted_apply_dynamic(
                    p_run, inputs, node.variant, reps, cap)
            # an SPMD program returns no pending partial sums
            return settle(outputs) if current_mesh() is not None else outputs

        return run

    def build_fn(self, device: DeviceLike = None
                 ) -> Callable[[int], Dict[str, Any]]:
        """``seed -> {node_id: outputs}``, every P value baked in."""
        run = self._graph_runner(lift_reps=False, lift_data=False,
                                 device=device)
        return lambda seed: run(seed)

    def build_eval_fn(self, device: DeviceLike = None) -> Callable:
        """``(seed, lifted: f32[n_nodes, 4]) -> outputs`` — the *eval
        form* the evaluator profiles: sparsity, dist_scale and zipf_alpha
        come from ``lifted`` as tensors (so their masks and multiplies
        always run), repeats from each node's P."""
        return self._graph_runner(lift_reps=False, lift_data=True,
                                  device=device)

    def build_lifted_fn(self, device: DeviceLike = None) -> Callable:
        """``(seed, lifted: f32[n_nodes, 4], max_reps=None) -> outputs``
        with repeats also lifted — the *population form*, whose shape key
        is ``shape_signature(include_repeats=False)``.

        ``torch.func.vmap`` over ``lifted`` runs a whole population of
        weight and data-characteristic assignments in one call; each
        node's loop then runs to ``max_reps[i]``, the largest repeat
        count of the lanes (the host reads it from ``lifted`` itself
        outside vmap)."""
        return self._graph_runner(lift_reps=True, lift_data=True,
                                  device=device)

    # -- (de)serialisation --------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "name": self.name,
            "meta": dict(self.meta),
            "nodes": [{
                "id": n.id, "motif": n.motif, "variant": n.variant,
                "deps": list(n.deps), "p": dataclasses.asdict(n.p),
            } for n in self.nodes],
        }, indent=1)

    @staticmethod
    def from_json(text: str) -> "ProxyBenchmark":
        d = json.loads(text)
        nodes = tuple(
            MotifNode(id=nd["id"], motif=nd["motif"], variant=nd["variant"],
                      deps=tuple(nd["deps"]), p=PVector(**nd["p"]))
            for nd in d["nodes"])
        pb = ProxyBenchmark(d["name"], nodes, d.get("meta", {}))
        pb.validate()
        return pb


def _forward_intermediate(inputs: Any, dep_outputs: Sequence[Any]):
    """Forward matching upstream leaves into this node's inputs.

    A leaf matches when key, shape and dtype agree.  Returns
    (num_forwarded, inputs)."""
    if not isinstance(inputs, dict):
        return 0, inputs
    avail: Dict[str, torch.Tensor] = {}
    for out in dep_outputs:
        if isinstance(out, dict):
            for k, v in out.items():
                if isinstance(v, torch.Tensor):
                    avail.setdefault(k, v)
    fed = 0
    new = dict(inputs)
    for k, v in inputs.items():
        cand = avail.get(k)
        if (cand is not None and isinstance(v, torch.Tensor)
                and cand.shape == v.shape and cand.dtype == v.dtype):
            new[k] = cand
            fed += 1
    return fed, new


# ---------------------------------------------------------------------------
# Construction helpers
# ---------------------------------------------------------------------------


def linear_chain(name: str, specs: Sequence[Tuple[str, str, PVector]],
                 meta: Optional[Mapping[str, Any]] = None) -> ProxyBenchmark:
    """Build a chain proxy: each node depends on the previous one."""
    nodes: List[MotifNode] = []
    prev: Optional[str] = None
    for i, (motif, variant, p) in enumerate(specs):
        nid = f"n{i}_{motif}"
        nodes.append(MotifNode(nid, motif, variant, p,
                               deps=(prev,) if prev else ()))
        prev = nid
    pb = ProxyBenchmark(name, tuple(nodes), meta or {})
    pb.validate()
    return pb
