"""Explicit SPMD pieces for ops DTensor cannot place by itself.

Under a mesh (:func:`repro_torch.distributed.sharding.use_mesh`) motif
and workload code runs on DTensors, and DTensor's own sharding rules
place most ops.  The few it has no rule for get one here, at the
collective the reference's SPMD partitioner emits for them:

* :func:`segment_add` (``index_add_`` into a replicated buffer from
  sharded ids): each rank adds its own ids, then one all-reduce;
* :func:`segment_max` (``scatter_reduce_`` by ``amax``): one max
  all-reduce;
* :func:`bincount` likewise, a sum all-reduce;
* :func:`gather_rows` (rows of a tensor split on dim 0 taken by a whole
  index, a sort's payload by its order): each rank picks the rows it
  holds, zeros elsewhere, and one sum all-reduce assembles them, the
  masked all-reduce the reference's partitioner emits, where DTensor
  would gather the whole operand first;
* :func:`batch_sum`: a batch statistic (the AI steps' batch norm) as
  per-rank sums and one all-reduce, its gradient made whole at its own
  size before it spreads over the batch;
* :func:`replicate_dims` / :func:`replicated`: an operand that must be
  whole on some dims (or all) is all-gathered or all-reduced there;
* :func:`batch_conv`: a convolution on its batch shard with the whole
  filter, whose gradient is a partial sum (DTensor's own convolution
  handler is written for inputs split along their width); pads
  (:func:`local_op`) and the row moments of a flattened shard
  (:func:`rows_op`) run shard by shard likewise;
* :func:`settle`: a program's outputs leave it whole or split, never as
  pending partial sums (an SPMD program's results are all-reduced);
* :func:`probe_sum`: the sum of a tensor's first elements (the proxy's
  dependency checksum) from the rank that holds them, one scalar
  all-reduce instead of gathering the whole tensor;
* ``aten.searchsorted`` and the pooling ops get sharding rules
  (:func:`register_rules`): a search shards with its queries over a
  replicated sorted sequence, a pool with its batch and channel dims;
* so do the three main-path kernel ops, each with its stock op's rule:
  ``repro_torch::matmul`` as ``aten.mm`` (rows, columns, or a sharded
  contraction giving a partial sum), ``repro_torch::row_moments`` as a
  mean over the last dim (leading dims shard, a sharded last dim gives
  partial averages) and ``repro_torch::bitonic_sort_blocks`` as a sort of
  each block (whole blocks shard).  Each rank's kernel runs on its own
  shard; a layout no rule takes is redistributed by DTensor, and an op
  DTensor cannot place raises.

The helpers take DTensors (:func:`replicated` passes a plain tensor
through); callers keep their plain path for plain tensors, so a program
without a mesh runs as before.
"""
from __future__ import annotations

import functools
import sys
from typing import Sequence

import torch

from repro_torch.uint32 import widen


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor, without importing DTensor (a program
    that never made one need not pay for the import)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _partial_over(placements: Sequence, dim: int,
                  reduce_op: str = "sum") -> tuple:
    """Placements of a result that reduces per rank (``reduce_op``) over
    the mesh dims that shard tensor dim ``dim`` and is whole on the
    others."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(Partial(reduce_op) if p.is_shard(dim) else Replicate()
                 for p in placements)


def _reduced(local: torch.Tensor, like, reduce_op: str = "sum"):
    """A replicated DTensor of per-rank results ``local`` reduced over the
    mesh dims that shard dim 0 of the DTensor ``like``."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    part = DTensor.from_local(
        local, mesh, _partial_over(like.placements, 0, reduce_op),
        run_check=False)
    return part.redistribute(mesh, (Replicate(),) * mesh.ndim)


def _check_row_sharded(x, what: str) -> None:
    if any(p.is_shard() and not p.is_shard(0) for p in x.placements) or any(
            p.is_partial() for p in x.placements):
        raise NotImplementedError(
            f"{what}: DTensor ids must be sharded on dim 0 or replicated, "
            f"got {x.placements}")


def segment_add(out: torch.Tensor, ids, vals):
    """``out.index_add_(0, ids, vals)`` for DTensor ``ids``/``vals``
    sharded on dim 0: each rank adds its own ids into a copy of ``out``,
    and the sums are all-reduced.  Returns a replicated DTensor."""
    _check_row_sharded(ids, "segment_add")
    if is_dtensor(vals):
        vals = vals.redistribute(ids.device_mesh, ids.placements).to_local()
    return _reduced(out.index_add_(0, ids.to_local().to(torch.int64), vals),
                    ids)


def segment_max(out: torch.Tensor, ids, vals):
    """``out.scatter_reduce_(0, ids, vals, "amax", include_self=True)``
    for DTensor ``ids``/``vals`` sharded on dim 0: each rank's maxima,
    then a max all-reduce.  Returns a replicated DTensor."""
    _check_row_sharded(ids, "segment_max")
    if is_dtensor(vals):
        vals = vals.redistribute(ids.device_mesh, ids.placements).to_local()
    local = out.scatter_reduce_(0, ids.to_local().to(torch.int64), vals,
                                "amax", include_self=True)
    return _reduced(local, ids, "max")


def bincount(x, minlength: int):
    """``torch.bincount(x, minlength=minlength)`` of a DTensor ``x``
    sharded on dim 0: local counts, then one all-reduce.  Every value
    must be below ``minlength`` (each rank's counts must have one
    length)."""
    _check_row_sharded(x, "bincount")
    local = torch.bincount(x.to_local(), minlength=minlength)
    if local.shape[0] != minlength:
        raise ValueError(f"sharded bincount needs values below "
                         f"minlength={minlength}")
    return _reduced(local, x)


def settle(tree):
    """Every DTensor leaf of ``tree`` (nested dicts, lists, tuples) with
    a partial placement reduced there (all-reduce), its shards kept: what
    an SPMD program returns."""
    from torch.distributed.tensor import Replicate

    if isinstance(tree, dict):
        return {k: settle(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(settle(v) for v in tree)
    if not is_dtensor(tree) or not any(p.is_partial()
                                       for p in tree.placements):
        return tree
    want = tuple(Replicate() if p.is_partial() else p
                 for p in tree.placements)
    return tree.redistribute(tree.device_mesh, want)


def local_op(fn, x):
    """``fn`` on each rank's shard of the DTensor ``x``, the result
    keeping ``x``'s placements: for an op that works on the dims ``x``
    holds whole (a pad of its whole spatial dims, say), where DTensor's
    own rule would redistribute."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False)


def rows_op(fn, x):
    """``fn(rows)`` for a DTensor ``x`` read as rows (dim 0) by the rest
    of its dims flattened, ``fn`` giving per-row averages (the row
    moments): each rank runs ``fn`` on its own shard's rows, a result row
    keeps ``x``'s split of dim 0, and a split of any other dim leaves a
    partial average (equal shards).  DTensor cannot place the flattening
    view of a tensor split on dims it merges."""
    from torch.distributed.tensor import DTensor, Partial

    local = x.to_local()
    outs = fn(local.reshape(local.shape[0], -1).contiguous())
    pls = tuple(p if p.is_replicate() or p.is_shard(0) else Partial("avg")
                for p in x.placements)
    return tuple(DTensor.from_local(o, x.device_mesh, pls, run_check=False)
                 for o in outs)


def row_ways(x) -> int:
    """How many ways a DTensor's dim 0 is split (1 when whole)."""
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(0):
            n *= x.device_mesh.size(i)
    return n


def gather_rows(x, index):
    """``x[index]`` for a DTensor ``x`` split on dim 0 only and a whole
    (plain or replicated) 1-D ``index``: each rank takes the indexed rows
    it holds and zeros for the rest, and one sum all-reduce gives every
    rank the result (each element has one nonzero term, so the sum is
    exact).  ``None`` for any other layout."""
    if (any(p.is_shard() and not p.is_shard(0) or p.is_partial()
            for p in x.placements)
            or is_dtensor(index) and not all(p.is_replicate()
                                             for p in index.placements)):
        return None
    idx = index.to_local() if is_dtensor(index) else index
    local = x.to_local()
    mesh, rows = x.device_mesh, local.shape[0]
    block = 0  # this rank's block of dim 0, left to right over mesh dims
    for i, p in enumerate(x.placements):
        if p.is_shard(0):
            block = block * mesh.size(i) + mesh.get_coordinate()[i]
    lo = block * rows
    mine = (idx >= lo) & (idx < lo + rows)
    picked = local[torch.where(mine, idx - lo, torch.zeros_like(idx))]
    keep = mine.reshape((-1,) + (1,) * (picked.ndim - 1))
    return _reduced(torch.where(keep, picked, torch.zeros_like(picked)), x)


class _SumOverRanks(torch.autograd.Function):
    """The sum of each rank's local ``t`` over the mesh dims that split
    ``like``'s dim 0 (one all-reduce); its gradient on each rank is the
    gradient of the sum itself (d sum / d local = 1)."""

    @staticmethod
    def forward(ctx, t, like):
        return _reduced(t, like).to_local()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def batch_sum(x, dims: Sequence[int]):
    """``torch.sum(x, dims, keepdim=True)`` of a DTensor ``x`` split only
    on its batch (dim 0, in ``dims``), whole on every rank: each rank sums
    its shard, one all-reduce adds them, and in the backward the
    statistic's gradient is made whole at its own size before it spreads
    over the batch (a partial gradient spread first would be
    reduce-scattered at the activations' size)."""
    from torch.distributed.tensor import DTensor, Replicate

    local = torch.sum(x.to_local(), dim=tuple(dims), keepdim=True)
    mesh = x.device_mesh
    return DTensor.from_local(_SumOverRanks.apply(local, x), mesh,
                              (Replicate(),) * mesh.ndim, run_check=False)


def replicated(x):
    """A DTensor ``x`` whole on every rank: partial sums all-reduced,
    shards all-gathered.  A plain tensor is returned as it is."""
    from torch.distributed.tensor import Replicate

    if not is_dtensor(x) or all(p.is_replicate() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim)


def replicate_dims(x, dims: Sequence[int]):
    """The DTensor ``x`` whole along ``dims``: each mesh dim that shards
    one of them is all-gathered, the rest stay."""
    from torch.distributed.tensor import Replicate

    dims = [d % x.ndim for d in dims]
    want = tuple(Replicate() if p.is_shard() and p.dim in dims else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def batch_conv(conv, x, w):
    """``conv(x, w)`` for a DTensor ``x`` (NCHW) and filter ``w``: ``x``
    keeps only its batch split (its other dims and the filter gathered
    whole), each rank convolves its own images, and the output keeps
    ``x``'s placements.  The filter's gradient on each rank covers its
    images only, so it leaves as a partial sum over the mesh dims that
    split the batch (all-reduced where a whole one is needed)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = (x if is_dtensor(x) else w).device_mesh
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                               run_check=False)
    x = replicate_dims(x, (1, 2, 3))
    w_local = (replicated(w).to_local(
        grad_placements=_partial_over(x.placements, 0))
        if is_dtensor(w) else w)
    out = conv(x.to_local(), w_local)
    return DTensor.from_local(out, mesh, x.placements, run_check=False)


def probe_sum(x, k: int) -> torch.Tensor:
    """``torch.sum(widen(x.reshape(-1)[:k]).to(torch.float32))`` for a
    DTensor ``x`` whose first ``k`` flat elements lie in the shard at
    coordinate 0 (sharded on dim 0 only, that shard holding ``k``
    elements): that rank sums them as the whole tensor would, every other
    rank adds zero, and one scalar all-reduce gives every rank the sum.
    Any other layout is gathered first."""
    local = x.to_local()
    row_sharded = all(p.is_replicate() or p.is_shard(0)
                      for p in x.placements)
    if not row_sharded or local.numel() < min(k, x.numel()):
        whole = x.full_tensor().reshape(-1)[:k]
        return torch.sum(widen(whole).to(torch.float32))
    coord = x.device_mesh.get_coordinate()
    mine = all(c == 0 for c, p in zip(coord, x.placements) if p.is_shard())
    s = torch.sum(widen(local.reshape(-1)[:k]).to(torch.float32))
    return _reduced(s if mine else torch.zeros_like(s), x)


# ---------------------------------------------------------------------------
# Sharding rules for ops DTensor has none for
# ---------------------------------------------------------------------------


def with_args(args: Sequence, placements: Sequence) -> list:
    """One rule's input placements laid over an op's positional
    arguments: the tensors (DTensor specs) take ``placements`` in order,
    every other argument ``None``."""
    it = iter(placements)
    return [next(it) if hasattr(a, "placements") else None for a in args]


@functools.lru_cache(maxsize=1)
def register_rules() -> None:
    """Register this module's sharding rules with DTensor (once a
    process)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten
    R = Replicate()

    @register_sharding(aten.searchsorted.Tensor)
    def _searchsorted(sorted_sequence, self, *args, **kwargs):
        # sorted rows shard with the queries' leading (row) dims; the
        # searched dim is whole
        rules = [([R], [R, R])]
        if sorted_sequence.ndim == 1:
            rules += [([Shard(d)], [R, Shard(d)]) for d in range(self.ndim)]
        else:
            rules += [([Shard(d)], [Shard(d), Shard(d)])
                      for d in range(sorted_sequence.ndim - 1)]
        return rules

    def pool(outs: int, args: Sequence, x) -> list:
        # batch and channel dims shard through a pool; the spatial dims
        # are whole (a window reads its neighbours)
        n = sum(hasattr(a, "placements") for a in args)
        return [([pl] * outs, with_args(args, [pl] * n))
                for pl in [R] + [Shard(d) for d in range(x.ndim - 2)]]

    @register_sharding(aten.max_pool2d_with_indices.default)
    def _max_pool(*args, **kwargs):
        return pool(2, args, args[0])

    @register_sharding(aten.max_pool2d_with_indices_backward.default)
    def _max_pool_back(*args, **kwargs):
        return pool(1, args, args[1])

    @register_sharding(aten.avg_pool2d.default)
    def _avg_pool(*args, **kwargs):
        return pool(1, args, args[0])

    @register_sharding(aten.avg_pool2d_backward.default)
    def _avg_pool_back(*args, **kwargs):
        return pool(1, args, args[1])

    from repro_torch.kernels import ops  # noqa: F401  (defines the ops)

    kernels = torch.ops.repro_torch

    @register_sharding(kernels.matmul.default)
    def _matmul(x, y):
        # aten.mm's rule
        return [([R], [R, R]), ([Shard(0)], [Shard(0), R]),
                ([Shard(1)], [R, Shard(1)]),
                ([Partial()], [Shard(1), Shard(0)])]

    @register_sharding(kernels.row_moments.default)
    def _row_moments(x):
        # a mean over the last dim (aten.mean's rule): the leading dims
        # shard, a sharded last dim leaves partial averages
        rules = [([R, R], [R]),
                 ([Partial("avg"), Partial("avg")], [Shard(x.ndim - 1)])]
        rules += [([Shard(d), Shard(d)], [Shard(d)])
                  for d in range(x.ndim - 1)]
        return rules

    @register_sharding(kernels.bitonic_sort_blocks.default)
    def _bitonic(x, block):
        # a sort of each block: whole blocks shard, a block split across
        # ranks cannot
        rules = [([R], [R, None])]
        n = x.shape[0]
        if n % (x.mesh.size() * int(block)) == 0:
            rules.append(([Shard(0)], [Shard(0), None]))
        return rules
