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
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.uint32 import widen


def contiguous_strides(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``, without making
    one (a profiled run would count it)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


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


def embedding(ids, table):
    """``F.embedding(ids, table)`` for a DTensor ``table`` split by rows
    (a vocab-sharded embedding): each rank looks up the ids that fall in
    its rows, zeros for the rest, and the result is a partial sum over
    the mesh dims that split the table, which the caller's placement
    reduces (the vocab-parallel lookup the reference's partitioner
    emits).  DTensor's own rule keeps a masked partial sum that a later
    cast or redistribution of the ids breaks.  ``ids`` is split as it
    is on the other mesh dims (a plain tensor is whole); the table's
    gradient is a partial sum over the mesh dims that split ``ids``."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    R = Replicate()
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [R] * mesh.ndim, run_check=False)
    coord = mesh.get_coordinate()
    rows, first = table.shape[0], 0
    ids_pl, out_pl, grad_pl = [], [], []
    for i, (pt, pi) in enumerate(zip(table.placements, ids.placements)):
        if pt == Shard(0):
            rows //= mesh.size(i)
            first += coord[i] * rows
            ids_pl.append(R), out_pl.append(Partial()), grad_pl.append(pt)
        elif pt.is_replicate() and pi.is_shard():
            ids_pl.append(pi), out_pl.append(pi), grad_pl.append(Partial())
        else:
            ids_pl.append(R), out_pl.append(R), grad_pl.append(pt)
    ids = ids.redistribute(mesh, ids_pl)
    local = ids.to_local() - first
    hit = (local >= 0) & (local < rows)
    out = F.embedding(torch.where(hit, local, 0),
                      table.to_local(grad_placements=grad_pl))
    out = torch.where(hit[..., None], out, 0)
    shape = tuple(ids.shape) + (table.shape[1],)
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def index_copy_(dst, dim: int, index, src):
    """``dst.index_copy_(dim, index, src)``, also on a DTensor ``dst``
    split along ``dim`` (a decode cache split by position), where
    DTensor's own rule leaves ``dst`` misplaced: each rank writes the
    rows of ``index`` that fall in its part and keeps the rest, reading
    nothing back to the host.  ``src`` is placed as ``dst`` is on the
    other mesh dims (a plain ``src`` is whole)."""
    if not is_dtensor(dst):
        return dst.index_copy_(dim, index, src)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = dst.device_mesh
    R = Replicate()
    want = [R if p == Shard(dim) else p for p in dst.placements]
    if not is_dtensor(src):
        src = DTensor.from_local(src, mesh, [R] * mesh.ndim, run_check=False)
    src = src.redistribute(mesh, want).to_local()
    coord = mesh.get_coordinate()
    rows, first = dst.shape[dim], 0
    for i, p in enumerate(dst.placements):
        if p == Shard(dim):
            rows //= mesh.size(i)
            first += coord[i] * rows
    idx = index.to_local() if is_dtensor(index) else index
    local = dst.to_local()
    at = torch.clamp(idx - first, 0, rows - 1)
    mine = ((idx >= first) & (idx < first + rows)).reshape(
        [-1 if d == dim else 1 for d in range(local.ndim)])
    local.index_copy_(dim, at, torch.where(mine, src,
                                           local.index_select(dim, at)))
    return dst


def group_local(fn, *args):
    """``fn`` on each rank's share of independent groups: ``fn`` takes
    and returns tensors whose dim 0 is a group dim, and works on each
    group alone (the MoE layer's sort dispatch and ordered combine).
    Every DTensor argument is placed with its groups split as the first
    one's are (``Shard(0)`` on the mesh dims where any argument splits
    dim 0, whole on the others: the reference's partitioner keeps a
    group on one device), ``fn`` runs on the local groups, and each
    tensor it returns is a DTensor split the same way.  Gradients flow
    through the local call."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dts = [a for a in args if is_dtensor(a)]
    mesh = dts[0].device_mesh
    pl = tuple(Shard(0) if any(t.placements[i] == Shard(0) for t in dts)
               else Replicate() for i in range(mesh.ndim))
    ways = 1
    for i, p in enumerate(pl):
        if p.is_shard():
            ways *= mesh.size(i)
    local = [a.redistribute(mesh, pl).to_local() if is_dtensor(a) else a
             for a in args]

    def wrap(t):
        if not isinstance(t, torch.Tensor):
            return t
        shape = (t.shape[0] * ways,) + tuple(t.shape[1:])
        return DTensor.from_local(
            t, mesh, pl, run_check=False, shape=torch.Size(shape),
            stride=contiguous_strides(shape))

    out = fn(*local)
    return tuple(wrap(t) for t in out) if isinstance(out, tuple) \
        else wrap(out)


class _AsGradient(torch.autograd.Function):
    """A DTensor seen in ``placements`` (a local slice of a replicated
    dim, no collective), whose gradient passes back in the layout it
    comes in, not redistributed to the input's."""

    @staticmethod
    def forward(ctx, w, placements):
        return w.redistribute(w.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ExpertMatmul(torch.autograd.Function):
    """``x @ w`` of (..., E, C, a) inputs and (E, a, b) expert weights,
    the weight's gradient taken only on ``part``, its rows ``lo:hi`` of
    dim ``dim`` (a tensor of that slice's shape)."""

    @staticmethod
    def forward(ctx, x, w, part, dim, lo, hi):
        ctx.save_for_backward(x, w)
        ctx.cut = (dim, lo, hi - lo)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dim, lo, n = ctx.cut
        dx = g @ w.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[2]:
            if dim == 0:
                x, g = x.narrow(-3, lo, n), g.narrow(-3, lo, n)
            elif dim == 1:
                x = x.narrow(-1, lo, n)
            else:
                g = g.narrow(-1, lo, n)
            dw = x.transpose(-1, -2) @ g
            if dw.ndim > 3:
                dw = dw.sum(tuple(range(dw.ndim - 3)))
        return dx, None, dw, None, None, None


def local_experts(fn, x, *weights):
    """``fn(x, *maps)`` on each rank's groups and experts: ``x`` is
    (..., E, C, d), split as it is placed (its last dim whole), and each
    weight is (E, a, b), split over E on the mesh dims that split ``x``'s
    E and whole on the others, and reaches ``fn`` as its linear map
    ``t -> t @ w`` on the local shards; ``fn`` returns a (..., E, C, n)
    result placed as ``x``.  DTensor's own batched matmul would fold the
    split group and expert dims together and gather one of them.

    A weight's gradient is a partial sum over the mesh dims that split
    ``x``'s other dims (each rank saw its own groups).  On a mesh dim
    where ``x`` is whole (groups that do not divide the data axis), every
    rank would compute the same gradient: as the reference's partitioner
    does, each computes only the part the optimizer state keeps on it
    (the ZeRO-1 rule, ``sharding.zero_entries``, on the weight as the
    product places it), and the gradient is placed split there."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import (Sharding, active_rules,
                                                  entries_to_placements,
                                                  zero_entries)

    mesh = x.device_mesh
    e_dim = x.ndim - 3
    coord = mesh.get_coordinate()
    wp = tuple(Shard(0) if p == Shard(e_dim) else Replicate()
               for p in x.placements)

    def linear_map(w):
        zero = entries_to_placements(zero_entries(
            w.shape, Sharding(mesh, wp).spec(w.ndim), mesh, active_rules()),
            mesh)
        gp = tuple(Shard(0) if p == Shard(e_dim)
                   else Partial() if p.is_shard()
                   else z if z.is_shard() and mesh.size(i) > 1
                   else Replicate()
                   for i, (p, z) in enumerate(zip(x.placements, zero)))
        # this rank's part: the mesh dims the rule adds split one dim of
        # the weight, in mesh order (DTensor's nesting)
        cut = [(i, g.dim) for i, (g, p) in enumerate(zip(gp, wp))
               if g.is_shard() and g != p]
        if len({d for _, d in cut}) > 1:
            raise NotImplementedError(
                f"the ZeRO rule splits more than one dim of an expert "
                f"weight: {gp}")
        if cut:
            whole_w = w.redistribute(mesh, wp).to_local().detach()
            view = tuple(Replicate() if g.is_partial() else g for g in gp)
            part = _AsGradient.apply(w, view).to_local(grad_placements=gp)
        else:  # the gradient is the whole local slice's, placed back as w
            part = w.redistribute(mesh, wp).to_local(grad_placements=gp)
            whole_w = part.detach()
        dim = cut[0][1] if cut else 0
        lo, n = 0, whole_w.shape[dim]
        for i, _ in cut:
            n //= mesh.size(i)
            lo += coord[i] * n
        return lambda t: _ExpertMatmul.apply(t, whole_w, part, dim, lo,
                                             lo + n)

    out = fn(x.to_local(), *(linear_map(w) for w in weights))
    shape = tuple(x.shape[:-1]) + (out.shape[-1],)
    return DTensor.from_local(
        out, mesh, x.placements, run_check=False, shape=torch.Size(shape),
        stride=contiguous_strides(shape))


# ---------------------------------------------------------------------------
# Replication where DTensor has no placement
# ---------------------------------------------------------------------------

#: (op name, input placements) -> count: the ops that
#: :class:`ReplicateUnplaceable` ran replicated (process-global, as
#: ``sharding.dropped_shardings`` is)
_REPLICATED: dict = {}

_UNPLACEABLE = ("Sharding propagation failed",
                "does not have a sharding strategy")


def replicated_ops() -> dict:
    """``{"op(placements)": count}`` of the ops run replicated since the
    last :func:`clear_replicated`."""
    return dict(_REPLICATED)


def clear_replicated() -> None:
    _REPLICATED.clear()


class ReplicateUnplaceable(TorchDispatchMode):
    """Run an op that DTensor cannot place on its operands made whole.

    DTensor refuses an op its sharding rules do not cover (a view that
    splits a sharded dim unevenly, an op with no rule), where the
    reference's SPMD partitioner would gather the operand and go on.
    This mode does that: when DTensor's sharding propagation fails, every
    DTensor operand is redistributed to ``Replicate`` on its mesh (an
    all-gather, or an all-reduce of a partial sum), the op runs again and
    its result is replicated.  The answer is the op's on the whole
    tensors, so the numbers stay exact; the cost is counted where it
    falls (the collectives and the whole-tensor op).  Each such op is
    recorded in :func:`replicated_ops`.  An op that writes an operand in
    place is not replicated (its result would land in a copy): it raises
    as DTensor raised.

    It must be the innermost mode (entered last): it hands each DTensor
    op on to the modes beneath it and to DTensor, and catches only the
    propagation failure, raised before any local op runs."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(t.__name__ == "DTensor" for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as exc:
            if (not any(m in str(exc) for m in _UNPLACEABLE)
                    or func._schema.is_mutable):
                raise
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_leaves, tree_map_only

        def whole(t):
            return t.redistribute(t.device_mesh,
                                  [Replicate()] * t.device_mesh.ndim)

        key = (f"{func.overloadpacket.__name__}("
               + ", ".join("".join(str(p) for p in t.placements)
                           for t in tree_leaves((args, kwargs))
                           if isinstance(t, DTensor)) + ")")
        _REPLICATED[key] = _REPLICATED.get(key, 0) + 1
        args, kwargs = tree_map_only(DTensor, whole, (args, kwargs))
        return func(*args, **kwargs)
