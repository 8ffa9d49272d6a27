"""Performance-signature extraction (port of ``repro/core/signature.py``).

The reference parses the optimised HLO of a compiled program.  PyTorch
runs eagerly, so the port profiles the ATen ops of one execution of the
same function — input generation plus the weighted motifs — with a
``TorchDispatchMode``, and classifies each op into the reference's op
classes (``classify_opcode``): dot, conv, elementwise, logic, reduce,
sort, data_movement, control, collective.

* flops: ``torch.utils.flop_counter``'s formulas for the matrix products
  and convolutions, one per output element for elementwise and logic
  ops, ``max(input bytes / 4, outputs)`` for reductions (the reference's
  rule); transcendentals count one per output element.  A backward
  convolution (``convolution_backward``) is conv, with the flop counter's
  formula; pools and their backwards are reduce (the reference's
  reduce-window and select-and-scatter); ``_fft_r2c`` stays other, the
  class the reference gives ``fft``.
* bytes: inputs plus outputs of every op that is not a view; views cost
  nothing and slices cost the slice, read and written
  (``_VIEW_OPS``/``_SLICE_OPS``); control ops (random draws,
  allocations, host reads) cost nothing, as the reference's ``rng``.
* op mix: output bytes per class, views excluded.
* collectives: each functional collective (``_c10d_functional``, what
  DTensor and the port's explicit collectives issue) is keyed by the
  reference's HLO kind (:data:`COLLECTIVE_KINDS`: ``all_reduce`` is
  ``all-reduce``, ``all_gather_into_tensor`` ``all-gather``, ...) with
  its operand's bytes; ``wait_tensor`` and ``_wrap_tensor_autograd``
  are control with no bytes, and an unmapped one raises.
* each hand-written kernel is one custom op with its own class and
  formula: ``repro_torch::matmul`` is dot with 2·M·N·K flops,
  ``repro_torch::row_moments`` reduce, ``repro_torch::bitonic_sort_blocks``
  sort, ``repro_torch::rmsnorm`` reduce (the fused norm's reduction, the
  reduce rule's flops), ``repro_torch::flash_attention`` dot with 4·D
  flops per (query, key) pair the mask keeps, ``repro_torch::moe_dispatch``
  dot with 2·T·E·C·D flops.
* peak memory: the CUDA allocator's peak over the profiled run, less what
  was allocated before it, plus the arguments (0.0 on the CPU).

Wall time (the paper's runtime metric) is taken apart from the profile.
The reference times one compiled executable; the port's counterpart on
CUDA is one captured CUDA graph (:func:`timed_wall`): eager warm-up runs
on a side stream, one capture, then the median of ``iters`` replays,
each followed by a synchronise, so no per-op host launch is timed.  The
function's generators come from a :class:`~repro_torch.data.generators.
GeneratorSupply` registered with the graph.  A function that cannot be
captured (it reads a tensor back to the host, as ``bincount`` does to
size its output) is timed eagerly instead, and ``Signature.timing`` says
so and why; on the CPU, which has no graphs, timing is always eager.

``Signature`` and the ``vector()`` key names are the reference's;
``timing`` is the port's own.
"""
from __future__ import annotations

import copy
import functools
import sys
import threading
import time
import traceback
import weakref
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils.flop_counter as _flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from repro_torch.data.generators import GeneratorSupply
from repro_torch.device import synchronize
from repro_torch.distributed.sharding import current_mesh
from repro_torch.kernels.flash_attention import flops as _flash_flops

# ---------------------------------------------------------------------------
# ATen op classification (the reference's classify_opcode taxonomy)
# ---------------------------------------------------------------------------

_DOT = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "addmv", "mv", "dot",
        "vdot", "matmul"}
# convolution_backward: a backward convolution (two products), flops by
# torch.utils.flop_counter's formula as convolution's
_CONV = {"convolution", "_convolution", "cudnn_convolution",
         "convolution_overrideable", "convolution_backward"}
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "pow", "exp",
    "log", "tanh", "rsqrt", "sqrt", "neg", "abs", "sign", "eq", "ne", "lt",
    "le", "gt", "ge", "where", "clamp", "clamp_min", "clamp_max", "clip",
    "floor", "ceil", "round", "trunc", "_to_copy", "expm1", "log1p",
    "sigmoid", "cos", "sin", "atan2", "remainder", "fmod", "isfinite",
    "relu", "square", "reciprocal", "exp2", "log2", "erf", "masked_fill",
    "lerp", "addcmul", "addcdiv", "threshold", "hardtanh", "gelu", "silu",
    "threshold_backward",  # relu's backward
}
_LOGIC = {
    "bitwise_xor", "bitwise_and", "bitwise_or", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift", "logical_and",
    "logical_or", "logical_not", "logical_xor", "__xor__", "__and__",
    "__or__", "__lshift__", "__rshift__",
}
_REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "var", "std", "var_mean", "std_mean", "cumsum", "cumprod", "logsumexp",
    "_softmax", "_log_softmax", "linalg_vector_norm", "norm", "aminmax",
    "any", "all", "bincount", "count_nonzero", "row_moments",
    # pooling: the reference's reduce-window and, backward,
    # select-and-scatter
    "max_pool2d_with_indices", "max_pool2d_with_indices_backward",
    "avg_pool2d", "avg_pool2d_backward",
    "_softmax_backward_data", "_log_softmax_backward_data",
}
_SORT = {"sort", "argsort", "topk", "msort", "kthvalue",
         "bitonic_sort_blocks"}
_DATA_MOVEMENT = {
    "cat", "stack", "clone", "copy", "copy_", "index", "index_select",
    "gather", "scatter", "scatter_", "scatter_add", "scatter_add_",
    "index_add", "index_add_", "index_put", "index_put_", "constant_pad_nd",
    "flip", "roll", "repeat", "zeros", "ones", "full", "zeros_like",
    "ones_like", "full_like", "new_zeros", "new_ones", "new_full", "fill",
    "fill_", "zero_", "searchsorted", "embedding", "take", "take_along_dim",
    "masked_select", "tril", "triu", "slice", "select",
    "scatter_reduce", "scatter_reduce_",  # segment_max
    "slice_backward",  # a slice's backward: zeros with the slice copied in
}
# views alias their input: no bytes move (iota/arange is the reference's
# zero-traffic iota)
_VIEW_OPS = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "permute", "transpose", "t", "unsqueeze", "squeeze",
    "alias", "as_strided", "detach", "unfold", "view_as", "movedim",
    "unbind", "split", "split_with_sizes", "chunk", "narrow", "diagonal",
    "arange",
}
# slices cost the slice (read and written), not the sliced operand
_SLICE_OPS = {"slice", "select"}
_CONTROL = {
    "rand", "randn", "randint", "bernoulli", "uniform", "normal", "random",
    "rand_like", "randn_like", "randint_like", "randperm", "multinomial",
    "exponential", "empty", "empty_like", "empty_strided", "new_empty",
    "lift_fresh", "lift_fresh_copy", "_local_scalar_dense", "resize_",
    "set_", "record_stream", "scalar_tensor",
}
_TRANSCENDENTAL = {
    "exp", "log", "tanh", "rsqrt", "sqrt", "pow", "sigmoid", "cos", "sin",
    "atan2", "expm1", "log1p", "exp2", "log2", "erf", "_softmax",
    "_log_softmax", "linalg_vector_norm",
}
#: functional collectives (``_c10d_functional`` and its autograd twin)
#: -> the reference's HLO collective kind; bytes are the operand's
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast", "broadcast_": "collective-broadcast",
}
#: functional-collective bookkeeping: waits and autograd wrappers move no
#: bytes (control)
COLLECTIVE_CONTROL = {"wait_tensor", "_wrap_tensor_autograd"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")


def collective_kind(func) -> Optional[str]:
    """The reference's kind of a functional collective op, ``None`` for
    its bookkeeping ops (:data:`COLLECTIVE_CONTROL`).  An op of those
    namespaces in neither table raises: a new collective must be mapped,
    not counted as "other"."""
    name = func.overloadpacket.__name__
    if name in COLLECTIVE_CONTROL:
        return None
    if name not in COLLECTIVE_KINDS:
        raise ValueError(f"unmapped collective {func.namespace}::{name}: "
                         f"add it to signature.COLLECTIVE_KINDS")
    return COLLECTIVE_KINDS[name]


#: the port's hand-written kernels, as the custom ops a profile sees
KERNEL_OPS = {"matmul": "dot", "row_moments": "reduce",
              "bitonic_sort_blocks": "sort", "rmsnorm": "reduce",
              "flash_attention": "dot", "moe_dispatch": "dot"}


def classify_op(func) -> str:
    """Op class of one ATen (or ``repro_torch``) op overload."""
    name = func.overloadpacket.__name__
    if func.namespace == "repro_torch":
        return KERNEL_OPS.get(name, "other")
    if func.namespace in _COLLECTIVE_NAMESPACES:
        return "control" if collective_kind(func) is None else "collective"
    if name in ("max", "min") and func._overloadname == "other":
        return "elementwise"  # the binary form is maximum/minimum
    for cls, names in (("dot", _DOT), ("conv", _CONV),
                       ("logic", _LOGIC), ("elementwise", _ELEMENTWISE),
                       ("reduce", _REDUCE), ("sort", _SORT),
                       ("data_movement", _DATA_MOVEMENT),
                       ("data_movement", _VIEW_OPS),
                       ("control", _CONTROL)):
        if name in names:
            return cls
    return "other"


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _dot_flops(func, args, kwargs, out) -> float:
    if func.namespace == "repro_torch":
        name = func.overloadpacket.__name__
        if name == "flash_attention":  # q, k, v, causal
            return _flash_flops(args[0], args[1], args[3])
        if name == "moe_dispatch":  # mask (T,E,C), x (T,D)
            (t, e, c), d = args[0].shape, args[1].shape[1]
            return 2.0 * t * e * c * d
        (m, k), n = args[0].shape, args[1].shape[1]  # matmul (M,K) @ (K,N)
        return 2.0 * m * n * k
    formula = _flop_counter.flop_registry.get(func.overloadpacket)
    if formula is not None:
        return float(formula(*args, **kwargs, out_val=out))
    first = _tensors(args)
    return 2.0 * first[0].numel() if first else 0.0


@dataclass
class ProfileStats:
    """Totals of one profiled execution."""

    flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    op_bytes: Dict[str, float] = field(default_factory=dict)
    op_counts: Dict[str, int] = field(default_factory=dict)
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    #: collective bytes by kind and the operand's dtype and local shape
    collective_operands: Dict[str, float] = field(default_factory=dict)
    dot_flops: float = 0.0
    conv_flops: float = 0.0

    def record(self, func, args, kwargs, out) -> None:
        cls = classify_op(func)
        name = func.overloadpacket.__name__
        outs = _tensors(out)
        out_bytes = _nbytes(outs)
        out_elems = sum(t.numel() for t in outs)
        in_bytes = _nbytes(_tensors((args, kwargs)))
        self.op_counts[cls] = self.op_counts.get(cls, 0) + 1
        if name in _VIEW_OPS or cls == "control":
            return  # aliases and bookkeeping: no bytes move
        self.op_bytes[cls] = self.op_bytes.get(cls, 0.0) + out_bytes
        if name in _SLICE_OPS:
            self.bytes += 2 * out_bytes
        else:
            self.bytes += in_bytes + out_bytes

        if cls in ("elementwise", "logic"):
            self.flops += out_elems
        elif cls == "reduce":
            self.flops += max(in_bytes // 4, out_elems)
        elif cls == "dot":
            f = _dot_flops(func, args, kwargs, out)
            self.dot_flops += f
            self.flops += f
        elif cls == "conv":
            formula = _flop_counter.flop_registry[func.overloadpacket]
            f = float(formula(*args, **kwargs, out_val=out))
            self.conv_flops += f
            self.flops += f
        elif cls == "collective":
            kind = collective_kind(func)
            n = in_bytes or out_bytes
            self.collective_bytes[kind] = (
                self.collective_bytes.get(kind, 0.0) + n)
            t = (_tensors((args, kwargs)) or outs)[0]
            key = f"{kind} {str(t.dtype)[6:]}{list(t.shape)}"
            self.collective_operands[key] = (
                self.collective_operands.get(key, 0.0) + n)
        if name in _TRANSCENDENTAL:
            self.transcendentals += out_elems


_SHAPE_INFERENCE = threading.local()


def _mark_shape_inference() -> None:
    """Mark the ops DTensor runs to infer an op's output shape.

    DTensor derives each op's global output shape by running the op once
    on fake tensors of the global shapes (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``, under a fake mode that sits
    beneath every user mode).  Those runs are not the rank's work, so
    the method is wrapped, once a process, to flag its thread while it
    runs, and :class:`_Profiler` does not record what it dispatches
    then.  A torch without that method is left as it is."""
    mod = sys.modules.get("torch.distributed.tensor._sharding_prop")
    if mod is None:
        return
    cls = mod.ShardingPropagator
    fn = cls.__dict__.get("_propagate_tensor_meta_non_cached")
    if fn is None or getattr(fn, "_marks_shape_inference", False):
        return

    @functools.wraps(fn)
    def marked(self, *args, **kwargs):
        _SHAPE_INFERENCE.depth = getattr(_SHAPE_INFERENCE, "depth", 0) + 1
        try:
            return fn(self, *args, **kwargs)
        finally:
            _SHAPE_INFERENCE.depth -= 1

    marked._marks_shape_inference = True
    cls._propagate_tensor_meta_non_cached = marked


class LiveBytes:
    """The peak of one rank's live bytes in a run with no allocator to
    read (meta tensors), counted through storage lifetimes.

    :meth:`hold` counts a tensor's storage once, at its full size, when
    it is first seen (an op's output, or an argument held before the
    run), and a weak reference to the storage takes its bytes off when
    the storage is freed: when the last tensor on it dies, including
    those autograd saved for the backward pass.  A view or an in-place
    op's output shares a counted storage and adds nothing.  ``peak`` is
    the most that was live at once: the arguments, everything the run
    held at that point, and its outputs if they were alive at the end.
    A caching allocator's rounding and fragmentation are not counted."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self.window = 0  # the peak since ``window`` was last set
        self._refs: Dict[int, Any] = {}
        # reentrant: a storage may be freed, and its callback run, on
        # this thread while :meth:`hold` holds the lock
        self._lock = threading.RLock()

    def hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._refs:
                return
            n = st.nbytes()

            def freed(_ref, key=key, n=n):
                with self._lock:
                    if self._refs.pop(key, None) is not None:
                        self.live -= n

            self._refs[key] = weakref.ref(st, freed)
            self.live += n
            self.peak = max(self.peak, self.live)
            self.window = max(self.window, self.live)


class _Profiler(TorchDispatchMode):
    """Records every op one run dispatches.  An op on DTensors is handed
    back to the DTensor subclass first (``NotImplemented``), which runs
    it as local ops and collectives that come back here: the profile is
    one rank's, as the reference's is one device's SPMD program.  The ops
    DTensor runs to infer shapes are not recorded
    (:func:`_mark_shape_inference`)."""

    def __init__(self, live: Optional[LiveBytes] = None):
        super().__init__()
        self.stats = ProfileStats()
        self.live = live
        self.muted = 0  # > 0: dispatched ops are not the run's work
        _mark_shape_inference()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # a profiler range (a live telemetry span while torch's profiler
        # records) is not the run's work
        if (getattr(_SHAPE_INFERENCE, "depth", 0) or self.muted
                or func.namespace == "profiler"):
            return out
        if self.live is not None:
            for t in _tensors(out):
                self.live.hold(t)
        self.stats.record(func, args, kwargs, out)
        return out


# ---------------------------------------------------------------------------
# Signature
# ---------------------------------------------------------------------------

@dataclass
class Signature:
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    peak_memory: float = 0.0
    op_mix: Dict[str, float] = field(default_factory=dict)      # byte fractions
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    dot_flops: float = 0.0
    conv_flops: float = 0.0
    wall_time: Optional[float] = None
    raw_cost: Dict[str, float] = field(default_factory=dict)
    #: how ``wall_time`` was taken: ``{"mode": "graph"}`` (a captured CUDA
    #: graph's replays) or ``{"mode": "eager", "reason": ...}``; empty
    #: without a wall time
    timing: Dict[str, str] = field(default_factory=dict)

    @property
    def arith_intensity(self) -> float:
        return self.flops / max(self.bytes, 1.0)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def vector(self) -> Dict[str, float]:
        """The named metric vector M (paper §II-B2)."""
        mix_total = sum(v for k, v in self.op_mix.items()
                        if k not in ("control", "collective")) or 1.0

        def mix(k):
            return self.op_mix.get(k, 0.0) / mix_total

        v = {
            "flops": self.flops,
            "bytes": self.bytes,
            "transcendentals": self.transcendentals,
            "arith_intensity": self.arith_intensity,
            "mix_dot": mix("dot"),
            "mix_conv": mix("conv"),
            "mix_elementwise": mix("elementwise"),
            "mix_logic": mix("logic"),
            "mix_reduce": mix("reduce"),
            "mix_data_movement": mix("data_movement"),
            "mix_sort": mix("sort"),
            "coll_all_reduce": self.collective_bytes.get("all-reduce", 0.0),
            "coll_all_gather": self.collective_bytes.get("all-gather", 0.0),
            "coll_reduce_scatter": self.collective_bytes.get("reduce-scatter", 0.0),
            "coll_all_to_all": self.collective_bytes.get("all-to-all", 0.0),
            "coll_permute": self.collective_bytes.get("collective-permute", 0.0),
            "peak_memory": self.peak_memory,
        }
        if self.wall_time is not None:
            v["wall_time"] = self.wall_time
        return v


def _device_of(args) -> torch.device:
    ts = _tensors(args)
    return ts[0].device if ts else torch.device("cpu")


_PEAK_LOCK = threading.Lock()


def profile_call(fn: Callable, *args,
                 device: Optional[torch.device] = None) -> Signature:
    """Run ``fn(*args)`` once under the op profiler; its signature without
    wall time.  ``device`` defaults to the first tensor argument's.  The
    profiler is per thread; on CUDA a lock keeps profiles from several
    threads apart, since the allocator's peak counts the whole device."""
    device = device or _device_of(args)
    if device.type == "cuda":
        # the allocator's peak is the device's: one profile at a time
        with _PEAK_LOCK:
            synchronize(device)
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            with _Profiler() as prof:
                fn(*args)
            synchronize(device)
            peak = float(torch.cuda.max_memory_allocated(device) - before
                         + _nbytes(_tensors(args)))
    else:
        with _Profiler() as prof:
            fn(*args)
        peak = 0.0
    st = prof.stats
    return Signature(
        flops=st.flops, bytes=st.bytes, transcendentals=st.transcendentals,
        peak_memory=peak, op_mix=dict(st.op_bytes),
        collective_bytes=dict(st.collective_bytes), dot_flops=st.dot_flops,
        conv_flops=st.conv_flops,
        raw_cost={f"ops_{k}": float(v) for k, v in st.op_counts.items()})


@dataclass
class MemoryAnalysis:
    """One rank's memory in a shape-only run (:func:`profile_abstract`),
    under the reference's ``memory_analysis()`` names: ``peak`` equals
    ``argument + output - alias + temp``."""

    argument_size_in_bytes: int = 0
    output_size_in_bytes: int = 0
    alias_size_in_bytes: int = 0    # outputs written into arguments
    temp_size_in_bytes: int = 0     # the rest of the peak
    peak_bytes: int = 0


def _storages(tree) -> Dict[int, int]:
    """``{storage key: bytes}`` of the plain tensors of ``tree``, a
    DTensor counted by its local shard."""
    out = {}
    for t in _tensors(tree):
        t = getattr(t, "_local_tensor", t)
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


class _ShapeMemo:
    """Profile a pure function once per shape in a meta run.

    On meta tensors a pure function's op stream depends only on its
    arguments' shapes, dtypes and strides and its other arguments, and
    yields no data.  The first call with a given key runs and its share
    of ``prof``'s profile is kept: the stats, and the peak of live bytes
    it reached above the bytes live at its start.  A later call with the
    same key adds that share and returns empty meta tensors of the
    outputs' shapes, counting their bytes as live.  A call with any
    other tensor (real, or a DTensor) runs the function.  The cache lives
    as long as the run."""

    def __init__(self, prof: "_Profiler"):
        self.prof = prof
        self.cache: Dict[Any, Any] = {}

    def wrap(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            flat, spec = tree_flatten((args, kwargs))
            ts = [x for x in flat if isinstance(x, torch.Tensor)]
            if not ts or not all(type(t) is torch.Tensor and t.is_meta
                                 for t in ts):
                return fn(*args, **kwargs)
            key = (fn, str(spec), tuple(
                (tuple(x.shape), x.dtype, x.stride())
                if isinstance(x, torch.Tensor) else ("v", repr(x))
                for x in flat))
            hit = self.cache.get(key)
            if hit is None:
                self.cache[key], out = self._first(fn, args, kwargs)
                return out
            return self._again(*hit)

        return wrapped

    def _first(self, fn, args, kwargs):
        prof, live = self.prof, self.prof.live
        before = copy.deepcopy(prof.stats)
        start = live.live
        live.window = start
        out = fn(*args, **kwargs)
        leaves, ospec = tree_flatten(out)
        shapes = [(tuple(t.shape), t.stride(), t.dtype)
                  if isinstance(t, torch.Tensor) else ("v", t)
                  for t in leaves]
        return (_stats_delta(prof.stats, before), live.window - start,
                shapes, ospec), out

    def _again(self, delta, inner, shapes, ospec):
        prof, live = self.prof, self.prof.live
        for k, v in delta.items():
            if isinstance(v, dict):
                d = getattr(prof.stats, k)
                for n, x in v.items():
                    d[n] = d.get(n, 0) + x
            else:
                setattr(prof.stats, k, getattr(prof.stats, k) + v)
        live.peak = max(live.peak, live.live + inner)
        prof.muted += 1
        try:
            leaves = [torch.empty_strided(s[0], s[1], dtype=s[2],
                                          device="meta")
                      if s[0] != "v" else s[1] for s in shapes]
        finally:
            prof.muted -= 1
        for t in leaves:
            if isinstance(t, torch.Tensor):
                live.hold(t)
        return tree_unflatten(leaves, ospec)


def _stats_delta(after: ProfileStats, before: ProfileStats
                 ) -> Dict[str, Any]:
    out = {}
    for k, v in vars(after).items():
        b = getattr(before, k)
        if isinstance(v, dict):
            out[k] = {n: x - b.get(n, 0) for n, x in v.items()
                      if x != b.get(n, 0)}
        else:
            out[k] = v - b
    return out


def profile_abstract(fn: Callable, *args,
                     memo: Sequence[Tuple[Any, str]] = ()
                     ) -> Tuple[Signature, MemoryAnalysis]:
    """The signature of one dispatch of ``fn(*args)`` over shape-only
    tensors (meta tensors; DTensors of them for a rank of a fake world):
    the eager counterpart of compiling a program for its cost analysis.
    Nothing is computed and no memory is allocated; the op profile is
    the rank's, as on real tensors, with ops DTensor cannot place run
    replicated (``spmd.ReplicateUnplaceable``).  With no allocator to
    read, ``peak_memory`` is :class:`LiveBytes`'s peak over the run,
    the arguments included; ``raw_cost`` also holds the collective bytes
    by kind and operand (``"collective all-reduce float32[16, 4096]"``).
    Each ``(owner, name)`` of ``memo`` names a pure function,
    ``getattr(owner, name)``, that the run profiles once per shape
    (:class:`_ShapeMemo`): it is replaced for the run only."""
    from repro_torch.distributed.spmd import ReplicateUnplaceable

    live = LiveBytes()
    for t in _tensors(args):
        live.hold(getattr(t, "_local_tensor", t))
    held = _storages(args)
    prof = _Profiler(live)
    shapes = _ShapeMemo(prof)
    saved = [(owner, name, getattr(owner, name)) for owner, name in memo]
    try:
        for owner, name, fn_ in saved:
            setattr(owner, name, shapes.wrap(fn_))
        with prof, ReplicateUnplaceable():
            out = fn(*args)
    finally:
        for owner, name, fn_ in saved:
            setattr(owner, name, fn_)
    outs = _storages(out)
    arg_b = sum(held.values())
    out_b = sum(outs.values())
    alias = sum(n for k, n in outs.items() if k in held)
    mem = MemoryAnalysis(
        argument_size_in_bytes=arg_b, output_size_in_bytes=out_b,
        alias_size_in_bytes=alias,
        temp_size_in_bytes=max(live.peak - arg_b - out_b + alias, 0),
        peak_bytes=live.peak)
    del out
    st = prof.stats
    sig = Signature(
        flops=st.flops, bytes=st.bytes, transcendentals=st.transcendentals,
        peak_memory=float(live.peak), op_mix=dict(st.op_bytes),
        collective_bytes=dict(st.collective_bytes), dot_flops=st.dot_flops,
        conv_flops=st.conv_flops,
        raw_cost={**{f"ops_{k}": float(v) for k, v in st.op_counts.items()},
                  **{f"collective {k}": v
                     for k, v in st.collective_operands.items()}})
    return sig, mem


def measure_wall_time(fn: Callable[[], Any], warmup: int = 2, iters: int = 5,
                      device: Optional[torch.device] = None) -> float:
    """Median wall-clock seconds of fn(), synchronising ``device``."""
    device = device or torch.device("cpu")
    for _ in range(warmup):
        fn()
    synchronize(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


class NotCaptured(RuntimeError):
    """A function could not be captured as a CUDA graph."""


#: this package's source tree: where a failed capture's reason points
_PACKAGE = Path(__file__).resolve().parents[1]


def where_raised(exc: BaseException) -> str:
    """The innermost frame of this package in ``exc``'s traceback, as
    ``file:line (function)``: the call that broke the capture."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if Path(f.filename).resolve().is_relative_to(_PACKAGE)]
    if not frames:
        return "outside the package"
    f = frames[-1]
    rel = Path(f.filename).resolve().relative_to(_PACKAGE.parent)
    return f"{rel}:{f.lineno} ({f.name})"


def _abandon_capture(graph, device: torch.device) -> None:
    """After a failed capture: stop routing this thread's allocations to
    the graph's pool (``capture_end`` raised before it could), then free
    the graph, whose ``reset`` releases the pool, so a later capture in
    this process starts clean.  The first call is a PyTorch internal, so
    it is best effort; releasing the pool by hand as well would release
    it twice."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    if end is not None:
        try:
            end(index, graph.pool())
        except (RuntimeError, TypeError):
            pass  # capture_end had ended it, or another signature
    _free_graph(graph)


def _free_graph(graph) -> None:
    """Free ``graph`` and give its memory pool back to the device.  A
    reset only marks the pool freeable: the caching allocator keeps its
    blocks reserved until it next empties its cache, so a sweep's
    hundreds of captures would hold nearly the whole card, and memory
    that cuDNN, cuBLAS or a module load allocates outside the caching
    allocator (a new thread's handle, a kernel's first launch) would
    fail."""
    graph.reset()
    torch.cuda.empty_cache()


_capture_streams = threading.local()


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """This thread's side stream on ``device`` for every warm-up and
    capture.  One stream, not a new one a capture: PyTorch keeps some
    state for each stream a library runs on (cuBLAS a workspace), and a
    fresh stream a capture would add that state each time until the
    stream pool wraps."""
    streams = getattr(_capture_streams, "by_device", None)
    if streams is None:
        streams = _capture_streams.by_device = {}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in streams:
        streams[index] = torch.cuda.Stream(index)
    return streams[index]


class CapturedGraph:
    """``fn`` captured as one CUDA graph on ``device``.

    ``warmup`` eager runs on a side stream (PyTorch's capture rule; they
    also build every kernel, plan and workspace at first use, and record
    the generators ``fn`` makes), then one capture on that stream.
    ``outputs`` is what the capture returned: every :meth:`replay`
    rewrites it in place, reseeding the generators first, so a replay
    computes what an eager call on the same inputs computes.
    :meth:`close` (or leaving the ``with`` block) frees the graph and
    gives its memory pool back to the device.  Raises
    :class:`NotCaptured` when the capture fails; the capture is then
    ended and its pool given back.  The set-up is a ``graph.setup`` span
    of the process's default telemetry hub, and a replay a
    ``graph.replay``."""

    def __init__(self, fn: Callable[[], Any], warmup: int = 2,
                 device: Optional[torch.device] = None):
        # core modules import nothing of repro_torch.runtime at module level
        from repro_torch.runtime.telemetry import get_default

        #: the hub is the process default at each replay
        self._hub = get_default
        with get_default().span("graph.setup"):
            self._setup(fn, warmup, device or torch.device("cuda"))

    def _setup(self, fn: Callable[[], Any], warmup: int,
               device: torch.device) -> None:
        self.supply = supply = GeneratorSupply(device)
        side = _capture_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(max(warmup, 1)):
                try:
                    with supply.recording():
                        fn()
                except RuntimeError as exc:
                    if supply.seeds is None:
                        raise  # the first eager run: a fault, no capture
                    raise NotCaptured(str(exc)) from exc
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = graph = torch.cuda.CUDAGraph()
        try:
            for gen in supply.prepare():
                graph.register_generator_state(gen)
        except AttributeError as exc:
            raise NotCaptured(f"this torch cannot register a generator "
                              f"with a CUDA graph ({exc})") from exc
        failure: Optional[BaseException] = None
        with torch.cuda.stream(side):
            # thread_local: other threads (a server's clients) may
            # allocate while this one captures
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                with supply.capturing():
                    self.outputs = fn()
            except Exception as exc:  # noqa: BLE001 — the capture must end
                failure = exc
            try:
                graph.capture_end()
            except RuntimeError as exc:
                failure = failure or exc
        if failure is not None:
            self.outputs = None
            # the failed run's tensors, allocated from the graph's pool,
            # live on in its traceback's frames: free them first, so the
            # whole pool goes back to the device
            traceback.clear_frames(failure.__traceback__)
            _abandon_capture(graph, device)
            if not isinstance(failure, RuntimeError):
                raise failure
            first = (str(failure).strip().splitlines() or [""])[0]
            raise NotCaptured(f"{first} at {where_raised(failure)}") from failure

    def replay(self) -> None:
        with self._hub().span("graph.replay"):
            self.supply.reset()
            self.graph.replay()

    def close(self) -> None:
        self.outputs = None
        _free_graph(self.graph)

    def __enter__(self) -> "CapturedGraph":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def graph_wall_time(fn: Callable[[], Any], warmup: int = 2, iters: int = 5,
                    device: Optional[torch.device] = None) -> float:
    """Median wall-clock seconds of one replay of ``fn`` captured as a
    CUDA graph (:class:`CapturedGraph`), plus a synchronise: one untimed
    replay (the graph's upload), then ``iters`` timed ones.  Raises
    :class:`NotCaptured` when ``fn`` cannot be captured."""
    device = device or torch.device("cuda")
    with CapturedGraph(fn, warmup, device) as graph:
        graph.replay()
        synchronize(device)
        times = []
        for _ in range(iters):
            graph.supply.reset()
            t0 = time.perf_counter()
            graph.graph.replay()
            synchronize(device)
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


#: why a sharded program's wall is eager
SHARDED = ("sharded over a mesh: a gloo collective goes through the host "
           "and cannot be captured in a CUDA graph; the slowest rank's "
           "eager wall")


def timed_wall(fn: Callable[[], Any], warmup: int = 2, iters: int = 5,
               device: Optional[torch.device] = None
               ) -> Tuple[float, Dict[str, str]]:
    """``(seconds, timing)``: the wall time of ``fn()`` and how it was
    taken.  On CUDA, :func:`graph_wall_time` (``{"mode": "graph"}``), or,
    where the capture fails, :func:`measure_wall_time` with the reason
    (``{"mode": "eager", "reason": ...}``); on the CPU always eager.

    Under an active mesh (a sharded program) the wall is eager, since
    its gloo collectives run through the host and cannot be captured,
    and it is the slowest rank's: every rank of the mesh gets the same
    value, so their tuners take the same steps."""
    device = device or torch.device("cpu")
    mesh = current_mesh()
    if mesh is not None:
        from repro_torch.core.cluster import mesh_max

        wall = measure_wall_time(fn, warmup, iters, device)
        return mesh_max(wall, mesh), {"mode": "eager", "reason": SHARDED}
    if device.type != "cuda":
        return (measure_wall_time(fn, warmup, iters, device),
                {"mode": "eager", "reason": "no CUDA graph on the cpu"})
    try:
        return graph_wall_time(fn, warmup, iters, device), {"mode": "graph"}
    except NotCaptured as exc:
        return (measure_wall_time(fn, warmup, iters, device),
                {"mode": "eager", "reason": f"not captured: {exc}"})


def signature_of_call(fn: Callable, *args, run: bool = True,
                      iters: int = 5,
                      device: Optional[torch.device] = None) -> Signature:
    """Profile ``fn(*args)`` and optionally time it (the paper's 'runtime'
    metric).  The port of ``signature_of_jitted``: here the profile is
    one eager execution rather than a compile, and the wall time that of
    one captured CUDA graph where ``fn`` can be captured
    (:func:`timed_wall`)."""
    device = device or _device_of(args)
    sig = profile_call(fn, *args, device=device)
    if run:
        sig.wall_time, sig.timing = timed_wall(lambda: fn(*args),
                                               iters=iters, device=device)
    return sig
