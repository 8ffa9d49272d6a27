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
* each hand-written kernel is one custom op with its own class and
  formula: ``repro_torch::matmul`` is dot with 2·M·N·K flops,
  ``repro_torch::row_moments`` reduce, ``repro_torch::bitonic_sort_blocks``
  sort, ``repro_torch::rmsnorm`` reduce (the fused norm's reduction, the
  reduce rule's flops), ``repro_torch::flash_attention`` dot with 4·D
  flops per (query, key) pair the mask keeps, ``repro_torch::moe_dispatch``
  dot with 2·T·E·C·D flops.
* peak memory: the CUDA allocator's peak over the profiled run, less what
  was allocated before it, plus the arguments (0.0 on the CPU).

``Signature`` and the ``vector()`` key names are the reference's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.utils.flop_counter as _flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.device import synchronize
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
#: the port's hand-written kernels, as the custom ops a profile sees
KERNEL_OPS = {"matmul": "dot", "row_moments": "reduce",
              "bitonic_sort_blocks": "sort", "rmsnorm": "reduce",
              "flash_attention": "dot", "moe_dispatch": "dot"}


def classify_op(func) -> str:
    """Op class of one ATen (or ``repro_torch``) op overload."""
    name = func.overloadpacket.__name__
    if func.namespace == "repro_torch":
        return KERNEL_OPS.get(name, "other")
    if func.namespace == "_c10d_functional":
        return "collective"
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
            self.collective_bytes[name] = (
                self.collective_bytes.get(name, 0.0) + (in_bytes or out_bytes))
        if name in _TRANSCENDENTAL:
            self.transcendentals += out_elems


class _Profiler(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.stats = ProfileStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
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


def profile_call(fn: Callable, *args,
                 device: Optional[torch.device] = None) -> Signature:
    """Run ``fn(*args)`` once under the op profiler; its signature without
    wall time.  ``device`` defaults to the first tensor argument's."""
    device = device or _device_of(args)
    cuda = device.type == "cuda"
    if cuda:
        synchronize(device)
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    with _Profiler() as prof:
        fn(*args)
    peak = 0.0
    if cuda:
        synchronize(device)
        peak = float(torch.cuda.max_memory_allocated(device) - before
                     + _nbytes(_tensors(args)))
    st = prof.stats
    return Signature(
        flops=st.flops, bytes=st.bytes, transcendentals=st.transcendentals,
        peak_memory=peak, op_mix=dict(st.op_bytes),
        collective_bytes=dict(st.collective_bytes), dot_flops=st.dot_flops,
        conv_flops=st.conv_flops,
        raw_cost={f"ops_{k}": float(v) for k, v in st.op_counts.items()})


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


def signature_of_call(fn: Callable, *args, run: bool = True,
                      iters: int = 5,
                      device: Optional[torch.device] = None) -> Signature:
    """Profile ``fn(*args)`` and optionally time it (the paper's 'runtime'
    metric).  The port of ``signature_of_jitted``: here the profile is
    one eager execution rather than a compile."""
    device = device or _device_of(args)
    sig = profile_call(fn, *args, device=device)
    if run:
        sig.wall_time = measure_wall_time(lambda: fn(*args), iters=iters,
                                          device=device)
    return sig
