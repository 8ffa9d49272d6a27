"""Data-motif protocol, parameter vector P, and the motif registry (port
of ``repro/core/motifs/base.py``).

A *data motif* (paper §II-A) is a parameterized unit of computation on
initial or intermediate data.  It owns its input data (type / pattern /
distribution) and its execution model (chunking, task parallelism), both
part of the tunable parameter vector P (paper Table I).

GPU adaptation of the paper's POSIX-thread execution model:

* ``num_tasks``  (processes/threads)     -> leading batch dimension
* ``chunk_size`` (per-thread data block) -> the chunk dimension of one
  batched computation over a ``(tasks, per, chunk, ...)`` view
* ``weight``     (motif contribution)    -> invocation repetitions, a
  Python loop that feeds each output back into the next input
* dataSize/batchSize/height/width/channels keep their paper meaning.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.data.generators import DataSpec
from repro_torch.uint32 import bits, widen

# ---------------------------------------------------------------------------
# Parameter vector P (paper Table I)
# ---------------------------------------------------------------------------

#: P fields that the auto-tuner may adjust, with (min, max) bounds.
TUNABLE_BOUNDS: Dict[str, Tuple[float, float]] = {
    "data_size": (2.0 ** 8, 2.0 ** 26),
    "chunk_size": (2.0 ** 4, 2.0 ** 20),
    "num_tasks": (1, 256),
    "weight": (0.05, 16.0),
    "batch_size": (1, 1024),
    "total_size": (0, 2.0 ** 28),
    "height": (4, 512),
    "width": (4, 512),
    "channels": (1, 512),
}

#: bounds for the evaluator's candidate-batch size and LRU capacity
EVAL_BATCH_BOUNDS: Tuple[int, int] = (1, 256)
EVAL_CACHE_BOUNDS: Tuple[int, int] = (4, 4096)
DEFAULT_EVAL_BATCH: int = 32
DEFAULT_EVAL_CACHE: int = 256

#: P fields that change the shapes a proxy runs at.  ``weight`` is
#: absent: it enters execution only through ``PVector.repeats``.
STRUCTURAL_FIELDS: Tuple[str, ...] = (
    "data_size", "chunk_size", "num_tasks", "batch_size", "total_size",
    "height", "width", "channels",
)

#: P fields that enter a run only as values, never as shapes or code
#: paths; the eval form takes them as a lifted ``f32[n_nodes, 4]`` tensor.
#: Order is the column order of ``ProxyBenchmark.lifted_values()``.
LIFTED_FIELDS: Tuple[str, ...] = ("weight", "sparsity", "dist_scale",
                                  "zipf_alpha")

#: column indices into the lifted-argument tensor ``f32[n_nodes, 4]``
LIFT_REPEATS, LIFT_SPARSITY, LIFT_SCALE, LIFT_ZIPF = 0, 1, 2, 3

#: legal values of ``PVector.substrate``.  ``"torch"`` is the stock ATen
#: form (the default, contributing nothing to the structural key);
#: ``"hopper"`` routes motifs with a registered kernel lowering through
#: ``repro_torch.kernels.ops`` — the hand-written CUDA kernels.  A
#: lowering declines a variant it has no kernel for, a fixed property of
#: that variant, and the variant then runs its stock ``apply``.
SUBSTRATES: Tuple[str, ...] = ("torch", "hopper")


@dataclass(frozen=True)
class PVector:
    """The paper's tunable parameter vector P (Table I) + data controls."""

    data_size: int = 1 << 16      # dataSize: elements per invocation
    chunk_size: int = 1 << 12     # chunkSize: per-task block
    num_tasks: int = 4            # numTasks: parallel lanes
    weight: float = 1.0           # weight: motif contribution
    batch_size: int = 8           # batchSize (AI motifs)
    total_size: int = 0           # totalSize (AI motifs; 0 -> data_size)
    height: int = 32              # heightSize
    width: int = 32               # widthSize
    channels: int = 16            # numChannels
    dtype: str = "float32"
    distribution: str = "uniform"
    sparsity: float = 0.0
    layout: str = "NHWC"          # TensorFlow storage-format analog
    dist_scale: float = 1.0       # distribution scale (std / range multiplier)
    zipf_alpha: float = 1.2       # power-law skew exponent (zipf only)
    # execution substrate (SUBSTRATES); "torch" adds nothing to the key
    substrate: str = "torch"

    # -------------------------------------------------------------------
    def spec(self) -> DataSpec:
        return DataSpec(distribution=self.distribution,
                        sparsity=self.sparsity, dtype=self.dtype,
                        scale=self.dist_scale, zipf_alpha=self.zipf_alpha)

    def replace(self, **kw) -> "PVector":
        return dataclasses.replace(self, **kw)

    def structural_key(self, include_repeats: bool = True) -> Tuple:
        """Everything that determines what the eval form runs, minus the
        lifted knobs: the integer size fields, the concrete data
        characteristics, a non-default substrate, and the rounded repeat
        count.  Equal keys mean equal shapes, ops and op counts."""
        key: Tuple = tuple(int(getattr(self, f)) for f in STRUCTURAL_FIELDS)
        key += (self.dtype, self.distribution, self.layout)
        if self.substrate != "torch":
            key += ("__substrate__", self.substrate)
        if include_repeats:
            key += (self.repeats,)
        return key

    def lifted_row(self) -> Tuple[float, float, float, float]:
        """(repeats, sparsity, dist_scale, zipf_alpha), LIFTED_FIELDS order."""
        return (float(self.repeats), float(self.sparsity),
                float(self.dist_scale), float(self.zipf_alpha))

    @property
    def repeats(self) -> int:
        return max(int(round(self.weight)), 1)


# ---------------------------------------------------------------------------
# Motif protocol
# ---------------------------------------------------------------------------


class Motif:
    """One data motif.  Subclasses define variants (paper Table III)."""

    name: str = "base"
    variants: Tuple[str, ...] = ()
    default_variant: str = ""
    #: P fields this motif responds to (the tuner only moves these)
    tunable: Tuple[str, ...] = ("data_size", "chunk_size", "num_tasks", "weight")

    def make_inputs(self, p: PVector, seed: int,
                    device: Optional[torch.device] = None) -> Any:
        """Generate this motif's input data on ``device`` from ``seed``."""
        raise NotImplementedError

    def apply(self, p: PVector, inputs: Any, variant: str = "") -> Any:
        """The unit of computation in its stock ATen form."""
        raise NotImplementedError

    def execute(self, p: PVector, inputs: Any, variant: str = "") -> Any:
        """``apply`` routed through P's execution substrate.

        ``"torch"`` is ``apply``.  Any other substrate looks up the
        ``(motif, substrate)`` lowering; a lowering returns ``None`` for a
        variant it declines (a fixed, per-variant property), which then
        runs ``apply``."""
        if p.substrate != "torch":
            if p.substrate not in SUBSTRATES:
                raise ValueError(
                    f"{self.name}: unknown substrate {p.substrate!r} "
                    f"(have {SUBSTRATES})")
            lowering = get_lowering(self.name, p.substrate)
            if lowering is not None:
                out = lowering(self, p, inputs, self.resolve_variant(variant))
                if out is not None:
                    return out
        return self.apply(p, inputs, variant)

    # -------------------------------------------------------------------
    def weighted_apply(self, p: PVector, inputs: Any,
                       variant: str = "") -> Any:
        """Apply with the paper's *weight* as invocation repetitions; each
        repetition folds the previous output into its input."""
        reps = p.repeats
        if reps == 1:
            return self.execute(p, inputs, variant)
        return self._weighted_loop(p, inputs, variant, reps)

    def weighted_apply_dynamic(self, p: PVector, inputs: Any,
                               variant: str = "", reps=None) -> Any:
        """``weighted_apply`` with an explicit repeat count (int or 0-d
        tensor); ``None`` uses P's own."""
        if reps is None:
            return self.weighted_apply(p, inputs, variant)
        return self._weighted_loop(p, inputs, variant, max(int(reps), 1))

    def _weighted_loop(self, p: PVector, inputs: Any, variant: str,
                       reps: int) -> Any:
        feed = inputs
        out = self.execute(p, inputs, variant)
        for _ in range(1, reps):
            out = self.execute(p, feed, variant)
            feed = _tree_perturb(feed, _tree_checksum(out))
        return out

    # -------------------------------------------------------------------
    def resolve_variant(self, variant: str = "") -> str:
        v = variant or self.default_variant or (
            self.variants[0] if self.variants else "")
        if self.variants and v not in self.variants:
            raise ValueError(f"{self.name}: unknown variant {v!r} "
                             f"(have {self.variants})")
        return v


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _leaves(v)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_checksum(tree) -> torch.Tensor:
    """Tiny scalar derived from outputs (keeps the weight loop honest)."""
    leaves = [l for l in _leaves(tree) if isinstance(l, torch.Tensor)]
    device = leaves[0].device if leaves else None
    acc = torch.zeros((), dtype=torch.float32, device=device)
    for l in leaves:
        flat = l.reshape(-1)
        probe = flat[: min(flat.numel(), 8)]
        acc = acc + torch.sum(widen(probe).to(torch.float32)) * 1e-12
    return acc


def _tree_perturb(tree, eps: torch.Tensor):
    """Fold ``eps`` into every leaf.  As in the reference, int32 leaves are
    left alone and every other integer leaf (uint32 included) is XORed
    with ``eps != 0``."""
    def one(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.dtype.is_floating_point:
            return x + eps.to(x.dtype)
        if x.dtype == torch.int32 or x.dtype == torch.bool:
            return x
        b = bits(x)  # uint32 XORs its int32 bits
        return torch.bitwise_xor(b, (eps != 0.0).to(b.dtype)).view(x.dtype)
    return _tree_map(one, tree)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

MOTIFS: Dict[str, Motif] = {}

#: substrate-lowering registry: ``(motif name, substrate) -> lowering``;
#: a lowering is ``fn(motif, p, inputs, variant) -> Optional[tree]``.
LOWERINGS: Dict[Tuple[str, str], Callable] = {}


def register_lowering(motif_name: str, substrate: str = "hopper"):
    """Decorator: register a kernel lowering for one motif+substrate."""
    if substrate not in SUBSTRATES or substrate == "torch":
        raise ValueError(f"cannot register a lowering for {substrate!r}")

    def deco(fn):
        LOWERINGS[(motif_name, substrate)] = fn
        return fn
    return deco


def get_lowering(motif_name: str, substrate: str):
    return LOWERINGS.get((motif_name, substrate))


def lowered_motifs(substrate: str = "hopper") -> Tuple[str, ...]:
    """Motif names with a registered lowering on ``substrate``."""
    return tuple(sorted(m for m, s in LOWERINGS if s == substrate))


def register(cls):
    inst = cls()
    MOTIFS[inst.name] = inst
    return cls


def get_motif(name: str) -> Motif:
    if name not in MOTIFS:
        raise KeyError(f"unknown motif {name!r}; have {sorted(MOTIFS)}")
    return MOTIFS[name]


# shared helpers --------------------------------------------------------------


def chunked(p: PVector, x: torch.Tensor) -> torch.Tensor:
    """Reshape the leading dim to (num_tasks, chunks_per_task, chunk),
    truncating to a whole number of (task, chunk) blocks."""
    n = x.shape[0]
    chunk = max(min(p.chunk_size, n), 1)
    tasks = max(min(p.num_tasks, max(n // chunk, 1)), 1)
    per = max(n // (tasks * chunk), 1)
    used = tasks * per * chunk
    return x[:used].reshape((tasks, per, chunk) + tuple(x.shape[1:]))


def combine(parts: torch.Tensor) -> torch.Tensor:
    """The paper's 'data combination' stage: merge per-task partials."""
    return (parts.reshape((-1,) + tuple(parts.shape[3:]))
            if parts.ndim >= 3 else parts)
