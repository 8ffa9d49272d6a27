"""Pod-scale dry run: one rank's cost of every (architecture x shape x
mesh) cell, with no card and no memory (port of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step against 512
placeholder host devices and reads the compiled program's per-device
cost.  The port's counterpart is one rank of a fake world: a ``"fake"``
process group of 256 (512) ranks joined as rank 0
(:func:`repro_torch.distributed.launch.fake_world`), the reference's
production mesh over it (:func:`repro_torch.launch.mesh.
make_production_mesh`), and the step's params, optimizer state, caches
and batch as DTensors of meta tensors placed by
``sharding_for_meta`` and :func:`batch_shardings`.  One dispatch of the
step under the op profiler (``core.signature.profile_abstract``) is the
"compile": DTensor runs rank 0's local ops and the functional
collectives it needs, which the fake group answers at once; the profile
counts the local ops' flops and bytes and the collectives' bytes by the
reference's kinds, and the peak of live bytes on the rank.  Nothing is
computed and nothing is allocated on any device.

Each record has every key of the reference's, plus ``dot_flops``,
``replicated_ops`` (the ops DTensor could not place, run on whole
operands: ``distributed.spmd.ReplicateUnplaceable``), ``top_collectives``
(the collective bytes of the operands that moved the most, by kind,
dtype and local shape) and ``torch`` (the version that ran: DTensor's
placement choices, so the collectives and the peak, differ between
versions): ``lower_s`` is the wall
of building the abstract step, ``compile_s`` that of the profiled
dispatch, ``memory_analysis`` the live-bytes summary, and the roofline
terms come from :func:`roofline_terms` on ``launch.mesh.HW``, the H100
SXM5 data sheet (700 W).  A 256-GPU mesh crosses nodes, so the
collective term at NVLink's rate is a lower bound.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --out results/dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import ALL_SHAPES, ARCH_NAMES, SHAPES_BY_NAME, \
    get_config
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.signature import (MemoryAnalysis, Signature,
                                        profile_abstract)
from repro_torch.core.store import atomic_write_text
from repro_torch.distributed import spmd
from repro_torch.distributed.launch import fake_world
from repro_torch.distributed.sharding import (Sharding, ShardingRules,
                                              named_sharding,
                                              sharding_for_meta, use_mesh)
from repro_torch.launch.mesh import HW, make_mesh, production_shape
from repro_torch.launch.train import state_shardings
from repro_torch.models import build_model
from repro_torch.models import flash
from repro_torch.models.model_zoo import input_specs
from repro_torch.models.params import ParamMeta, abstract_params, tree_map
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import (TrainSettings, make_train_step,
                                 train_state_meta)
from repro_torch.runtime.serve_loop import make_decode_step, make_prefill_step


# ---------------------------------------------------------------------------
# Sharding of step inputs
# ---------------------------------------------------------------------------


def batch_shardings(specs: Dict[str, Any], mesh, model=None, cell=None):
    """Data-batch inputs shard their leading dim over (pod, data); a
    decode cell's caches are placed by ``sharding_for_meta``."""
    def one(s):
        axes = ("batch",) + (None,) * (s.dim() - 1) if s.dim() else ()
        return Sharding(mesh, named_sharding(tuple(s.shape), axes, mesh))

    out = {}
    for k, v in specs.items():
        if k == "caches":
            meta = model.cache_meta(cell.global_batch, cell.seq_len)
            out[k] = sharding_for_meta(meta, mesh)
        else:
            out[k] = tree_map(one, v)
    return out


def _spec_meta(s: torch.Tensor) -> ParamMeta:
    return ParamMeta(tuple(s.shape), s.dtype, (None,) * s.dim(), "zeros")


# ---------------------------------------------------------------------------
# Cell lowering
# ---------------------------------------------------------------------------


@dataclass
class Compiled:
    """A profiled cell: its signature and memory (the reference's
    compiled executable, as far as the dry run reads it)."""

    signature: Signature
    memory: MemoryAnalysis

    def memory_analysis(self) -> MemoryAnalysis:
        return self.memory


#: how many of the operands that moved the most collective bytes a
#: record lists (``top_collectives``)
TOP = 8

#: the pure functions a dry run profiles once per shape: flash
#: attention's forward and backward loops, the same at every layer
MEMO = ((flash, "flash_forward"), (flash, "flash_backward"))


@dataclass
class Lowered:
    """One cell's step and its abstract arguments, ready to profile."""

    fn: Callable
    args: Tuple
    mesh: Any
    rules: ShardingRules
    aux: Dict[str, Any] = field(default_factory=dict)

    def compile(self) -> Compiled:
        """One profiled dispatch of the step (``profile_abstract``), each
        shape of flash attention's loops profiled once (``MEMO``)."""
        with use_mesh(self.mesh, self.rules):
            sig, mem = profile_abstract(self.fn, *self.args, memo=MEMO)
        return Compiled(sig, mem)


def lower_cell(cfg: ModelConfig, cell: ShapeCell, mesh,
               settings: Optional[TrainSettings] = None
               ) -> Tuple[Lowered, Dict[str, Any]]:
    """Build one (arch, shape) cell on ``mesh``: its step and abstract
    arguments (meta tensors).  Returns ``(lowered, aux)``."""
    model = build_model(cfg)
    settings = settings or TrainSettings(
        optimizer=AdamWConfig(moment_dtype=cfg.opt_moment_dtype))
    rules = ShardingRules().with_overrides(dict(cfg.sharding_overrides))
    with use_mesh(mesh, rules):
        specs = input_specs(cfg, cell, model)

        def placed(meta):
            return abstract_params(meta, sharding_for_meta(meta, mesh))

        if cell.kind == "train":
            state = abstract_params(train_state_meta(model, settings),
                                    state_shardings(model, settings, mesh))
            batch = tree_map(lambda s, sh: abstract_params(_spec_meta(s), sh),
                             specs, batch_shardings(specs, mesh))
            fn, args = make_train_step(model, settings), (state, batch)
        elif cell.kind == "prefill":
            params = placed(model.param_meta())
            batch = tree_map(lambda s, sh: abstract_params(_spec_meta(s), sh),
                             specs, batch_shardings(specs, mesh))
            fn, args = make_prefill_step(model), (params, batch)
        else:  # decode
            params = placed(model.param_meta())
            caches = placed(model.cache_meta(cell.global_batch,
                                             cell.seq_len))
            batch = {"tokens": placed(ParamMeta(
                         (cell.global_batch, 1), torch.int32,
                         ("batch", None), "zeros")),
                     "index": placed(ParamMeta((), torch.int32, (),
                                               "zeros"))}
            fn, args = make_decode_step(model), (params, caches, batch)
    aux = {"model": model, "kind": cell.kind}
    return Lowered(fn, args, mesh, rules, aux), aux


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------


def roofline_terms(sig: Signature, num_devices: int,
                   cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Three-term roofline of one rank's signature, on ``HW`` (the H100
    SXM5 data sheet, 700 W): the reference's arithmetic.  Flops and bytes
    are the rank's; collective bytes are its link traffic, at NVLink's
    rate (a lower bound across nodes)."""
    compute_s = sig.flops / HW["peak_bf16_flops"]
    memory_s = sig.bytes / HW["hbm_bandwidth"]
    collective_s = sum(sig.collective_bytes.values()) / HW["ici_bandwidth"]
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)

    counts = cfg.param_counts()
    tokens = cell.global_batch * cell.seq_len if cell.kind == "train" else (
        cell.global_batch * (cell.seq_len if cell.kind == "prefill" else 1))
    n_active = counts["active"]
    mult = 6 if cell.kind == "train" else 2
    model_flops = mult * n_active * tokens  # global
    model_flops_per_dev = model_flops / num_devices
    bound = max(terms.values())
    return {
        **terms,
        "dominant": dominant,
        "step_time_lower_bound_s": bound,
        "model_flops_global": model_flops,
        "model_flops_per_device": model_flops_per_dev,
        "useful_flops_fraction": model_flops_per_dev / max(sig.flops, 1.0),
        "model_flops_util": (model_flops_per_dev / HW["peak_bf16_flops"])
        / max(bound, 1e-12),
    }


def _memory_text(mem: MemoryAnalysis) -> str:
    return (f"LiveBytes(argument={mem.argument_size_in_bytes}, "
            f"output={mem.output_size_in_bytes}, "
            f"alias={mem.alias_size_in_bytes}, "
            f"temp={mem.temp_size_in_bytes}, peak={mem.peak_bytes})")


def cell_record(arch: str, shape_name: str, cfg: ModelConfig,
                cell: ShapeCell, mesh, *, verbose: bool = True) -> Dict[str, Any]:
    """Lower and profile one cell on ``mesh`` (inside its world): the
    reference's record."""
    n_dev = mesh.size()
    t0 = time.time()
    lowered, _ = lower_cell(cfg, cell, mesh)
    t_lower = time.time() - t0
    spmd.clear_replicated()
    t0 = time.time()
    compiled = lowered.compile()
    t_compile = time.time() - t0
    sig, mem = compiled.signature, compiled.memory_analysis()
    roof = roofline_terms(sig, n_dev, cfg, cell)
    rec: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "kind": cell.kind,
        "mesh": "x".join(str(mesh.size(i)) for i in range(mesh.ndim)),
        "devices": n_dev,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "flops_per_device": sig.flops,
        "bytes_per_device": sig.bytes,
        "collective_bytes": sig.collective_bytes,
        "op_mix_bytes": sig.op_mix,
        "peak_memory_bytes": sig.peak_memory,
        "memory_analysis": _memory_text(mem),
        "fits_hbm": (sig.peak_memory or 0) < HW["hbm_bytes"],
        **roof,
    }
    # beyond the reference's keys: the dot flops, the ops DTensor could
    # not place, run on whole operands (``spmd.replicated_ops``), the
    # operands that moved the most collective bytes, and the torch that
    # ran (DTensor's placement choices, and so the collectives and the
    # peak, differ between versions)
    rec["dot_flops"] = sig.dot_flops
    rec["replicated_ops"] = spmd.replicated_ops()
    rec["top_collectives"] = dict(sorted(
        ((k[len("collective "):], v) for k, v in sig.raw_cost.items()
         if k.startswith("collective ")), key=lambda kv: -kv[1])[:TOP])
    rec["torch"] = torch.__version__
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} on {rec['mesh']}: "
              f"compile={t_compile:.1f}s "
              f"flops/dev={sig.flops:.3e} bytes/dev={sig.bytes:.3e} "
              f"coll={sum(sig.collective_bytes.values()):.3e}B "
              f"peak_mem={sig.peak_memory/2**30:.2f}GiB "
              f"dominant={roof['dominant']}")
        print(f"  memory_analysis: {rec['memory_analysis']}")
        print(f"  cost_analysis: flops={sig.flops:.4g} bytes={sig.bytes:.4g} "
              f"transcendentals={sig.transcendentals:.4g}")
    return rec


@contextlib.contextmanager
def fake_mesh(shape, names):
    """A fake world of ``prod(shape)`` ranks and a mesh of ``shape`` over
    it (a CPU mesh: its tensors are meta tensors), for the body of the
    ``with``."""
    n = 1
    for s in shape:
        n *= s
    with fake_world(n):
        yield make_mesh(shape, names, device="cpu")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True) -> Dict[str, Any]:
    cfg = get_config(arch)
    cell = SHAPES_BY_NAME[shape_name]
    skip = cfg.skipped(shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name, "skipped": skip}
    shape, names = production_shape(multi_pod)
    with fake_mesh(shape, names) as mesh:
        return cell_record(arch, shape_name, cfg, cell, mesh,
                           verbose=verbose)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list(ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = [s.name for s in ALL_SHAPES] if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    records = []
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    records.append(run_cell(arch, shape, mp))
                except Exception as e:  # noqa: BLE001 — one failing
                    # cell must not abort the sweep; the failure is
                    # recorded in the matrix and drives the exit code
                    failures += 1
                    records.append({"arch": arch, "shape": shape,
                                    "multi_pod": mp, "error": repr(e)[:500]})
                    print(f"[dryrun] FAIL {arch} x {shape} multi_pod={mp}: "
                          f"{repr(e)[:300]}", file=sys.stderr)
                    traceback.print_exc(file=sys.stderr)
    if args.out:
        atomic_write_text(args.out,
                          json.dumps(records, indent=1, default=str))
        print(f"[dryrun] wrote {len(records)} records to {args.out}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
