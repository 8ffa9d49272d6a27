"""Perf-hillclimb driver (port of ``benchmarks/hillclimb.py``): dry-run
(arch x shape) cells with named sets of optimization flags and print the
roofline-term deltas.

Each flag set is one hypothesis -> change -> measure iteration.  Cells
are served from a shared in-process
:class:`repro_torch.core.evaluator.ExecutableCache` (the LRU the proxy
tuner uses), so one invocation sweeps several flag sets against one
baseline without profiling anything twice.  Each cell is measured cold
(miss: one rank of a fake production world, the step built and its
profiled dispatch run, ``launch.dryrun``) and again warm (hit), and both
wall times go into the JSON.  The terms are on ``launch.mesh.HW``, the
H100 SXM5 data sheet (700 W).

Usage::

  PYTHONPATH=src python -m repro_torch.bench.hillclimb \\
      --arch tinyllama-1.1b --shape train_4k --opts ce_onehot,moe_scan

Flags:
  --arch NAME     config name from repro_torch.configs (required)
  --shape NAME    shape cell from SHAPES_BY_NAME (required)
  --opts SETS     semicolon-separated flag sets, each a comma-separated
                  list (e.g. "ce_onehot;moe_scan,qchunk=128"); every set
                  is measured against the shared baseline
  --baseline      also measure the un-flagged baseline explicitly
  --multi-pod     dry-run on the multi-pod production mesh
  --out PATH      also write the JSON to a file (default: stdout only)

Output: per-row metric prints, before/after deltas per flag set, and one
JSON document::

  {"rows": {row_name: {"compile_s": float,   # cold build + profile wall
                       "cached_s": float,    # warm re-measure wall
                       "flops": float, "bytes": float, "coll_bytes": float,
                       "peak_gib": float, "compute_s": ..., "memory_s": ...,
                       "collective_s": ..., "dominant": str,
                       "useful_flops_fraction": ..., "model_flops_util": ...}},
   "cache": {"hits": int, "misses": int, "entries": int, ...}}
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch.bench._io import write_json
from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.core.evaluator import CacheEntry, ExecutableCache
from repro_torch.launch.dryrun import fake_mesh, lower_cell, roofline_terms
from repro_torch.launch.mesh import production_shape


def apply_opts(cfg, opts):
    """Named optimization flags -> config changes."""
    for o in opts:
        if not o:
            continue
        if o == "ce_onehot":
            cfg = cfg.replace(ce_impl="onehot")
        elif o == "norm_mixed":
            cfg = cfg.replace(norm_mixed=True)
        elif o == "attn_p_bf16":
            cfg = cfg.replace(attn_p_bf16=True)
        elif o.startswith("qchunk="):
            cfg = cfg.replace(attn_q_chunk=int(o.split("=")[1]))
        elif o.startswith("kvchunk="):
            cfg = cfg.replace(attn_kv_chunk=int(o.split("=")[1]))
        elif o == "moe_scan":
            assert cfg.moe is not None
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                      scan_groups=True))
        elif o == "ep_major":
            assert cfg.moe is not None
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                      ep_major=True))
        elif o == "no_remat":
            cfg = cfg.replace(remat="none")
        elif o.startswith("grad_accum="):
            cfg = cfg.replace(grad_accum=int(o.split("=")[1]))
        elif o.startswith("capacity="):
            assert cfg.moe is not None
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(o.split("=")[1])))
        elif o.startswith("group_size="):
            assert cfg.moe is not None
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, group_size=int(o.split("=")[1])))
        elif o.startswith("shard:"):
            # e.g. shard:kv_seq=model  /  shard:expert=data,model
            k, v = o[len("shard:"):].split("=")
            axes = tuple(v.split(",")) if v else None
            cfg = cfg.replace(sharding_overrides=cfg.sharding_overrides
                              + ((k, axes if axes and len(axes) > 1
                                  else (axes[0] if axes else None)),))
        elif o.startswith("moment_dtype="):
            cfg = cfg.replace(opt_moment_dtype=o.split("=")[1])
        elif o.startswith("param_dtype="):
            cfg = cfg.replace(param_dtype=o.split("=")[1])
        else:
            raise ValueError(f"unknown opt {o!r}")
    return cfg


def _cache() -> ExecutableCache:
    # the dry run runs on no device: the cache's device only keys a store
    return ExecutableCache(device="cpu")


def measure(cfg, shape, multi_pod=False, cache=None, cache_key=None):
    """Roofline metrics of one (config x shape) cell.

    With ``cache``, the cell's profiled signature is served from / inserted
    into the shared LRU under ``cache_key``; ``compile_s`` then reports
    the *cold* cost recorded at insert time and ``cached_s`` this call's
    actual wall (~0 on a hit).
    """
    cell = SHAPES_BY_NAME[shape]
    mesh_shape, names = production_shape(multi_pod)
    n_dev = 1
    for s in mesh_shape:
        n_dev *= s

    def build() -> CacheEntry:
        t0 = time.time()
        with fake_mesh(mesh_shape, names) as mesh:
            lowered, _ = lower_cell(cfg, cell, mesh)
            compiled = lowered.compile()
        cache.compiles += 1
        mem = compiled.memory_analysis()
        return CacheEntry(
            fn=None, lifted_example=None, signature=compiled.signature,
            metrics={"compile_s": round(time.time() - t0, 1),
                     "peak_bytes": float(mem.peak_bytes)})

    if cache is None:  # one-shot call: throwaway cache, still one code path
        cache = _cache()
        cache_key = ("adhoc",)
    t0 = time.time()
    entry = cache.get_or_build(cache_key, build)
    fetch_s = round(time.time() - t0, 3)
    sig = entry.signature
    roof = roofline_terms(sig, n_dev, cfg, cell)
    return {
        "compile_s": entry.metrics["compile_s"],
        "cached_s": fetch_s,
        "flops": sig.flops, "bytes": sig.bytes,
        "coll_bytes": sum(sig.collective_bytes.values()),
        "coll_by_kind": sig.collective_bytes,
        "peak_gib": entry.metrics["peak_bytes"] / 2**30,
        **{k: roof[k] for k in ("compute_s", "memory_s", "collective_s",
                                "dominant", "useful_flops_fraction",
                                "model_flops_util")},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--opts", default="",
                    help="semicolon-separated flag sets, each "
                         "comma-separated, e.g. 'ce_onehot;moe_scan'")
    ap.add_argument("--baseline", action="store_true",
                    help="also measure the un-flagged baseline")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="",
                    help="also write the JSON document to this path")
    args = ap.parse_args(argv)

    cfg0 = get_config(args.arch)
    opt_sets = [s.split(",") for s in args.opts.split(";") if s]

    cache = _cache()

    def measure_cached(opts):
        key = (args.arch, args.shape, args.multi_pod, tuple(opts))
        cfg = apply_opts(cfg0, opts) if opts else cfg0
        cold = measure(cfg, args.shape, args.multi_pod, cache, key)
        warm = measure(cfg, args.shape, args.multi_pod, cache, key)
        cold["cached_s"] = warm["cached_s"]  # cold row keeps compile_s
        return cold

    rows = {}
    if args.baseline or not opt_sets:
        # profiled once, reused (cache hit) for every flag set's delta below
        rows["baseline"] = measure_cached([])
    for opts in opt_sets:
        rows["+" + ",".join(opts)] = measure_cached(opts)

    for name, r in rows.items():
        print(f"\n[{args.arch} x {args.shape}] {name}")
        for k, v in r.items():
            print(f"  {k:22s} {v}")
    base = rows.get("baseline")
    for opts in opt_sets:
        o = rows["+" + ",".join(opts)]
        if base is None:
            break
        print(f"\ndeltas for +{','.join(opts)}:")
        for term in ("compute_s", "memory_s", "collective_s", "peak_gib"):
            if base[term]:
                print(f"delta {term:14s} {base[term]:.4g} -> {o[term]:.4g}  "
                      f"({(o[term]-base[term])/base[term]*100:+.1f}%)")

    doc = {
        "rows": {k: {kk: vv for kk, vv in v.items() if kk != "coll_by_kind"}
                 for k, v in rows.items()},
        "cache": cache.stats(),
    }
    print(json.dumps(doc, default=str))
    if args.out:
        write_json(args.out, doc)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
