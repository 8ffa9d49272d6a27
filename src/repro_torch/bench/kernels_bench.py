"""Kernel microbenchmarks + motif-level kernels-vs-ATen comparison (port
of ``benchmarks/kernels_bench.py``).

Two layers:

1. Micro rows — the plain PyTorch versions (``kernels/ref.py``, the
   kernels' oracles) timed at fixed shapes with a derived throughput, and
   one row, ``matmul_hopper_256``, through the kernel wrapper: on a CUDA
   device it launches the hand-written kernel, on the CPU it runs the
   plain version.  Each row's ``us_per_call`` and derived column come
   from ONE ``measure_wall_time`` run.

2. Motif rows — every motif with a registered ``substrate="hopper"``
   lowering (``repro_torch.core.motifs.lowered_motifs``) is built as a
   single-node proxy and evaluated through the SAME
   :class:`~repro_torch.core.evaluator.BatchEvaluator` path the tuner
   uses, once per substrate (``"torch"``, ``"hopper"``).  The row reports
   both wall times plus the roofline terms (flops, bytes, arithmetic
   intensity) next to the cache stats in the bench JSON.

``--check`` additionally gates allclose parity (``rtol=atol=1e-3`` in
f32) of the hopper lowering against the stock ``apply`` per motif row and
exits nonzero on any mismatch.

Prints ``name,us_per_call,derived`` CSV rows.  Runs on CUDA unless
``--device cpu`` is given; a host without a card must ask for the CPU.

Usage:  PYTHONPATH=src python -m repro_torch.bench.kernels_bench \\
            [--check] [--device cuda|cpu] [--out results/kernels_bench.json]
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.bench._io import write_json
from repro_torch.core.evaluator import BatchEvaluator
from repro_torch.core.motifs import (
    SUBSTRATES,
    PVector,
    get_motif,
    lowered_motifs,
)
from repro_torch.core.motifs.base import _leaves
from repro_torch.core.proxy_graph import MotifNode, ProxyBenchmark
from repro_torch.core.signature import measure_wall_time
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.uint32 import narrow, widen

ROWS: List[Dict[str, Any]] = []


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    print(f"{name},{us_per_call:.1f},{derived}")
    ROWS.append({"name": name, "us_per_call": us_per_call,
                 "derived": derived})


def bench(name: str, fn, *args, device: torch.device,
          derive: Optional[Callable[[float], str]] = None) -> float:
    """ONE timed measurement; both CSV columns derive from it."""
    t = measure_wall_time(lambda: fn(*args), warmup=2, iters=5,
                          device=device)
    emit(name, t * 1e6, derive(t) if derive is not None else "")
    return t


def micro_rows(dev: torch.device) -> None:
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    m = k = n = 512
    x, y = randn(m, k), randn(k, n)
    flops = 2 * m * k * n
    bench("matmul_ref_512", ref.matmul, x, y, device=dev,
          derive=lambda t: f"{flops/t/1e9:.1f}GFLOP/s")

    rows, d = 4096, 1024
    xr = randn(rows, d)
    w = torch.ones((d,), device=dev)
    bench("rmsnorm_ref_4kx1k", ref.rmsnorm, xr, w, device=dev,
          derive=lambda t: f"{rows*d*4/t/1e9:.1f}GB/s")

    keys = narrow(torch.randint(0, 1 << 32, (1 << 18,), generator=g,
                                device=dev, dtype=torch.int64), torch.uint32)
    bench("sort_ref_256k", ref.sort, keys, device=dev,
          derive=lambda t: f"{keys.numel()/t/1e6:.1f}Mkeys/s")

    q = randn(1, 512, 4, 64)
    bench("attention_ref_b1s512h4", ref.flash_attention, q, q, q, device=dev,
          derive=lambda t: "seq512")

    ids = torch.randint(0, 16, (1024,), generator=g, device=dev)
    mask = ops.make_dispatch_mask(ids, 16, 128)
    xd = randn(1024, 256)
    bench("moe_dispatch_ref_1k", ref.moe_dispatch, mask, xd, device=dev,
          derive=lambda t: "E16C128")

    # one row through a kernel wrapper: the hand-written kernel on a card,
    # its plain version on the CPU
    xs = randn(256, 256)
    bench("matmul_hopper_256", ops.matmul, xs, xs, device=dev,
          derive=lambda t: "kernel" if dev.type == "cuda"
          else "plain-version")


# ---------------------------------------------------------------------------
# Motif-level kernels-vs-ATen rows
# ---------------------------------------------------------------------------

# one representative (variant, P) per lowered motif, small enough for a
# CPU run, big enough to exercise the non-trivial chunk layouts (non-pow2
# chunk for sort's merge path)
MOTIF_CASES: Dict[str, Tuple[str, PVector]] = {
    "sort": ("merge", PVector(data_size=1 << 12, chunk_size=384,
                              num_tasks=2, dtype="float32")),
    "matrix": ("matmul", PVector(data_size=1 << 10, chunk_size=128,
                                 num_tasks=2, channels=16)),
    "statistics": ("average", PVector(data_size=1 << 12, chunk_size=256,
                                      num_tasks=2)),
}


def motif_substrate_rows(check: bool, dev: torch.device
                         ) -> Tuple[List[Dict[str, Any]], Dict[str, int],
                                    List[str]]:
    """kernels-vs-ATen wall/roofline per lowered motif; optional parity."""
    engine = BatchEvaluator(run=True, seed=0, device=dev)
    rows: List[Dict[str, Any]] = []
    failures: List[str] = []

    for motif_name in lowered_motifs():
        variant, p = MOTIF_CASES.get(
            motif_name, ("", PVector(data_size=1 << 12, num_tasks=2)))
        pb = ProxyBenchmark(f"bench_{motif_name}",
                            (MotifNode("n0", motif_name, variant, p),))
        sigs = {s: engine.signature_of(pb.with_substrate(s))
                for s in SUBSTRATES}

        st, sh = sigs["torch"], sigs["hopper"]
        row = {
            "motif": motif_name, "variant": variant,
            "wall_torch_s": st.wall_time, "wall_hopper_s": sh.wall_time,
            "flops_torch": st.flops, "flops_hopper": sh.flops,
            "bytes_torch": st.bytes, "bytes_hopper": sh.bytes,
            "arith_intensity_torch": st.arith_intensity,
            "arith_intensity_hopper": sh.arith_intensity,
        }
        if st.wall_time and sh.wall_time:
            row["hopper_over_torch"] = sh.wall_time / st.wall_time
        rows.append(row)
        # wall time already measured once by the engine; emit it as CSV
        for substrate, sig in sigs.items():
            emit(f"motif_{motif_name}_{variant}_{substrate}",
                 (sig.wall_time or 0.0) * 1e6,
                 f"ai={sig.arith_intensity:.2f}")

        if check:
            failures += parity_check(motif_name, variant, p, dev)

    return rows, engine.stats(), failures


def parity_check(motif_name: str, variant: str, p: PVector,
                 dev: torch.device) -> List[str]:
    """allclose gate: hopper execute vs the stock apply, one motif."""
    motif = get_motif(motif_name)
    inputs = motif.make_inputs(p, 7, device=dev)
    want = motif.apply(p, inputs, variant)
    got = motif.execute(p.replace(substrate="hopper"), inputs, variant)
    bad: List[str] = []
    wl, gl = _leaves(want), _leaves(got)
    if len(wl) != len(gl):
        bad.append(f"{motif_name}/{variant}: {len(wl)} torch leaves vs "
                   f"{len(gl)} hopper leaves")
    for i, (w, g) in enumerate(zip(wl, gl)):
        if w.shape != g.shape or not torch.allclose(
                widen(w).to(torch.float32), widen(g).to(torch.float32),
                rtol=1e-3, atol=1e-3):
            bad.append(f"{motif_name}/{variant} leaf {i}: "
                       f"torch{tuple(w.shape)} vs hopper{tuple(g.shape)} "
                       f"mismatch")
    emit(f"parity_{motif_name}_{variant}", 0.0, "FAIL" if bad else "ok")
    return bad


def device_info(dev: torch.device) -> Dict[str, Any]:
    if dev.type == "cuda":
        return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"type": dev.type, "name": "cpu", "count": 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--check", action="store_true",
                    help="gate hopper-vs-torch parity per motif; exit "
                         "nonzero on mismatch")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the full bench doc as JSON")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ROWS.clear()

    print("name,us_per_call,derived")
    micro_rows(dev)
    motif_rows, cache_stats, failures = motif_substrate_rows(args.check, dev)

    if args.out:
        write_json(args.out, {
            "bench": "kernels_bench",
            "backend": dev.type,
            "device": device_info(dev),
            "rows": ROWS,
            "motif_substrate": motif_rows,
            "cache": cache_stats,
            "parity": {"checked": bool(args.check), "failures": failures},
        })

    if failures:
        for f in failures:
            print(f"PARITY FAIL: {f}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
