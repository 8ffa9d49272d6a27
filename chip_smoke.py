#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``src/repro_torch``).

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. environment: the card's name and power limit, torch/CUDA versions,
   which torch ops take uint32 on the card, and the kernels' build
   (``nvcc`` on ``src/repro_torch/kernels/csrc``) with its time;
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card, at main-path and ragged shapes, with kernel, plain and
   one-library-call times;
3. main path: ``generate_proxy`` on K-means at ``SCALE`` (1.0: 400,000
   x 64 f32 points, 32 centroids) with ``substrate="hopper"``, with every
   kernel's launch counter zeroed just before and read just after; a
   kernel the path never launched fails the run;
4. checks: the K-means step's outputs, and the tuned proxy's outputs on
   the kernels against its stock-PyTorch form on the same inputs;
5. main-path shapes: each kernel once more on the inputs the tuned proxy
   gives it, against its plain version, timed, with its bound;
6. traces: one ``torch.profiler`` run each of the K-means step and the
   tuned proxy — wall time, device busy share, top device kernels.

The last lines are the kernel table as JSON, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  There is no CPU path: the
script exits non-zero without a CUDA device, and outside a checkout.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

#: H100 SXM peaks at the full 700 W limit (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# tolerances against the plain versions on the card:
#  matmul f32 — the same f32 products summed in another order;
#  matmul bf16 — one bf16 rounding of an f32 result may flip by an ulp;
#  row_moments — f32 sums reassociated across threads and splits;
#  sort — exact (a sort's output is unique).
TOL = {
    ("matmul", "float32"): dict(rtol=1e-4, atol=1e-4),
    ("matmul", "bfloat16"): dict(rtol=1e-2, atol=1e-2),
    ("row_moments", "float32"): dict(rtol=1e-4, atol=1e-5),
}

#: the main path's size: K-means at full scale (400,000 x 64 f32 points,
#: 32 centroids), tuned for the reference generate_proxy's default
#: ``max_iters``
SCALE = 1.0
MAX_ITERS = 24


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> "SystemExit":
    return SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same function
# ---------------------------------------------------------------------------


def bound(kind: str, args) -> tuple:
    """(bound_ms, bound_by) for one kernel call, from its inputs."""
    import math

    if kind == "matmul":
        x, y = args
        (m, k), n = x.shape, y.shape[1]
        es = x.element_size()
        ops = 2.0 * m * n * k
        nbytes = (m * k + k * n + m * n) * es
        peak = PEAK_FLOPS[str(x.dtype).replace("torch.", "")]
    elif kind == "row_moments":
        (x,) = args
        d = x.shape[-1]
        r = x.numel() // d
        ops = 2.0 * r * d
        nbytes = x.numel() * x.element_size() + 2 * r * 4
        peak = PEAK_FLOPS["float32"]
    else:  # bitonic_sort: read n keys, write the padded runs
        x, block = args
        n = x.shape[0]
        n_pad = n + (-n) % block
        # a comparison sort of each run needs about log2(block) compares
        # per key: the function's work, not the bitonic network's
        ops = float(n) * math.log2(block)
        nbytes = (n + n_pad) * x.element_size()
        peak = PEAK_FLOPS["float32"]
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_env(torch, dev) -> dict:
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    u = torch.randint(-(1 << 31), 1 << 31, (1024,), dtype=torch.int32,
                      device=dev).view(torch.uint32)
    probes = {
        "sort": lambda: torch.sort(u),
        "argsort_stable": lambda: torch.argsort(u, stable=True),
        "index": lambda: u[torch.arange(8, device=dev)],
        "xor": lambda: u ^ torch.ones((), dtype=torch.uint32, device=dev),
        "amin": lambda: torch.amin(u),
        "searchsorted": lambda: torch.searchsorted(torch.sort(u).values, u),
        "cat": lambda: torch.cat([u, u]),
        "full": lambda: torch.full((4,), 7, dtype=torch.uint32, device=dev),
        "eq": lambda: u == u,
        "to_int64": lambda: u.to(torch.int64),
        "to_float32": lambda: u.to(torch.float32),
        "from_int64": lambda: u.to(torch.int64).to(torch.uint32),
    }
    support = {}
    for name, fn in probes.items():
        try:
            fn()
            torch.cuda.synchronize()
            support[name] = True
        except (NotImplementedError, RuntimeError) as e:
            support[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:80]}"
    log(f"uint32 on the card: {json.dumps(support)}")
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(compiled={_build.BUILD_INFO['compiled']})")
    report = Path(_build.BUILD_INFO["path"]).with_name("ptxas.txt")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line.lower():
                log(f"  ptxas: {line.strip()}")
    return support


def check_kernel(torch, kind: str, args, iters: int = 20) -> dict:
    """One kernel against its plain version on the same inputs, timed."""
    from repro_torch.kernels import bitonic_sort, matmul, ref, rmsnorm
    from repro_torch.uint32 import bits, full

    row = {"kernel": kind, "shape": [list(a.shape) if hasattr(a, "shape")
                                     else a for a in args],
           "dtype": str(args[0].dtype).replace("torch.", "")}
    if kind == "matmul":
        x, y = args
        got = matmul.matmul(x, y)
        want = ref.matmul(x, y)
        tol = TOL[(kind, row["dtype"])]
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), **tol)
        row["ms"] = time_ms(torch, lambda: matmul.matmul(x, y), iters)
        row["plain_ms"] = time_ms(torch, lambda: ref.matmul(x, y), iters)
        row["library_ms"] = time_ms(torch, lambda: torch.matmul(x, y), iters)
    elif kind == "row_moments":
        (x,) = args
        gm, gq = rmsnorm.row_moments(x)
        wm, wq = ref.row_moments(x)
        tol = TOL[(kind, row["dtype"])]
        err = max((gm - wm).abs().max().item(), (gq - wq).abs().max().item())
        torch.testing.assert_close(gm, wm, **tol)
        torch.testing.assert_close(gq, wq, **tol)
        row["ms"] = time_ms(torch, lambda: rmsnorm.row_moments(x), iters)
        row["plain_ms"] = time_ms(torch, lambda: ref.row_moments(x), iters)
        row["library_ms"] = time_ms(
            torch, lambda: torch.var_mean(x, dim=-1, correction=0), iters)
    else:
        x, block = args
        sentinel = bitonic_sort.sort_sentinel(x.dtype).item()
        got = bitonic_sort.bitonic_sort_blocks(x, block=block)
        want = ref.sort_blocks(x, block, sentinel)
        if not torch.equal(got, want):
            bad = (bits(got) != bits(want)).nonzero()
            raise fail(f"bitonic_sort {row['dtype']} n={x.shape[0]} "
                       f"block={block}: {bad.numel()} keys differ, first at "
                       f"{bad[:4].flatten().tolist()}")
        err = 0.0
        row["ms"] = time_ms(
            torch, lambda: bitonic_sort.bitonic_sort_blocks(x, block=block),
            iters)
        row["plain_ms"] = time_ms(
            torch, lambda: ref.sort_blocks(x, block, sentinel), iters)
        # torch has no CUDA sort for uint32: no library call to time
        padded = torch.cat([x, full(((-x.shape[0]) % block,), sentinel,
                                    x.dtype, x.device)])
        row["library_ms"] = None if x.dtype == torch.uint32 else time_ms(
            torch, lambda: torch.sort(padded.view(-1, block), dim=-1), iters)
    row["max_abs_err"] = err
    row["bound_ms"], row["bound_by"] = bound(kind, args)
    return row


def fmt_row(r: dict) -> str:
    def f(v):
        return "n/a" if v is None else f"{v:.4f}"
    return (f"  {r['kernel']:12s} {r['dtype']:9s} {str(r['shape']):28s} "
            f"err={r['max_abs_err']:.3g} ms={f(r['ms'])} "
            f"plain={f(r['plain_ms'])} lib={f(r['library_ms'])} "
            f"bound={f(r['bound_ms'])} ({r['bound_by']})")


def phase_kernels(torch, dev) -> list:
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n in ((300, 200, 150), (4096, 64, 32), (129, 65, 257),
                        (65536, 2048, 8)):
            rows.append(check_kernel(torch, "matmul",
                                     (randn(m, k, dtype=dtype),
                                      randn(k, n, dtype=dtype))))
    rows.append(check_kernel(torch, "row_moments", (randn(64, 1 << 22),)))
    rows.append(check_kernel(torch, "row_moments", (randn(33, 70_001),)))
    for dtype in (torch.uint32, torch.int32, torch.float32, torch.bfloat16):
        for n, block in ((1 << 16, 4096), (100_003, 4096), (1 << 18, 1 << 16),
                         (70_001, 1 << 15)):
            if dtype in (torch.uint32, torch.int32):
                x = torch.randint(-(1 << 31), 1 << 31, (n,), generator=g,
                                  device=dev, dtype=torch.int32)
                x = x.view(torch.uint32) if dtype == torch.uint32 else x
            else:
                x = randn(n, dtype=dtype)
            rows.append(check_kernel(torch, "bitonic_sort", (x, block)))
    for r in rows:
        log(fmt_row(r))
    return rows


def phase_main(torch, dev):
    from repro_torch.core.generator import generate_proxy
    from repro_torch.kernels import ops
    from repro_torch.workloads import WORKLOADS

    w = WORKLOADS["kmeans"]
    args = w.inputs(seed=0, scale=SCALE, device=dev)
    x, c = args
    log(f"kmeans inputs: x {tuple(x.shape)} {x.dtype} "
        f"({x.numel() * x.element_size() / 1e6:.1f} MB, "
        f"{(x == 0).float().mean().item():.3f} zeros), centroids "
        f"{tuple(c.shape)}")
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    pb, rep = generate_proxy(w.step, *args, name="kmeans", hints=w.hints,
                             max_iters=MAX_ITERS, run=True,
                             substrate="hopper", device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"generate_proxy: {seconds:.1f} s  {rep.summary()}")
    log(f"  qualified={rep.qualified} mean_accuracy={rep.mean_accuracy:.4f} "
        f"evals={rep.evals} iterations={rep.iterations} "
        f"real_wall_s={rep.real_wall_time} proxy_wall_s={rep.proxy_wall_time} "
        f"speedup={rep.speedup}")
    log(f"  engine: {json.dumps(dict(rep.engine_stats))}")
    log(f"  {'metric':22s} {'target':>14s} {'proxy':>14s} accuracy")
    for k in rep.target_metrics:
        log(f"  {k:22s} {rep.target_metrics[k]:14.6g} "
            f"{rep.proxy_metrics[k]:14.6g} {rep.per_metric_accuracy[k]:.4f}")
    for n in pb.nodes:
        p = n.p
        log(f"  node {n.id} {n.motif}/{n.variant} data_size={p.data_size} "
            f"chunk_size={p.chunk_size} num_tasks={p.num_tasks} "
            f"weight={p.weight:.3f} batch_size={p.batch_size} "
            f"channels={p.channels} substrate={p.substrate}")
    log(f"launches over the main path: {json.dumps(counts)}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise fail(f"kernels never launched on the main path: {missing}")
    if not 0.0 <= rep.mean_accuracy <= 1.0:
        raise fail(f"mean accuracy {rep.mean_accuracy} outside [0, 1]")
    if {(n.motif, n.variant) for n in pb.nodes} != {
            (h.motif, h.variant) for h in w.hints}:
        raise fail("the tuned proxy lost a hinted motif")
    return pb, rep, counts, args


def phase_checks(torch, dev, pb, args) -> None:
    """The workload's and the tuned proxy's outputs, by the repo's means."""
    from repro_torch.workloads import WORKLOADS

    step = WORKLOADS["kmeans"].step
    cents, counts, inertia = step(*args)
    x, c = args
    if tuple(cents.shape) != tuple(c.shape) or counts.shape[0] != c.shape[0]:
        raise fail("kmeans step returned the wrong shapes")
    if not (torch.isfinite(cents).all() and torch.isfinite(inertia)):
        raise fail("kmeans step returned non-finite values")
    if int(counts.sum().item()) != x.shape[0]:
        raise fail("kmeans counts do not add up to the point count")
    if not bool((counts[1:] >= counts[:-1]).all()):
        raise fail("kmeans clusters are not ordered by size")
    # the same step on the host, on the same points
    hc, hn, hi = step(x.cpu(), c.cpu())
    if not torch.equal(hn, counts.cpu()):
        raise fail("kmeans counts differ between the card and the host")
    torch.testing.assert_close(cents.cpu(), hc, rtol=1e-4, atol=1e-4)
    log(f"checks: kmeans step finite, counts sum {x.shape[0]}, "
        f"equal to the host's; inertia {inertia.item():.6g} "
        f"(host {hi.item():.6g})")

    vals = pb.lifted_values(dev)
    got = pb.build_eval_fn(dev)(0, vals)
    want = pb.with_substrate("torch").build_eval_fn(dev)(0, vals)
    for nid in got:
        for key, g in got[nid].items():
            wv = want[nid][key]
            if g.shape != wv.shape or g.dtype != wv.dtype:
                raise fail(f"{nid}.{key}: {g.shape}/{g.dtype} vs "
                           f"{wv.shape}/{wv.dtype}")
            if g.dtype.is_floating_point:
                if not torch.isfinite(g).all():
                    raise fail(f"{nid}.{key} is not finite")
                torch.testing.assert_close(g, wv, rtol=1e-3, atol=1e-3)
                detail = f"max|d|={(g - wv).abs().max().item():.3g}"
            elif key == "assign":  # distance near-ties may pick another id
                frac = (g != wv).float().mean().item()
                if frac > 1e-3:
                    raise fail(f"{nid}.assign differs on {frac:.2%} rows")
                detail = f"differs on {frac:.2e} of rows"
            else:
                if not torch.equal(g.cpu(), wv.cpu()):
                    raise fail(f"{nid}.{key} differs between substrates")
                detail = "equal"
            log(f"checks: {nid}.{key} {tuple(g.shape)} {g.dtype} hopper vs "
                f"torch: {detail}")


class _Recorder:
    """Records the inputs the port's kernel ops receive (one run)."""

    def __init__(self, torch):
        from torch.utils._python_dispatch import TorchDispatchMode

        from repro_torch.kernels import ops

        # each wrapper is named like its custom op
        by_op = {k.wrapper.__name__: name for name, k in ops.KERNELS.items()}
        calls = self.calls = {}

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.namespace == "repro_torch":
                    name = by_op[func.overloadpacket.__name__]
                    kept = tuple(a.clone() if isinstance(a, torch.Tensor)
                                 else a for a in args)
                    size = sum(a.numel() for a in kept
                               if isinstance(a, torch.Tensor))
                    if name not in calls or size > calls[name][0]:
                        calls[name] = (size, kept)
                return func(*args, **(kwargs or {}))

        self.mode = Mode()


def phase_main_shapes(torch, dev, pb, counts) -> list:
    """Each kernel on the largest inputs the tuned proxy gives it."""
    from repro_torch.kernels import ops

    rec = _Recorder(torch)
    vals = pb.lifted_values(dev)
    with rec.mode:
        pb.build_eval_fn(dev)(0, vals)
    entries = []
    for name, kernel in ops.KERNELS.items():
        if name not in rec.calls:
            raise fail(f"the tuned proxy gave {name} no input")
        args = rec.calls[name][1]
        if name == "matmul":
            args = tuple(args[:2])
        elif name == "row_moments":
            args = (args[0],)
        r = check_kernel(torch, name, tuple(args), iters=50)
        log("main-path shape:" + fmt_row(r)[1:])
        entries.append({
            "name": name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "dtype": r["dtype"]})
    return entries


def _device_ms(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    if us is None:
        us = getattr(event, "self_cuda_time_total", 0.0)
    return us / 1e3


def phase_trace(torch, dev, name: str, fn) -> None:
    """Wall time of ``fn`` (median of 5, no profiler), and one profiled run
    for the device's busy time (sum of its kernels) and top kernels."""
    import statistics

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"trace {name}: wall {wall_ms:.3f} ms; device time not measured "
            f"(the profiler saw no kernel)")
        return
    busy = sum(_device_ms(e) for e in kernels)
    log(f"trace {name}: wall {wall_ms:.3f} ms (median of 5, no profiler), "
        f"device busy {busy:.3f} ms = {busy / wall_ms:.1%} of wall, "
        f"{sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=_device_ms, reverse=True)[:6]:
        log(f"  {_device_ms(e):9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="env,kernels,main",
                    help="comma list of env, kernels, main (main includes "
                         "the checks and main-path shapes)")
    opts = ap.parse_args(argv)
    phases = set(opts.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only "
              "on a GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    phase_env(torch, dev)  # always: the build is every phase's set-up
    if "kernels" in phases:
        phase_kernels(torch, dev)
    entries = []
    if "main" in phases:
        pb, rep, counts, args = phase_main(torch, dev)
        phase_checks(torch, dev, pb, args)
        entries = phase_main_shapes(torch, dev, pb, counts)
        from repro_torch.workloads import WORKLOADS

        phase_trace(torch, dev, "kmeans step",
                    lambda: WORKLOADS["kmeans"].step(*args))
        vals = pb.lifted_values(dev)
        proxy_fn = pb.build_eval_fn(dev)
        phase_trace(torch, dev, "tuned proxy", lambda: proxy_fn(0, vals))
        log("kernels: " + ", ".join(f"{e['name']}={e['launches']}"
                                    for e in entries))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
