"""The measurements the port's launch choices rest on, on the card.

    PYTHONPATH=src python -m repro_torch.bench.thresholds

Prints the card's name and power limit, then one JSON line per
measurement:

- ``binding``: host µs a call of an op whose body does nothing, defined
  each way ``torch.library`` offers (``custom_op``; a ``Library`` with
  ``define`` plus ``impl`` on the CPU and CUDA keys, as
  ``kernels._build.define_op`` registers the kernels) and called as a
  plain Python function, on a CUDA tensor; then the whole call of the
  matmul and row-moments ops at a tiny shape.
- ``row_moments``: the one-launch form against the split form at f32
  shapes from 0.25 to 64 MiB, ms a call (CUDA events over back-to-back
  calls, each with its allocations, as the wrapper makes them) and
  device ms a call (``torch.profiler``), for
  ``kernels.rmsnorm.ONE_LAUNCH_BYTES``.
- ``matmul_order``: at ``chip_smoke.py``'s f32 shapes with K = 2048,
  each form's difference from ``torch.matmul`` and from a float64
  product, and the kernels ``torch.matmul`` runs (its summation order).
- ``matmul``: the narrow form against the wide form at N up to 32 (ms a
  call, the same way), for ``kernels.matmul.NARROW_N``.
- ``matmul_split``: the split form against the wide form and
  ``torch.matmul`` at few rows (M from 1 to 128), K from 256 to 2048 and
  N from 2048 to past the split form's reach (ms a call, the same way,
  and device ms), with its slices and each one's difference from a
  float64 product, for ``kernels.matmul.SPLIT_MAX_M`` and
  ``SPLIT_MIN_K``.

Every forced row-moments call is checked against the plain version
first; each matmul form reports its largest difference from the plain
version and from a float64 product (the plain version sums in cuBLAS's
order, which may split K).  Needs a
CUDA card and ``nvcc`` (the kernels build at first use).
"""
from __future__ import annotations

import json
import subprocess
import time

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import rmsnorm as rm

BINDING_CALLS = 20_000
ITERS = 50
MIB = 1 << 20
ROW_MOMENTS_ROWS = (8, 33, 64, 128)
ROW_MOMENTS_BYTES = (MIB // 4, MIB, 2 * MIB, 4 * MIB, 8 * MIB, 16 * MIB,
                     64 * MIB)
MATMUL_SHAPES = ((65536, 2048), (12288, 2048), (4096, 64))
MATMUL_NS = (2, 8, 16, 24, 32)
SPLITS = (2, 3, 4, 8, 16, 32)
SPLIT_MS = (1, 32, 64, 96, 128)
SPLIT_KS = (256, 512, 1024, 2048)
SPLIT_NS = (2048, 8448, 16384)
ORDER_SHAPES = ((12288, 2048, 128), (32768, 2048, 128), (65536, 2048, 2),
                (65536, 2048, 8), (65536, 2048, 32), (65536, 2048, 33),
                (12288, 2048, 32))


def emit(kind: str, **row) -> None:
    print(json.dumps({"kind": kind, **row}), flush=True)


def host_us(fn, calls: int = BINDING_CALLS) -> float:
    """Host µs a call over ``calls`` back-to-back calls, after a warm-up."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def time_ms(fn, iters: int = ITERS) -> float:
    """Mean ms a call over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(3):
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


def device_ms(fn, iters: int = ITERS) -> float:
    """Device ms a call: the kernels' summed time over one
    ``torch.profiler`` run of ``iters`` back-to-back calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


def binding(dev: torch.device) -> None:
    x = torch.zeros(8, device=dev)
    out = torch.zeros(8, device=dev)

    def empty(t: torch.Tensor) -> torch.Tensor:
        return out

    lib = torch.library.Library("repro_torch_probe", "DEF")
    lib.define("empty_lib(Tensor x) -> Tensor")
    for key in ("CPU", "CUDA"):
        lib.impl("empty_lib", empty, key)
    torch.library.custom_op("repro_torch_probe::empty_custom",
                            mutates_args=())(empty)
    probe = torch.ops.repro_torch_probe
    rows = {"direct": host_us(lambda: empty(x)),
            "library": host_us(lambda: probe.empty_lib(x)),
            "custom_op": host_us(lambda: probe.empty_custom(x))}
    # the other order as well, for the spread between two runs
    rows["custom_op_2"] = host_us(lambda: probe.empty_custom(x))
    rows["library_2"] = host_us(lambda: probe.empty_lib(x))
    emit("binding", us_per_call=rows,
         library_saves_us=(rows["custom_op"] + rows["custom_op_2"]
                           - rows["library"] - rows["library_2"]) / 2)
    # the whole call of two kernel ops at a tiny shape, its parts, and the
    # library calls that compute the same functions
    a = torch.randn(8, 8, device=dev)
    ptr, stream = a.data_ptr(), _build.stream_ptr(a.device)
    parts = {
        "matmul_op": lambda: mm.matmul(a, a),
        "row_moments_op": lambda: rm.row_moments(a),
        "matmul_body": lambda: mm.launch_matmul(a, a),
        "row_moments_body": lambda: rm.launch_row_moments(a, 1),
        "c_launch_only": lambda: _build.call(
            "repro_row_moments", 0, ptr, None, out.data_ptr(),
            out.data_ptr(), 1, 8, 1, stream),
        "torch_empty": lambda: torch.empty(8, device=dev),
        "stream_ptr": lambda: _build.stream_ptr(a.device),
        "current_stream_object": lambda: torch.cuda.current_stream(
            a.device).cuda_stream,
        "data_ptr": lambda: a.data_ptr(),
        "tensor_device": lambda: a.device,
        "torch_matmul": lambda: torch.matmul(a, a),
        "torch_var_mean": lambda: torch.var_mean(a, dim=-1, correction=0),
    }
    emit("binding_ops", us_per_call={k: host_us(f, 5000)
                                     for k, f in parts.items()})


def row_moments(dev: torch.device) -> None:
    g = torch.Generator(device=dev).manual_seed(0)
    for rows in ROW_MOMENTS_ROWS:
        for nbytes in ROW_MOMENTS_BYTES:
            d = nbytes // (4 * rows)
            x = torch.randn(rows, d, generator=g, device=dev)
            splits = rm.fill_splits(rows, d)
            want = ref.row_moments(x)
            row = {}
            for name, s in (("one_launch", 1), ("split", splits)):
                for got, w in zip(rm.launch_row_moments(x, s), want):
                    torch.testing.assert_close(got, w, rtol=1e-4, atol=1e-5)
                call = lambda: rm.launch_row_moments(x, s)  # noqa: E731
                row[name + "_ms"] = time_ms(call)
                row[name + "_device_ms"] = device_ms(call)
            emit("row_moments", shape=[rows, d], mib=nbytes / MIB,
                 splits=splits, chosen=rm.form(x), **row)


def matmul(dev: torch.device) -> None:
    g = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for m, k in MATMUL_SHAPES:
            x = torch.randn(m, k, generator=g, device=dev).to(dtype)
            for n in MATMUL_NS:
                y = torch.randn(k, n, generator=g, device=dev).to(dtype)
                want = ref.matmul(x, y).float()
                exact = torch.matmul(x.double(), y.double())
                row = {}
                for form in ("narrow", "wide"):
                    got = mm.launch_matmul(x, y, form).float()
                    row[form + "_err"] = (got - want).abs().max().item()
                    row[form + "_err_f64"] = (
                        got.double() - exact).abs().max().item()
                    row[form + "_ms"] = time_ms(
                        lambda: mm.launch_matmul(x, y, form))
                row["torch_err_f64"] = (want.double() - exact).abs().max().item()
                row["torch_matmul_ms"] = time_ms(lambda: torch.matmul(x, y))
                emit("matmul", shape=[m, k, n],
                     dtype=str(dtype).replace("torch.", ""),
                     chosen=mm.form(x, y), **row)


def matmul_split(dev: torch.device) -> None:
    """The split form against the wide one, both forced, in f32 (the AI
    proxies' type) and at the AI proxies' shape in bf16, beside
    ``torch.matmul``; each form's largest difference from the plain
    version and from a float64 product (the split form sums K's slices
    in rank order, the wide one in k order, cuBLAS in its own)."""
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = [(m, k, n, torch.float32) for m in SPLIT_MS for k in SPLIT_KS
              for n in SPLIT_NS] + [(32, 2048, 2048, torch.bfloat16)]
    for m, k, n, dtype in shapes:
        x = torch.randn(m, k, generator=g, device=dev).to(dtype)
        y = torch.randn(k, n, generator=g, device=dev).to(dtype)
        want = ref.matmul(x, y).float()
        exact = torch.matmul(x.double(), y.double())
        row = {}
        for form in ("wide", "split"):
            got = mm.launch_matmul(x, y, form).float()
            row[form + "_err"] = (got - want).abs().max().item()
            row[form + "_err_f64"] = (got.double() - exact).abs().max().item()
            call = lambda: mm.launch_matmul(x, y, form)  # noqa: E731
            row[form + "_ms"] = time_ms(call)
            row[form + "_device_ms"] = device_ms(call)
        row["torch_err_f64"] = (want.double() - exact).abs().max().item()
        row["torch_matmul_ms"] = time_ms(lambda: torch.matmul(x, y))
        row["torch_matmul_device_ms"] = device_ms(lambda: torch.matmul(x, y))
        emit("matmul_split", shape=[m, k, n],
             dtype=str(dtype).replace("torch.", ""),
             slices=mm.split_slices(m, n, k), chosen=mm.form(x, y), **row)


def library_kernels(fn) -> list:
    """Names of the device kernels one call of ``fn`` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key[:100] for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def matmul_orders(dev: torch.device) -> None:
    """At ``chip_smoke.py``'s f32 shapes with K = 2048: each form's largest
    difference from ``torch.matmul`` and from a float64 product, how many
    outputs lie outside chip_smoke's tolerance (``rtol=atol=1e-4``) of
    ``torch.matmul``, and the kernels ``torch.matmul`` runs there."""
    g = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in ORDER_SHAPES:
        x = torch.randn(m, k, generator=g, device=dev)
        y = torch.randn(k, n, generator=g, device=dev)
        want = torch.matmul(x, y)
        exact = torch.matmul(x.double(), y.double())
        forms = {}
        for form in ("narrow", "wide") if n <= mm.NARROW_N else ("wide",):
            got = mm.launch_matmul(x, y, form)
            diff = (got - want).abs()
            forms[form] = {
                "err": diff.max().item(),
                "err_f64": (got.double() - exact).abs().max().item(),
                "outside_tol": int((diff > 1e-4 + 1e-4 * want.abs()).sum())}
        # torch.matmul's order where it is not the k order: K cut in S
        # slices (of whole 8-wide steps), each summed in k order (the wide
        # form on the slice), the slice sums added in order; the count of
        # outputs that differ from torch.matmul's bits, for each S
        split = {}
        if forms[min(forms)]["err"] > 0:
            for parts in SPLITS:
                step = -(-k // parts // 8) * 8
                total = None
                for lo in range(0, k, step):
                    p = mm.launch_matmul(x[:, lo:lo + step].contiguous(),
                                         y[lo:lo + step].contiguous(), "wide")
                    total = p if total is None else total + p
                split[parts] = int((total != want).sum())
        emit("matmul_order", shape=[m, k, n],
             torch_repeats=bool(torch.equal(want, torch.matmul(x, y))),
             split_mismatches=split,
             torch_err_f64=(want.double() - exact).abs().max().item(),
             torch_kernels=library_kernels(lambda: torch.matmul(x, y)),
             forms=forms)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("thresholds: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    _build.library()
    binding(dev)
    matmul_orders(dev)
    row_moments(dev)
    matmul(dev)
    matmul_split(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
