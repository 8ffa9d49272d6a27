"""The matmul's split form at other slabs, rings and occupancies.

Builds copies of ``kernels/csrc/matmul.cu``, each into its own library:
as it is (``tree``), and with other constants of its ``split``
namespace: the tile's columns (``BN``), the most slices of K
(``MAX_SLICES``, the cluster's size), the blocks it aims for
(``BLOCKS``), the tile's rows (``BM``), the k of a slab (``BK``), the
slabs in the ring (``STAGES``), the blocks an SM its registers are
bounded for (``MIN_BLOCKS``).  Prints ptxas's registers and spills of
each copy's split kernels, then times every copy's split form (form code 3) with
CUDA events (``ITERS`` launches, in turns, ``ROUNDS`` times) at the AI
proxies' fully_connected and beside it:

    PYTHONPATH=src python -m repro_torch.bench.split_tiles

Each copy is first checked against the plain version on the same inputs
(``rtol=atol=1e-4`` in f32, ``1e-2`` in bf16, ``chip_smoke.py``'s).
Needs ``nvcc`` and a CUDA card; the copies land in ``kernels/_build/``.
"""
from __future__ import annotations

import json

import torch

from repro_torch.bench import _variants
from repro_torch.kernels import _build, ref
from repro_torch.kernels import matmul as mm

#: (M, K, N, dtype) of each timed product
SHAPES = ((32, 2048, 2048, torch.float32), (1, 2048, 2048, torch.float32),
          (64, 2048, 2048, torch.float32), (32, 2048, 2048, torch.bfloat16))
ROUNDS = 2
ITERS = 50
#: name -> {split constant: value}
VARIANTS = {
    "tree": {},
    "bn128_w1": {"BN": 128, "BLOCKS": 132, "MIN_BLOCKS": 2},
    "w2": {"BLOCKS": 264},
    "bm16_w4": {"BM": 16, "BLOCKS": 528, "MIN_BLOCKS": 4},
    "stages3": {"STAGES": 3},
    "stages8": {"STAGES": 8},
    "bk64": {"BK": 64, "STAGES": 3},
}


def variant_source(src: str, change: dict) -> str:
    """The kernel source with one variant's constants."""
    return _variants.set_constants(
        src, "split", "constexpr (?:int|long long) {name} = ",
        {name: (lambda old, v=v: str(v)) for name, v in change.items()})


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("split_tiles: needs a CUDA card")
    print(_variants.card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    src = (_build.CSRC / "matmul.cu").read_text()
    fns = _variants.build_copies(
        _build.BUILD_ROOT / f"split-{_build.source_digest()}",
        {name: variant_source(src, change)
         for name, change in VARIANTS.items()},
        "repro_matmul_lanes", "split")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    stream = _build.stream_ptr(dev)
    for m, k, n, dtype in SHAPES:
        x = torch.randn(m, k, generator=g, device=dev).to(dtype)
        y = torch.randn(k, n, generator=g, device=dev).to(dtype)
        want = ref.matmul(x, y).float()
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        out = torch.empty(m, n, dtype=dtype, device=dev)
        args = (_build.DTYPE_CODES[dtype], mm.FORM_CODES["split"],
                x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k, 1, 0, 0,
                0, stream)
        for name, fn in fns.items():
            if fn(*args) != 0:
                raise SystemExit(f"split_tiles: {name} failed to launch")
            torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)
        for rnd in range(ROUNDS):
            names = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for name in names:
                ms = _variants.time_ms(lambda: fns[name](*args), ITERS)
                print(json.dumps({
                    "variant": name, "round": rnd, "shape": [m, k, n],
                    "dtype": str(dtype).replace("torch.", ""), "ms": ms}),
                    flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
