"""Flash attention's f32 tiled form at other key tiles and unrollings.

Builds copies of ``kernels/csrc/flash_attention.cu``, each into its own
library: as it is (``tree``), and with another key tile ``BK``, another
unrolling of the score loop's 4-wide d steps (``D_UNROLL``), of the PV
loop's keys (``PV_UNROLL``) or of a tile load's chunks (``LOAD_UNROLL``)
at one padded width, a run-time D that scores every padded column
(``SCORE_DP``), or another widest width whose full-width head runs a copy
with D fixed at compile time (``fixed``).  Prints ptxas's registers and
spills of each copy's f32 kernels, then times every copy with CUDA events
(``ITERS`` launches, in turns, ``ROUNDS`` times) at deepseek-v2-lite-16b's
MLA prefill width and gemma2-9b's head width, f32, causal:

    PYTHONPATH=src python -m repro_torch.bench.flash_tiles

Each copy is first checked against the custom op on the same inputs
(``rtol=2e-3, atol=2e-4``, the f32 tolerance of ``chip_smoke.py``); a
copy that ptxas spills in is timed all the same.  Needs ``nvcc`` and a
CUDA card; the copies land in ``kernels/_build/``.
"""
from __future__ import annotations

import json
import math
import re

import torch

from repro_torch.bench import _variants
from repro_torch.kernels import _build, flash_attention

#: (B, S, H, D) of each timed shape, f32, causal
SHAPES = ((1, 4096, 16, 192), (1, 4096, 16, 256))
ROUNDS = 2
ITERS = 10
#: name -> {padded width: {Shape constant: value}}, and "fixed": the
#: widest padded width whose full-width head runs a copy with D fixed at
#: compile time (the tree's where absent)
VARIANTS = {
    "tree": {},
    "runtime_192": {"fixed": 128},
    "bk32_192": {192: {"BK": 32}},
    "fixed_256": {"fixed": 256},
    "score_d_256": {256: {"SCORE_DP": 0}},
    "load64_256": {256: {"LOAD_UNROLL": 64}},
    "pv8_256": {256: {"PV_UNROLL": 8}},
    "d4_256": {256: {"D_UNROLL": 4}},
}
_FIXED = re.compile(r"(  if constexpr \(DP <= )(\d+)(\)\n    if \(D == DP\) "
                    r"kernel = flash_f32<DP, true>;)")


def variant_source(src: str, change: dict) -> str:
    """The kernel source with one variant's change."""
    if "fixed" in change:
        head, tiled, tail = _variants.namespace_parts(src, "tiled")
        if len(_FIXED.findall(tiled)) != 1:
            raise ValueError("flash_attention.cu lacks the tiled launch's "
                             "fixed-D line, or has it twice")
        tiled = _FIXED.sub(rf"\g<1>{change['fixed']}\g<3>", tiled)
        src = f"{head}namespace tiled {{{tiled}}}  // namespace tiled{tail}"
    for dp, consts in change.items():
        if dp != "fixed":
            src = _variants.set_constants(
                src, "tiled", "  static constexpr int {name} = ",
                {name: (lambda old, dp=dp, v=v: f"DP == {dp} ? {v} : {old}")
                 for name, v in consts.items()})
    return src


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("flash_tiles: needs a CUDA card")
    print(_variants.card(), flush=True)
    src = (_build.CSRC / "flash_attention.cu").read_text()
    fns = _variants.build_copies(
        _build.BUILD_ROOT / f"tiles-{_build.source_digest()}",
        {name: variant_source(src, change)
         for name, change in VARIANTS.items()},
        "repro_flash_attention", "flash_f32")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    stream = _build.stream_ptr(dev)
    for shape in SHAPES:
        b, s, h, d = shape
        q, k, v = (torch.randn(*shape, generator=g, device=dev)
                   for _ in range(3))
        want = flash_attention.flash_attention(q, k, v, causal=True)
        out = torch.empty_like(q)
        args = (_build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, s, s, h, d,
                1.0 / math.sqrt(d), 1, stream)
        for name, fn in fns.items():
            if fn(*args) != 0:
                raise SystemExit(f"flash_tiles: {name} failed to launch")
            torch.testing.assert_close(out, want, rtol=2e-3, atol=2e-4)
        for rnd in range(ROUNDS):
            names = list(fns) if rnd % 2 == 0 else list(fns)[::-1]
            for name in names:
                ms = _variants.time_ms(lambda: fns[name](*args), ITERS)
                print(json.dumps({"variant": name, "round": rnd,
                                  "shape": list(shape), "dtype": "float32",
                                  "causal": True, "ms": ms}), flush=True)
        del q, k, v, want, out
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
