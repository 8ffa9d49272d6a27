"""Where MoE dispatch's tensor-core form spends its time, on the card.

Builds three copies of ``kernels/csrc/moe_dispatch.cu``, each into its
own library: as it is (``full``); with the main loop's slab refills cut
out (``no_refill``: the tensor cores and barriers alone, on the stale
tiles of the first slabs); and with its wgmma cut out (``no_wgmma``: the
loads alone).  The source marks both cuts with ``// breakdown:``
comments.  Each copy is timed with CUDA events (``ITERS`` launches) at
deepseek-v2-lite-16b's MoE group (T 4096, E 64, C 480, D 2048, bf16 x)
with the routed f32 mask and with the same mask cast to bf16, in turns,
``ROUNDS`` times:

    PYTHONPATH=src python -m repro_torch.bench.moe_breakdown

Prints the card's name and power limit, then one JSON line per timing.
The ``full`` copy is checked against the custom op on the same inputs.
Needs ``nvcc`` and a CUDA card; the copies land in ``kernels/_build/``.
"""
from __future__ import annotations

import json
from typing import Dict

import torch

from repro_torch.bench import _variants
from repro_torch.kernels import _build, moe_dispatch

#: the markers in moe_dispatch.cu: the main loop's refill of the ring
#: lies between the first two lines, the third ends the wgmma's line
REFILL = ("// breakdown: refill begin", "// breakdown: refill end")
MMA = "// breakdown: wgmma"
SHAPE = (4096, 64, 480, 2048)
ROUNDS = 3
ITERS = 20


def variant_sources(src: str) -> Dict[str, str]:
    """The kernel source as it is and with the refill or wgmma cut out."""
    lines = src.splitlines(keepends=True)
    marks = [[i for i, line in enumerate(lines) if m in line]
             for m in (*REFILL, MMA)]
    if any(len(m) != 1 for m in marks):
        raise ValueError("moe_dispatch.cu lacks one of its breakdown "
                         f"markers, or has it twice: {marks}")
    (start,), (end,), (mma,) = marks
    no_refill = lines[:start] + ["#if 0\n"] + lines[start:end] \
        + ["#endif\n"] + lines[end:]
    no_wgmma = lines[:mma] + ["(void)da;\n(void)db;\n"] + lines[mma + 1:]
    return {"full": src, "no_refill": "".join(no_refill),
            "no_wgmma": "".join(no_wgmma)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("moe_breakdown: needs a CUDA card")
    print(_variants.card(), flush=True)
    fns = _variants.build_copies(
        _build.BUILD_ROOT / f"breakdown-{_build.source_digest()}",
        variant_sources((_build.CSRC / "moe_dispatch.cu").read_text()),
        "repro_moe_dispatch", "dispatch")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    t, e, c, d = SHAPE
    ids = torch.randint(0, e, (t,), generator=g, device=dev)
    routed = moe_dispatch.make_dispatch_mask(ids, e, c)
    x = torch.randn(t, d, generator=g, device=dev).to(torch.bfloat16)
    out = torch.empty(e, c, d, dtype=torch.bfloat16, device=dev)
    stream = _build.stream_ptr(dev)
    for mask in (routed, routed.to(torch.bfloat16)):
        args = (_build.DTYPE_CODES[mask.dtype], _build.DTYPE_CODES[x.dtype],
                mask.data_ptr(), x.data_ptr(), out.data_ptr(), t, e, c, d,
                stream)
        if fns["full"](*args) != 0:
            raise SystemExit("moe_breakdown: the full copy failed to launch")
        if not torch.equal(out, moe_dispatch.moe_dispatch(mask, x)):
            raise SystemExit("moe_breakdown: the full copy disagrees with "
                             "the custom op")
        for rnd in range(ROUNDS):
            for name, fn in fns.items():
                ms = _variants.time_ms(lambda: fn(*args), ITERS)
                print(json.dumps({"variant": name, "round": rnd,
                                  "mask": str(mask.dtype).replace("torch.", ""),
                                  "shape": list(SHAPE), "ms": ms}),
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
