"""The production use-case: a proxy benchmark for a pod-scale model (port
of ``examples/proxy_for_pod_model.py``).

A full qwen3-4b train step on 256 GPUs cannot run on one card, but one
rank's signature of it can be taken (the dry run), and the paper's
methodology then builds a proxy that runs on the card and whose
signature matches it.  Architecture studies iterate on the proxy in
seconds instead of cluster hours: the paper's simulation-time argument.

The pod signature is the ATen profile of rank 0 of a fake 256-rank world
running the ``train_4k`` step on DTensors (``repro_torch.launch.dryrun``:
flops, bytes, op mix and collective bytes by kind, and the peak of live
bytes), where the reference reads the cost analysis of the compiled HLO.
The dry run runs in a subprocess, as the reference's does, so its fake
world never meets the device ``generate_proxy`` runs on.

  PYTHONPATH=src python -m repro_torch.bench.proxy_for_pod_model \\
      [--arch qwen3-4b] [--iters 12] [--substrate hopper] [--device cpu]

``--mesh DxM`` and ``--reduce N`` shrink the dry run (a (D, M) world, the
config reduced N x by ``launch.train.reduce_config``) for a quick check.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Optional, Tuple

from repro_torch.core import MotifHint, Signature, generate_proxy
from repro_torch.core.motifs import PVector

DRYRUN = """
import json
from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.launch.dryrun import fake_mesh, lower_cell
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.train import reduce_config

cfg = reduce_config(get_config({arch!r}), {reduce})
shape, names = {mesh!r} or production_shape(False)
with fake_mesh(shape, names) as mesh:
    lowered, aux = lower_cell(cfg, SHAPES_BY_NAME["train_4k"], mesh)
    sig = lowered.compile().signature
print("SIGJSON::" + json.dumps({{
    "flops": sig.flops, "bytes": sig.bytes,
    "transcendentals": sig.transcendentals,
    "op_mix": sig.op_mix, "collective_bytes": sig.collective_bytes,
    "dot_flops": sig.dot_flops, "conv_flops": sig.conv_flops,
    "peak_memory": sig.peak_memory}}))
"""

# LM train step decomposition (Table III analog for transformers)
LM_HINTS = (
    MotifHint("matrix", "matmul"),          # QKV/O/MLP projections
    MotifHint("statistics", "softmax"),     # attention + losses + norms
    MotifHint("logic", "relu"),             # gating nonlinearities
    MotifHint("sampling", "topk"),          # (MoE archs route; dense ~0)
)


def pod_signature(arch: str, mesh: Optional[Tuple[int, int]] = None,
                  reduce: int = 1, timeout: float = 1200.0) -> Signature:
    """Rank 0's signature of ``arch``'s ``train_4k`` step on the
    single-pod production mesh (or a ``(data, model)`` ``mesh``), from a
    dry-run subprocess."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    m = (tuple(mesh), ("data", "model")) if mesh else None
    r = subprocess.run(
        [sys.executable, "-c",
         DRYRUN.format(arch=arch, reduce=int(reduce), mesh=m)],
        capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "PYTHONPATH": src})
    if r.returncode != 0:
        raise RuntimeError(f"dry run failed: {r.stderr[-2000:]}")
    line = [x for x in r.stdout.splitlines() if x.startswith("SIGJSON::")][0]
    d = json.loads(line[len("SIGJSON::"):])
    return Signature(flops=d["flops"], bytes=d["bytes"],
                     transcendentals=d["transcendentals"],
                     op_mix=d["op_mix"],
                     collective_bytes=d["collective_bytes"],
                     dot_flops=d["dot_flops"], conv_flops=d["conv_flops"],
                     peak_memory=d["peak_memory"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--substrate", default="torch",
                    help="torch (stock ATen) or hopper (the hand-written "
                         "kernels)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="DxM: a (data, model) fake world instead of the "
                         "16x16 production mesh")
    ap.add_argument("--reduce", type=int, default=1,
                    help="shrink the config this many times (1: full)")
    args = ap.parse_args(argv)
    mesh = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None
    world = "x".join(map(str, mesh)) if mesh else "16x16"

    print(f"[1/2] extracting pod-scale signature for {args.arch} "
          f"(dry-run subprocess, one rank of a fake {world} world)...")
    sig = pod_signature(args.arch, mesh, args.reduce)
    print(f"      flops/dev={sig.flops:.3e} bytes/dev={sig.bytes:.3e} "
          f"AI={sig.arith_intensity:.2f}")

    print("[2/2] generating a proxy tuned to that signature...")
    proxy, report = generate_proxy(
        None, name=f"proxy-{args.arch}-pod",
        hints=LM_HINTS,
        base_p=PVector(data_size=1 << 13, chunk_size=512, num_tasks=4),
        target_signature=sig,
        run=False,                      # profile-metric tuning (no pod!)
        max_iters=args.iters,
        substrate=args.substrate,
        device=args.device,
    )
    print(report.summary())
    for k, acc in sorted(report.per_metric_accuracy.items()):
        print(f"  {k:22s} tgt={report.target_metrics[k]:10.4g} "
              f"proxy={report.proxy_metrics[k]:10.4g} acc={acc:.1%}")
    print("\nproxy DAG:", [f"{n.motif}:{n.variant}" for n in proxy.nodes])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
