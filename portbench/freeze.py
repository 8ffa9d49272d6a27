"""Tune one workload's proxy with the port's ``generate_proxy`` and freeze
it as a benchmark configuration.

    python3 portbench/freeze.py --workload kmeans --commit <sha> \
        --call <chip call> --scale 1.0 --max-iters 96 \
        --out portbench/configs/kmeans.json

Runs on a CUDA card: the workload's inputs at ``--scale`` from seed 0,
tuned by ``generate_proxy`` (tuner seed 0, ``tol`` 0.15) for at most
``--max-iters`` iterations on ``--substrate``.  Prints the provenance and
the proxy's nodes and writes ``--out``; exits 1 when the tuner did not
qualify the proxy (some selected metric is not within ``tol`` of the
workload's), which the file's provenance records too.  The file holds the tuned proxy
as :meth:`ProxyBenchmark.to_json` writes it, the source it stands for and
how it was made.  The benchmark never runs this script: a configuration,
once frozen, is data.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: what each configuration stands for: the paper's workload and settings
SOURCES = {
    "kmeans": ("arXiv:1810.09376 (Data Motif-based Proxy Benchmarks), "
               "Table III: Hadoop K-means, motifs matrix/euclidean, "
               "statistics/average, sort/quick"),
    "alexnet": ("arXiv:1810.09376 (Data Motif-based Proxy Benchmarks), "
                "Table III: TensorFlow AlexNet on CIFAR-10, batch 128, "
                "32x32x3"),
    "pagerank": ("arXiv:1810.09376 (Data Motif-based Proxy Benchmarks), "
                 "Table III: Hadoop PageRank, motifs matrix/construct, "
                 "graph/pagerank_iter, sort/minmax, statistics/degree"),
    "terasort": ("arXiv:1810.09376 (Data Motif-based Proxy Benchmarks), "
                 "Table III: Hadoop TeraSort, motifs sort/quick, "
                 "sampling/interval, graph/construct"),
    "inception_v3": ("arXiv:1810.09376 (Data Motif-based Proxy "
                     "Benchmarks), Table III: TensorFlow Inception-V3 on "
                     "ILSVRC2012"),
}
#: what every tuning shares: the inputs' seed, the tuner's, its tolerance
FIXED = {"input_seed": 0, "tuner_seed": 0, "tol": 0.15}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, choices=sorted(SOURCES))
    ap.add_argument("--commit", required=True,
                    help="the commit of the port that tunes")
    ap.add_argument("--call", required=True,
                    help="which chip call tuned it, for the provenance")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="the workload's size, as its make_inputs takes it")
    ap.add_argument("--max-iters", type=int, default=24)
    ap.add_argument("--substrate", default="hopper",
                    choices=("hopper", "torch"))
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    settings = {"scale": args.scale, "max_iters": args.max_iters,
                "substrate": args.substrate, **FIXED}

    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.utils._pytree import tree_leaves

    from repro_torch.core.generator import generate_proxy
    from repro_torch.workloads import WORKLOADS

    if not torch.cuda.is_available():
        raise SystemExit("freeze: no CUDA device")
    dev = torch.device("cuda")
    w = WORKLOADS[args.workload]
    inputs = w.inputs(seed=settings["input_seed"], scale=settings["scale"],
                      device=dev)
    t0 = time.perf_counter()
    pb, rep = generate_proxy(w.step, *inputs, name=args.workload,
                             hints=w.hints, max_iters=settings["max_iters"],
                             tol=settings["tol"], run=True,
                             seed=settings["tuner_seed"],
                             substrate=settings["substrate"], device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    doc = {
        "name": args.workload,
        "source": SOURCES[args.workload],
        "precision": "float32, products and convolutions with TF32 off",
        "proxy": json.loads(pb.to_json()),
        "provenance": {
            "tuned_by": "repro_torch.core.generator.generate_proxy",
            "commit": args.commit,
            "chip_call": args.call,
            "card": card(),
            "torch": torch.__version__,
            "workload": args.workload,
            **settings,
            "input_bytes": sum(int(t.numel()) * t.element_size()
                               for t in tree_leaves(inputs)
                               if isinstance(t, torch.Tensor)),
            "iterations": rep.iterations,
            "evals": rep.evals,
            "qualified": rep.qualified,
            "mean_accuracy": rep.mean_accuracy,
            "per_metric_accuracy": dict(rep.per_metric_accuracy),
            "target_metrics": dict(rep.target_metrics),
            "proxy_metrics": dict(rep.proxy_metrics),
            "real_wall_s": rep.real_wall_time,
            "proxy_wall_s": rep.proxy_wall_time,
            "speedup": rep.speedup,
            "tuning_s": seconds,
        },
    }
    print(json.dumps(doc["provenance"]))
    for n in pb.nodes:
        print(n.id, n.motif, n.variant, json.dumps(dict(vars(n.p))))
    Path(args.out).write_text(json.dumps(doc, indent=1) + "\n")
    if not rep.qualified:
        print(f"freeze: {args.workload} not qualified (mean accuracy "
              f"{rep.mean_accuracy:.4f})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
