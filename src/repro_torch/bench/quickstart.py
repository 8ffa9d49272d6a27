"""Quickstart: the paper's methodology in ~40 lines (port of
``examples/quickstart.py``).

Profiles a real workload (Hadoop K-means in PyTorch), generates a
data-motif proxy benchmark with the decision-tree auto-tuner, and prints
the Table VI / Fig. 4 quantities: speedup and per-metric accuracy.

  PYTHONPATH=src python -m repro_torch.bench.quickstart [--device cpu]
"""
import argparse

from repro_torch.core import generate_proxy
from repro_torch.core.motifs import PVector
from repro_torch.device import resolve_device
from repro_torch.workloads import WORKLOADS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--scale", type=float, default=0.2)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    workload = WORKLOADS["kmeans"]
    inputs = workload.inputs(0, scale=args.scale, device=dev)

    proxy, report = generate_proxy(
        workload.step, *inputs,
        name="proxy-kmeans",
        hints=workload.hints,            # Table III motif decomposition
        base_p=PVector(data_size=1 << 13, chunk_size=64, num_tasks=4,
                       sparsity=0.9, distribution="normal"),
        tol=0.15,                         # the paper's 15% deviation gate
        max_iters=args.iters,
        device=dev,
    )

    print(report.summary())
    print(f"\n{'metric':24s} {'real':>12s} {'proxy':>12s} {'accuracy':>9s}")
    for k, acc in sorted(report.per_metric_accuracy.items()):
        print(f"{k:24s} {report.target_metrics[k]:12.4g} "
              f"{report.proxy_metrics[k]:12.4g} {acc:9.1%}")

    print("\nQualified proxy DAG:")
    for node in proxy.nodes:
        print(f"  {node.id:20s} variant={node.variant:12s} "
              f"weight={node.p.weight:5.2f} data={node.p.data_size}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
