"""The paper's three case studies (§IV); port of
``benchmarks/case_studies.py``.

A. **Data input** — generate ONE Proxy K-means against sparse (90%) input,
   then drive the SAME proxy with dense (0%) data and check accuracy vs
   the real dense-input workload (paper Fig. 7/8).
B. **Configuration adaptability** — evaluate the same proxies against the
   real workloads under a different configuration (input scale, the
   cluster-reconfiguration analog) without regenerating them (Fig. 9).
C. **Cross-architecture trend** — the paper checks that Westmere->Haswell
   runtime speedups agree between real and proxy.  Here the hardware
   generations are two of the card the port runs on, A100 SXM4 80GB
   against H100 SXM5 80GB (``HW_GENS``, NVIDIA's data sheets): per
   workload, the roofline-implied step-time ratio real(A100)/real(H100)
   must order the workloads the same way as proxy(A100)/proxy(H100)
   (Fig. 10).  The reference compares two TPU generations with the same
   arithmetic; :func:`case_c_cross_architecture` takes the table as an
   argument, so the reference's own table gives the reference's ratios.

The JSON document is the reference's, key for key: a list of one record
a case.  Beyond the reference's keys, cases A and B record how each wall
time was taken (``timing``: a captured CUDA graph's replays, or eager
dispatch and why; ``Signature.timing``), and case C the generations it
compared (``generations``).  Each case takes the reference's sizes as
keyword defaults.

Usage::

  PYTHONPATH=src python -m repro_torch.bench.case_studies [--iters 16] \\
      [--case all|a|b|c] [--out results/case_studies.json] \\
      [--device cpu] [--substrate hopper]

``--device`` is cuda unless ``cpu`` is asked for; ``--substrate hopper``
puts every proxy's sort, matrix and statistics nodes on the hand-written
kernels (``torch``, the stock ATen form, by default).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, Mapping, Sequence

from repro_torch.bench._io import write_json
from repro_torch.core import compare, generate_proxy, normalized_vector
from repro_torch.core.generator import proxy_signature, select_metrics
from repro_torch.core.motifs import PVector
from repro_torch.core.motifs.base import SUBSTRATES
from repro_torch.core.signature import Signature, signature_of_call
from repro_torch.data.generators import make_generator
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import HW
from repro_torch.workloads import WORKLOADS, kmeans

#: two generations of the card the port runs on, for case study C (bf16
#: dense peak FLOP/s, HBM bytes/s, NVLink bytes/s each way), from NVIDIA's
#: data sheets; ``peak``/``hbm``/``ici`` are the reference's keys.  The
#: first generation is the ratio's numerator, as the reference's v4 is.
#: The H100's row is ``launch.mesh.HW``, the port's one table of its rates.
HW_GENS: Dict[str, Dict[str, float]] = {
    "a100_sxm4_80gb": {"peak": 312e12, "hbm": 2.039e12, "ici": 300e9},
    "h100_sxm5_80gb_700w": {"peak": HW["peak_bf16_flops"],
                            "hbm": HW["hbm_bandwidth"],
                            "ici": HW["ici_bandwidth"]},
}

#: the reference document's keys: each case record's, and those of each
#: of case B's two workload blocks
CASE_KEYS: Dict[str, tuple] = {
    "A_data_input": ("case", "sparse_mean_acc", "dense_mean_acc",
                     "dense_per_metric", "conclusion"),
    "B_config_adaptability": ("case", "terasort", "pagerank"),
    "C_cross_architecture": ("case", "real_ratios", "proxy_ratios",
                             "trend_consistent", "real_order",
                             "proxy_order"),
}
WORKLOAD_KEYS = ("orig_mean_acc", "newcfg_mean_acc")

#: the reference's proxy seeds: case A's K-means, case B's two workloads,
#: case C's five
CASE_A_BASE_P = PVector(data_size=1 << 13, chunk_size=64, num_tasks=4,
                        distribution="normal", sparsity=0.9)
CASE_B_BASE_P: Dict[str, PVector] = {
    name: PVector(data_size=1 << 13, chunk_size=1 << 10, num_tasks=4,
                  channels=24 if name == "terasort" else 16,
                  distribution="zipf" if name == "pagerank" else "uniform")
    for name in ("terasort", "pagerank")}
CASE_C_BASE_P = PVector(data_size=1 << 12, chunk_size=256, num_tasks=4)


def missing_keys(records: Sequence[Mapping]) -> list:
    """The reference document's keys that ``records`` (one a case) lack,
    as paths; empty when it has them all."""
    out = []
    for i, r in enumerate(records):
        out += [f"[{i}].{k}" for k in CASE_KEYS[r["case"]] if k not in r]
        if r["case"] == "B_config_adaptability":
            out += [f"[{i}].{w}.{k}" for w in ("terasort", "pagerank")
                    for k in WORKLOAD_KEYS if k not in r.get(w, {})]
    return out


def roofline_step_time(sig: Signature, hw: Mapping[str, float]) -> float:
    """The least step time the roofline allows on ``hw``: the largest of
    flops over peak, bytes over HBM bandwidth and collective bytes over
    link bandwidth."""
    coll = sum(sig.collective_bytes.values())
    return max(sig.flops / hw["peak"], sig.bytes / hw["hbm"],
               coll / hw["ici"] if coll else 0.0)


def generation_ratio(sig: Signature,
                     hw_gens: Mapping[str, Mapping[str, float]]) -> float:
    """The roofline step time on the first generation of ``hw_gens`` over
    that on the second."""
    first, second = list(hw_gens.values())[:2]
    return (roofline_step_time(sig, first)
            / max(roofline_step_time(sig, second), 1e-12))


def case_a_data_input(iters: int, scale: float = 0.3, *,
                      base_p: PVector = CASE_A_BASE_P,
                      device: DeviceLike = None,
                      substrate: str = "torch") -> Dict:
    """One proxy, two sparsities."""
    dev = resolve_device(device)
    w = WORKLOADS["kmeans"]
    sparse_args = kmeans.make_inputs(make_generator(0, dev), scale,
                                     sparsity=0.9)
    proxy, rep_sparse = generate_proxy(
        w.step, *sparse_args, name="proxy-kmeans", hints=w.hints,
        base_p=base_p, max_iters=iters, substrate=substrate, device=dev)

    # drive the SAME proxy with dense data (only the data spec changes)
    dense_args = kmeans.make_inputs(make_generator(0, dev), scale,
                                    sparsity=0.0)
    real_sig = signature_of_call(w.step, *dense_args, device=dev)
    real_dense = normalized_vector(real_sig)
    dense_proxy = dataclasses.replace(proxy, nodes=tuple(
        n.replace(p=n.p.replace(sparsity=0.0)) for n in proxy.nodes))
    proxy_sig = proxy_signature(dense_proxy, device=dev)
    proxy_dense_m = normalized_vector(proxy_sig)
    metrics = select_metrics(real_dense, include_rates=True)
    rep_dense = compare({k: real_dense.get(k, 0.0) for k in metrics},
                        proxy_dense_m, metrics)
    return {
        "case": "A_data_input",
        "sparse_mean_acc": rep_sparse.mean_accuracy,
        "dense_mean_acc": rep_dense.mean,
        "dense_per_metric": dict(rep_dense.per_metric),
        "conclusion": "one proxy serves both sparsities"
                      if min(rep_sparse.mean_accuracy, rep_dense.mean) > 0.7
                      else "accuracy degrades with input change",
        "timing": {"real_sparse": dict(rep_sparse.real_timing),
                   "proxy_sparse": dict(rep_sparse.proxy_timing),
                   "real_dense": dict(real_sig.timing),
                   "proxy_dense": dict(proxy_sig.timing)},
    }


def case_b_config_adaptability(
        iters: int, *, scales: Sequence[float] = (0.3, 0.6),
        base_p: Mapping[str, PVector] = CASE_B_BASE_P,
        device: DeviceLike = None, substrate: str = "torch") -> Dict:
    """Same proxies, different run configuration (scale/batch analog)."""
    dev = resolve_device(device)
    out = {}
    for name in ("terasort", "pagerank"):
        w = WORKLOADS[name]
        args1 = w.inputs(0, scales[0], device=dev)
        proxy, rep1 = generate_proxy(
            w.step, *args1, name=f"proxy-{name}", hints=w.hints,
            base_p=base_p[name], max_iters=iters, substrate=substrate,
            device=dev)
        # new "cluster config": 2x the data, same proxy
        args2 = w.inputs(1, scales[1], device=dev)
        real2_sig = signature_of_call(w.step, *args2, device=dev)
        real2 = normalized_vector(real2_sig)
        metrics = select_metrics(real2, include_rates=True)
        proxy_sig = proxy_signature(proxy, device=dev)
        proxy_m = normalized_vector(proxy_sig)
        rep2 = compare({k: real2.get(k, 0.0) for k in metrics},
                       proxy_m, metrics)
        out[name] = {"orig_mean_acc": rep1.mean_accuracy,
                     "newcfg_mean_acc": rep2.mean,
                     "timing": {"real_orig": dict(rep1.real_timing),
                                "proxy_orig": dict(rep1.proxy_timing),
                                "real_newcfg": dict(real2_sig.timing),
                                "proxy_newcfg": dict(proxy_sig.timing)}}
    return {"case": "B_config_adaptability", **out}


def case_c_cross_architecture(
        iters: int, *, scale: float = 0.2,
        base_p: PVector = CASE_C_BASE_P,
        hw_gens: Mapping[str, Mapping[str, float]] = HW_GENS,
        device: DeviceLike = None, substrate: str = "torch") -> Dict:
    """Roofline-implied first-over-second-generation step-time ratios:
    real vs proxy trends."""
    dev = resolve_device(device)
    ratios_real, ratios_proxy = {}, {}
    for name in sorted(WORKLOADS):
        w = WORKLOADS[name]
        args = w.inputs(0, scale, device=dev)
        sig_real = signature_of_call(w.step, *args, run=False, device=dev)
        proxy, _ = generate_proxy(
            w.step, *args, name=f"proxy-{name}", hints=w.hints,
            base_p=base_p, max_iters=max(iters // 2, 4), run=False,
            substrate=substrate, device=dev)
        sig_proxy = proxy_signature(proxy, run=False, device=dev)
        ratios_real[name] = generation_ratio(sig_real, hw_gens)
        ratios_proxy[name] = generation_ratio(sig_proxy, hw_gens)
    order_real = sorted(ratios_real, key=ratios_real.get)
    order_proxy = sorted(ratios_proxy, key=ratios_proxy.get)
    return {
        "case": "C_cross_architecture",
        "real_ratios": ratios_real,
        "proxy_ratios": ratios_proxy,
        "trend_consistent": order_real == order_proxy,
        "real_order": order_real,
        "proxy_order": order_proxy,
        "generations": list(hw_gens)[:2],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--out", default="results/case_studies.json")
    ap.add_argument("--case", default="all", choices=["all", "a", "b", "c"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--substrate", default="torch", choices=SUBSTRATES,
                    help="hopper: the proxies' hot loops on the kernels")
    args = ap.parse_args(argv)
    kw = dict(device=resolve_device(args.device), substrate=args.substrate)

    results = []
    if args.case in ("all", "a"):
        r = case_a_data_input(args.iters, **kw)
        print(json.dumps(r, indent=1))
        results.append(r)
    if args.case in ("all", "b"):
        r = case_b_config_adaptability(args.iters, **kw)
        print(json.dumps(r, indent=1))
        results.append(r)
    if args.case in ("all", "c"):
        r = case_c_cross_architecture(args.iters, **kw)
        print(json.dumps(r, indent=1))
        results.append(r)

    write_json(args.out, results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
