"""The readings a cell's limits are set from, on the card at the cell's
own size.

    python3 portbench/calibrate.py --workload kmeans.proxy --seeds 1 2 3

For each seed, in one process: the program's numbers (its timed path,
captured and replayed as a run does, against the float64 reference) and
the control's (the reference computed in TF32, put in the program's
place).  One JSON line a seed, then the lower reading of each number
(the program's largest) and the upper one (the control's smallest).
The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import check, harness, reference

    cell = harness.load_cell(args.workload)
    harness.import_program()
    from repro_torch.core.proxy_graph import ProxyBenchmark

    dev = torch.device(args.device)
    proxy = cell.config["proxy"]
    pb = ProxyBenchmark.from_json(json.dumps(proxy)).with_substrate(
        cell.traffic["substrate"])
    fn = pb.build_fn(dev)
    lower, upper = {}, {}
    for seed in args.seeds:
        runner = harness.Runner(fn, seed, dev)
        mode = runner.mode
        runner()
        got = harness.to_host(runner.outputs())
        runner.close()
        ref, choices = reference.run(proxy, seed, dev, "float64")
        ref = harness.to_host(ref)
        choices = {n: {k: (s.cpu(), c) for k, (s, c) in v.items()}
                   for n, v in choices.items()}
        ctrl, _ = reference.run(proxy, seed, dev, "tf32")
        prog = check.compare(got, ref, choices)
        control = check.compare(harness.to_host(ctrl), ref, choices)
        print(json.dumps({"seed": seed, "mode": mode,
                          "program": prog, "control": control}), flush=True)
        for k, v in prog.items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in control.items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper, "limits": dict(cell.limits)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
