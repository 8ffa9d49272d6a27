"""Benchmark harness entry point — one section per paper table/figure;
port of ``benchmarks/run.py``.

  kernels            -> repro_torch.bench.kernels_bench (us_per_call CSV)
  Table VI + Fig. 4  -> repro_torch.bench.paper_repro   (proxy speedup +
                                                          accuracy)
  Fig. 7/8/9/10      -> repro_torch.bench.case_studies  (3 case studies)
  §Roofline          -> repro_torch.bench.roofline    (from a dry-run
                                                          sweep's records)

``python -m repro_torch.bench.run`` runs the quick versions of everything
with the reference's arguments; the per-module CLIs expose full-size
settings.  ``--device`` (cuda unless ``cpu`` is asked for) is passed to
every section.  The roofline section reads ``results/dryrun_all.json``
when a full sweep wrote it, as the reference does; else it runs the dry
run (one rank of a fake 256-rank world: no card, no memory) on the
production mesh for the cells it can afford (:data:`ROOFLINE_CELLS`,
about a minute on a host core) and prints their table.  A section that
raises is listed under ``failures`` and the run exits 1.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional


def section(title: str) -> None:
    print(f"\n{'='*72}\n== {title}\n{'='*72}", flush=True)


#: the dry-run cells the roofline section runs when no sweep is on disk
ROOFLINE_CELLS = (("qwen3-4b", "train_4k"), ("qwen3-4b", "prefill_32k"),
                  ("qwen3-4b", "decode_32k"), ("tinyllama-1.1b", "train_4k"))
SWEEP = "results/dryrun_all.json"


def roofline_section(records_json: Optional[str] = None,
                     mesh: str = "16x16") -> int:
    """Print the roofline table of ``records_json`` (default: the full
    sweep's file when it exists, else a dry run of
    :data:`ROOFLINE_CELLS` written to ``results/dryrun_quick.json``)."""
    from repro_torch.bench import roofline

    if records_json is None:
        if os.path.exists(SWEEP):
            records_json = SWEEP
        else:
            from repro_torch.bench._io import write_json
            from repro_torch.launch import dryrun

            records = [dryrun.run_cell(a, s, False)
                       for a, s in ROOFLINE_CELLS]
            records_json = "results/dryrun_quick.json"
            write_json(records_json, records)
    return roofline.main(["--json", records_json, "--mesh", mesh])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = ["--device", args.device] if args.device else []
    t0 = time.time()
    failures = []

    section("kernel microbenchmarks (name,us_per_call,derived)")
    try:
        from repro_torch.bench import kernels_bench
        kernels_bench.main(dev)
    except Exception as e:  # noqa: BLE001
        failures.append(("kernels", repr(e)))
        print(f"FAILED: {e!r}")

    section("paper reproduction: Table VI speedup + Fig.4 accuracy")
    try:
        from repro_torch.bench import paper_repro
        paper_repro.main(["--scale", "0.2", "--iters", "6",
                          "--out", "results/paper_repro.json"] + dev)
    except Exception as e:  # noqa: BLE001
        failures.append(("paper_repro", repr(e)))
        print(f"FAILED: {e!r}")

    section("case studies (Fig.7-10): data input / config / cross-arch")
    try:
        from repro_torch.bench import case_studies
        case_studies.main(["--iters", "5",
                           "--out", "results/case_studies.json"] + dev)
    except Exception as e:  # noqa: BLE001
        failures.append(("case_studies", repr(e)))
        print(f"FAILED: {e!r}")

    section("roofline table (from the dry-run sweep)")
    try:
        roofline_section()
    except Exception as e:  # noqa: BLE001
        failures.append(("roofline", repr(e)))
        print(f"FAILED: {e!r}")

    section(f"benchmarks done in {time.time()-t0:.0f}s; "
            f"failures={failures or 'none'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
