"""Benchmark harness entry point — one section per paper table/figure;
port of ``benchmarks/run.py``.

  kernels            -> repro_torch.bench.kernels_bench (us_per_call CSV)
  Table VI + Fig. 4  -> repro_torch.bench.paper_repro   (proxy speedup +
                                                          accuracy)
  Fig. 7/8/9/10      -> repro_torch.bench.case_studies  (3 case studies)
  §Roofline          -> waits for the model zoo (ROADMAP queue 1 item 5):
                        the reference's table reads a dry-run sweep of
                        models the port does not have yet

``python -m repro_torch.bench.run`` runs the quick versions of everything
with the reference's arguments; the per-module CLIs expose full-size
settings.  ``--device`` (cuda unless ``cpu`` is asked for) is passed to
every section.  A section that raises is listed under ``failures`` and
the run exits 1.
"""
from __future__ import annotations

import argparse
import sys
import time


def section(title: str) -> None:
    print(f"\n{'='*72}\n== {title}\n{'='*72}", flush=True)


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
    print("not ported yet: the roofline table reads the dry-run sweep of "
          "the model zoo, which the port does not have yet (ROADMAP "
          "queue 1 item 5)")

    section(f"benchmarks done in {time.time()-t0:.0f}s; "
            f"failures={failures or 'none'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
