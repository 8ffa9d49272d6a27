"""Small copies of the benchmark's cells, for the tests on the CPU.

``tiny_root(tmp, cells)`` lays out a checkout under ``tmp`` whose
``BENCHMARK.json`` holds the named cells with their configurations cut
to a size a test can run: each node's data_size and batch_size divided,
everything else as frozen.  The metric readers, traffic mixes and limits
are the real ones; the program is the repository's.
"""
from __future__ import annotations

import copy
import json
import os
from pathlib import Path
from typing import Iterable

ROOT = Path(__file__).resolve().parents[1]
#: how much smaller a tiny node's data is, and its largest image batch
SHRINK = 64
BATCH = 2


def tiny_proxy(proxy: dict) -> dict:
    out = copy.deepcopy(proxy)
    for node in out["nodes"]:
        p = node["p"]
        p["data_size"] = max(int(p["data_size"]) // SHRINK, 256)
        p["batch_size"] = min(int(p["batch_size"]), BATCH) \
            if node["motif"] != "matrix" else p["batch_size"]
    return out


def tiny_root(tmp: Path, cells: Iterable[str]) -> Path:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = set(cells)
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] in cells]
    used = {w["config"] for w in bench["workloads"]}
    bench["configs"] = [c for c in bench["configs"] if c["name"] in used]
    pb = tmp / "portbench"
    (pb / "configs").mkdir(parents=True)
    for c in bench["configs"]:
        doc = json.loads((ROOT / c["file"]).read_text())
        doc["proxy"] = tiny_proxy(doc["proxy"])
        (tmp / c["file"]).write_text(json.dumps(doc))
    for sub in ("metrics", "traffic", "limits"):
        os.symlink(ROOT / "portbench" / sub, pb / sub)
    os.symlink(ROOT / "src", tmp / "src")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
