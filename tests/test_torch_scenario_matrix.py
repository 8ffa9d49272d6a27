"""The port's ``bench/scenario_matrix.py`` against the reference's
``benchmarks/scenario_matrix.py``: one quick run on the CPU in two gloo
ranks at the reference's ``--check`` gates, its document's keys read
from the reference's docstring by ``ast``, and the per-cell gates on
hand-made records, both scripts' ``_check``-side logic on the same
inputs."""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.bench import scenario_matrix as tsm

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "benchmarks" / "scenario_matrix.py"


def _reference_doc() -> str:
    return ast.get_docstring(ast.parse(REFERENCE.read_text()))


def _keys(block: str):
    return set(re.findall(r'"(\w+)":', block))


def test_flags_and_defaults_are_the_reference():
    tree = ast.parse(REFERENCE.read_text())
    ref = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                == "add_argument"):
            flag = node.args[0].value
            ref[flag] = None
            for k in node.keywords:
                if k.arg == "default":
                    try:
                        ref[flag] = ast.literal_eval(k.value)
                    except ValueError:  # ",".join(DEFAULT_SCENARIOS)
                        ref[flag] = ast.unparse(k.value)
                elif k.arg == "action" and \
                        ast.literal_eval(k.value) == "store_true":
                    ref[flag] = False
    port = vars(tsm.parse_args([]))
    for flag, default in ref.items():
        key = flag.lstrip("-").replace("-", "_")
        assert key in port, flag
        if flag == "--scenarios":
            default = ",".join(tsm.DEFAULT_SCENARIOS)
        assert port[key] == default, flag
    assert tsm.QUICK_WORKLOADS == ("terasort", "kmeans")
    assert tsm.DEFAULT_SCENARIOS == ("single", "dp2", "dp4", "dp2_mp2")


@pytest.fixture(scope="module")
def quick(tmp_path_factory):
    out = tmp_path_factory.mktemp("sm") / "q.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_EMU_DEVICES="2")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.scenario_matrix",
         "--quick", "--device", "cpu", "--scenarios", "single,dp2",
         "--pop", "4", "--check", "--out", str(out), "--timeout", "240"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    return proc, (json.loads(out.read_text()) if out.exists() else None)


def test_quick_check_exits_zero(quick):
    proc, doc = quick
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert doc["devices"] == 2


def test_quick_document_has_every_reference_key(quick):
    _, doc = quick
    text = _reference_doc()
    top = {"devices", "scenarios", "workloads", "population_bench",
           "parity", "session"}
    assert top <= set(doc)
    assert top <= _keys(text.split("Output JSON::")[1])
    for rec in doc["scenarios"]:
        assert {"name", "device_count", "mesh_shape", "axis_names",
                "data_scale"} <= set(rec)
    cell_keys = {"scenario", "mean_accuracy", "per_metric_accuracy",
                 "real_metrics", "proxy_metrics", "real_collective_bytes",
                 "proxy_collective_bytes", "real_wall_s", "proxy_wall_s"}
    assert cell_keys <= _keys(text)
    assert [w["workload"] for w in doc["workloads"]] == ["terasort",
                                                          "kmeans"]
    for w in doc["workloads"]:
        assert {"workload", "proxy_json", "per_scenario", "trend",
                "trend_mesh_tuned"} <= set(w)
        assert [c["scenario"] for c in w["per_scenario"]] == ["single",
                                                              "dp2"]
        for c in w["per_scenario"]:
            assert cell_keys <= set(c)
        assert {"scenarios", "per_metric", "mean_sign_agreement",
                "mean_rank_agreement"} <= set(w["trend"])
        assert doc["parity"][w["workload"]] == {"bit_identical": True}
    assert {"candidates", "classes", "single_wall_s", "sharded_wall_s",
            "sharded_devices", "speedup"} == set(doc["population_bench"])
    assert doc["population_bench"]["sharded_devices"] == 2
    for name in ("single", "dp2"):
        assert {"stats", "per_workload"} <= set(doc["session"][name])
        assert "compile_workers_max" in doc["session"][name]["stats"]


def test_quick_cells_carry_collectives_by_kind(quick):
    _, doc = quick
    for w in doc["workloads"]:
        single, dp2 = w["per_scenario"]
        assert single["real_collective_bytes"] == 0
        assert single["proxy_collective_bytes"] == 0
        assert dp2["real_collective_bytes"] > 0
        assert dp2["proxy_collective_bytes"] > 0
        assert sum(dp2["proxy_collectives"].values()) == \
            dp2["proxy_collective_bytes"]
        assert dp2["proxy_timing"]["mode"] == "eager"
        assert "sharded" in dp2["proxy_timing"]["reason"]
    assert [r["rank"] for r in doc["ranks"]] == [0, 1]


def _cell(name, acc, coll=1.0, mt=None):
    c = {"scenario": name, "mean_accuracy": acc,
         "proxy_collective_bytes": coll, "real_collective_bytes": coll}
    if mt is not None:
        c["mesh_tuned"] = mt
    return c


def _mt(acc, blind, qual=1.0, selected=None):
    selected = selected or ("mesh-tuned" if acc >= blind else "mesh-blind")
    return {"mean_accuracy": acc, "qualification_rate": qual,
            "selected": selected, "selected_accuracy": max(acc, blind)}


GATE_CASES = {
    "clean": [_cell("single", 0.5, 0.0), _cell("dp2", 0.6, 1.0)],
    "no_proxy_collectives": [_cell("dp2", 0.6, 0.0)],
    "low_qualification": [_cell("dp2", 0.6, mt=_mt(0.7, 0.6, qual=0.5))],
    "mislabelled_pick": [_cell("dp2", 0.6, mt={**_mt(0.5, 0.6),
                                                "selected": "mesh-tuned"})],
    "blind_kept": [_cell("dp2", 0.6, mt=_mt(0.5, 0.6))],
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_cell_gates_fail_what_the_reference_fails(case):
    rec = {"per_scenario": GATE_CASES[case]}
    failures = []
    tsm._check_cells("w", rec, failures, False, ["dp2"])
    want = {"clean": 0, "no_proxy_collectives": 2, "low_qualification": 1,
            "mislabelled_pick": 2, "blind_kept": 0}[case]
    assert len(failures) == want, failures


def test_trend_block_gate():
    failures = []
    rec = {"per_scenario": [], "trend_mesh_tuned": None}
    tsm._check_cells("w", rec, failures, True, ["dp2", "dp4"])
    assert failures and "no trend_mesh_tuned" in failures[0]
    failures = []
    rec["trend_mesh_tuned"] = {"scenarios": ["dp2"],
                               "mean_sign_agreement": 1.5,
                               "mean_rank_agreement": 0.0}
    tsm._check_cells("w", rec, failures, True, ["dp2", "dp4"])
    assert len(failures) == 2
