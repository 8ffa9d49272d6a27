"""The port's ``bench/stress_matrix.py`` against the reference's
``benchmarks/stress_matrix.py``: the reference's stress-tier tests
(``test_stress_tier.py``) and its contract-table tests
(``test_contract.py``) on the port; then one ``--quick --check --device
cpu`` run of the port in two gloo ranks beside one run of the reference
on two emulated devices (a subprocess each, started together), which
must give the same case statuses, gate verdicts and payloads."""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import doc_tables
from repro_torch.bench import stress_matrix as tsm
from repro_torch.bench.stress_matrix import (
    GRACEFUL_GATES,
    STRESS_CASES,
    STRESS_KINDS,
    StressCase,
    StressContext,
    evaluate_gates,
    run_case,
)
from repro_torch.core import ClusterError
from repro_torch.runtime.telemetry import Telemetry

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "benchmarks" / "stress_matrix.py"
TUNER_DOC = ROOT / "docs" / "TUNER.md"
STRESS_TABLE_HEADING = "## The stress-tier contract table"
_GATE_ROW = re.compile(r"^\|\s*`(\w+)`\s*\|\s*(.+)\|$")


def _ctx(tmp_path, quick=True):
    return StressContext(quick=quick, hub=Telemetry(), workdir=str(tmp_path),
                         device="cpu")


# -- registry ---------------------------------------------------------------


def test_registry_is_well_formed():
    assert STRESS_CASES, "stress tier is empty"
    for name, case in STRESS_CASES.items():
        assert case.name == name
        assert case.kind in STRESS_KINDS
        assert isinstance(case.expect, tuple) and case.expect
        assert all(issubclass(t, BaseException) for t in case.expect)


def test_registry_quick_subset_covers_ci_smoke():
    quick = [c for c in STRESS_CASES.values() if c.quick]
    assert {"mesh", "fault", "drop"} <= {c.kind for c in quick}


def test_registry_has_must_fail_cases():
    assert any(c.must_fail for c in STRESS_CASES.values())


def test_registry_is_the_references():
    """The ten cases in the reference's order, with its kinds, expected
    error types (by name: each package has its own ClusterError and
    GraphError), must_fail and quick flags."""
    from benchmarks import stress_matrix as jsm

    assert tsm.GRACEFUL_GATES == jsm.GRACEFUL_GATES
    assert tsm.STRESS_KINDS == jsm.STRESS_KINDS
    assert list(STRESS_CASES) == list(jsm.STRESS_CASES)
    for name, case in STRESS_CASES.items():
        ref = jsm.STRESS_CASES[name]
        assert (case.kind, case.must_fail, case.quick) == (
            ref.kind, ref.must_fail, ref.quick), name
        assert [t.__name__ for t in case.expect] == [
            t.__name__ for t in ref.expect], name


def test_flags_and_defaults_are_the_references():
    ref = {}
    for node in ast.walk(ast.parse(REFERENCE.read_text())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            flag = node.args[0].value
            ref[flag] = None
            for k in node.keywords:
                if k.arg == "default":
                    ref[flag] = ast.literal_eval(k.value)
                elif (k.arg == "action"
                      and ast.literal_eval(k.value) == "store_true"):
                    ref[flag] = False
    port = vars(tsm.parse_args([]))
    for flag, default in ref.items():
        assert port[flag.lstrip("-")] == default, flag
    assert set(port) - {f.lstrip("-") for f in ref} == {
        "device", "substrate", "timeout"}


# -- run_case classification ------------------------------------------------


def test_run_case_classifies_completed(tmp_path):
    rec = run_case(StressCase("ok", "mesh", lambda ctx: {"detail": 7}),
                   _ctx(tmp_path))
    assert rec["status"] == "completed"
    assert rec["detail"] == 7
    assert rec["balanced_spans"] is True


def test_run_case_classifies_typed_failure(tmp_path):
    def boom(ctx):
        raise ClusterError("deliberate")
    rec = run_case(StressCase("typed", "mesh", boom), _ctx(tmp_path))
    assert rec["status"] == "typed_failure"
    assert rec["error_type"] == "ClusterError"
    assert rec["balanced_spans"] is True


def test_run_case_classifies_uncaught(tmp_path):
    def boom(ctx):
        raise KeyError("not a declared expect type")
    rec = run_case(StressCase("wild", "mesh", boom), _ctx(tmp_path))
    assert rec["status"] == "uncaught"
    assert rec["error_type"] == "KeyError"
    assert rec["balanced_spans"] is True


def test_stress_case_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown stress kind"):
        tsm.stress_case("x", "weather")


# -- gate evaluation --------------------------------------------------------


def _rec(**kw):
    base = {"case": "c", "kind": "mesh", "must_fail": False,
            "status": "completed", "balanced_spans": True}
    base.update(kw)
    return base


def test_gates_all_pass_on_clean_results():
    gates, failures = evaluate_gates([_rec(), _rec(case="d")])
    assert failures == []
    assert gates == {g: True for g in GRACEFUL_GATES}


def test_gate_no_uncaught():
    gates, failures = evaluate_gates(
        [_rec(status="uncaught", error_type="KeyError", error="x")])
    assert gates["no_uncaught"] is False
    assert any("uncaught" in f for f in failures)


def test_gate_typed_errors_flags_surviving_hostile_case():
    gates, _ = evaluate_gates([_rec(must_fail=True, status="completed")])
    assert gates["typed_errors"] is False
    gates, _ = evaluate_gates([_rec(must_fail=True, status="typed_failure")])
    assert gates["typed_errors"] is True


def test_gate_bounded_retries():
    gates, _ = evaluate_gates([_rec(recoveries=3, max_retries=2)])
    assert gates["bounded_retries"] is False
    gates, _ = evaluate_gates([_rec(recoveries=1, max_retries=2)])
    assert gates["bounded_retries"] is True


def test_gate_balanced_spans():
    gates, _ = evaluate_gates([_rec(balanced_spans=False)])
    assert gates["balanced_spans"] is False


def test_gate_requalified_only_judges_completed_drop_cases():
    gates, _ = evaluate_gates(
        [_rec(kind="drop", status="completed", requalified=False)])
    assert gates["requalified"] is False
    gates, _ = evaluate_gates(
        [_rec(kind="drop", status="completed", requalified=True)])
    assert gates["requalified"] is True
    gates, _ = evaluate_gates([_rec(kind="drop", status="typed_failure")])
    assert gates["requalified"] is True


def test_gate_no_uncaught_when_ranks_end_differently():
    gates, failures = evaluate_gates(
        [_rec(rank=0), _rec(rank=1, status="typed_failure")])
    assert gates["no_uncaught"] is False
    assert any("ranks ended differently" in f for f in failures)
    gates, _ = evaluate_gates([_rec(rank=0), _rec(rank=1)])
    assert gates["no_uncaught"] is True


GATE_RECORDS = {
    "clean": [_rec(), _rec(case="d", kind="drop", requalified=True)],
    "uncaught": [_rec(status="uncaught", error_type="KeyError")],
    "hostile_survives": [_rec(must_fail=True)],
    "retries": [_rec(kind="fault", recoveries=3, max_retries=2)],
    "spans": [_rec(balanced_spans=False)],
    "drop": [_rec(kind="drop", requalified=False)],
    "all": [_rec(status="uncaught", error_type="E", must_fail=True,
                 balanced_spans=False, recoveries=5, max_retries=1,
                 kind="drop")],
}


@pytest.mark.parametrize("name", list(GATE_RECORDS))
def test_gates_are_the_references_on_the_same_records(name):
    from benchmarks import stress_matrix as jsm

    assert evaluate_gates(GATE_RECORDS[name]) == jsm.evaluate_gates(
        GATE_RECORDS[name])


# -- real cases, in-process (no process group: one rank) -------------------


def test_store_corruption_case_in_process(tmp_path):
    rec = run_case(STRESS_CASES["store_corruption"], _ctx(tmp_path))
    assert rec["status"] == "completed", rec
    assert rec["store_invalid"] > 0
    assert rec["metrics_match"] is True


def test_zipf_skew_sweep_single_shape_class(tmp_path):
    rec = run_case(STRESS_CASES["zipf_skew_sweep"], _ctx(tmp_path))
    assert rec["status"] == "completed", rec
    assert rec["compiles"] == 1


def test_degenerate_meshes_typed_failure_on_one_device(tmp_path):
    rec = run_case(STRESS_CASES["degenerate_meshes"], _ctx(tmp_path))
    assert rec["status"] == "typed_failure", rec
    assert rec["error_type"] == "ClusterError"


def test_fault_cases_in_process(tmp_path):
    rec = run_case(STRESS_CASES["fault_injection_restore"], _ctx(tmp_path))
    assert rec["status"] == "completed", rec
    assert rec["recoveries"] <= rec["max_retries"]
    assert rec["final_step"] == 6
    rec2 = run_case(STRESS_CASES["fault_exhausts_retries"], _ctx(tmp_path))
    assert rec2["status"] == "typed_failure", rec2
    assert rec2["error_type"] == "RuntimeError"
    gates, failures = evaluate_gates([rec, rec2])
    assert failures == []
    assert all(gates.values())


def test_cases_default_to_the_card(tmp_path):
    """No device: the case asks for CUDA, which a CPU host refuses — an
    uncaught error, never a quiet CPU run."""
    ctx = StressContext(quick=True, hub=Telemetry(), workdir=str(tmp_path))
    rec = run_case(STRESS_CASES["zipf_skew_sweep"], ctx)
    assert rec["status"] == "uncaught" and "CUDA" in rec["error"]


# -- the contract table ------------------------------------------------------


def _stress_doc_gates():
    gates = {}
    section = doc_tables.doc_section(TUNER_DOC, STRESS_TABLE_HEADING)
    for line in section.splitlines():
        m = _GATE_ROW.match(line.strip())
        if m and m.group(1) != "gate":
            gates[m.group(1)] = m.group(2).strip()
    return gates


def test_stress_doc_gates_match_the_bench():
    gates = _stress_doc_gates()
    assert gates, f"no stress-tier gate rows found in {TUNER_DOC}"
    assert tuple(gates) == GRACEFUL_GATES
    assert all(len(d) > 20 for d in gates.values())


def test_stress_doc_names_both_matrix_halves():
    section = doc_tables.doc_section(TUNER_DOC, STRESS_TABLE_HEADING)
    assert "scenario_matrix" in section and "stress_matrix" in section
    assert "graceful" in section.lower()


# -- both benches, two ranks against two emulated devices ------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("stress")
    port_out, ref_out = d / "port.json", d / "ref.json"
    # an existing history the port's run must append to
    port_out.write_text(json.dumps({"runs": [{"earlier": True}]}))
    port = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.bench.stress_matrix", "--quick",
         "--check", "--device", "cpu", "--out", str(port_out), "--timeout",
         "240"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 REPRO_EMU_DEVICES="2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    ref = subprocess.Popen(
        [sys.executable, "-m", "benchmarks.stress_matrix", "--quick",
         "--check", "--out", str(ref_out)],
        env=dict(os.environ, PYTHONPATH="src",
                 XLA_FLAGS="--xla_force_host_platform_device_count=2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    done = {}
    for name, proc in (("port", port), ("ref", ref)):
        out, err = proc.communicate(timeout=300)
        done[name] = (proc.returncode, out, err)
    assert done["ref"][0] == 0, done["ref"][2][-2000:]
    assert done["port"][0] == 0, done["port"][2][-2000:]
    return (json.loads(port_out.read_text()),
            json.loads(ref_out.read_text())["runs"][-1], done["port"][1])


def test_stress_matrix_2rank_subprocess(runs):
    """The port's --quick --check run in two ranks passes every gate,
    including the device-drop re-qualification, and appends its record
    to the history."""
    doc, _, stdout = runs
    assert doc["runs"][0] == {"earlier": True} and len(doc["runs"]) == 2
    run = doc["runs"][-1]
    assert run["devices"] == 2 and run["device"] == "cpu"
    assert all(run["gates"][g] for g in GRACEFUL_GATES), run["failures"]
    by_name = {c["case"]: c for c in run["cases"]}
    assert by_name["device_drop_requalify"]["requalified"] is True
    assert by_name["indivisible_mesh"]["status"] == "typed_failure"
    assert by_name["fault_exhausts_retries"]["status"] == "typed_failure"
    assert "REPRO_EMU_DEVICES" in by_name["oversubscribed_mesh"]["error"]
    assert [r["rank"] for r in run["ranks"]] == [0, 1]
    for r in run["ranks"]:  # every rank ran every case
        assert [c["case"] for c in r["results"]] == list(STRESS_CASES)
    for g in GRACEFUL_GATES:
        assert re.search(rf"{g}\s+PASS", stdout), g


def test_gates_match_the_reference_run(runs):
    doc, ref, _ = runs
    run = doc["runs"][-1]
    assert run["gates"] == ref["gates"]
    assert run["failures"] == ref["failures"] == []
    assert run["devices"] == ref["devices"] == 2
    assert run["quick"] is ref["quick"] is True


#: payload keys whose values are the platform's: the fault case's EMA and
#: its stragglers come from the wall clock (under several test workers a
#: step of a few microseconds can take 2.5x the EMA in one package and not
#: the other; the straggler rule itself is held on identical walls in
#: test_torch_fault_tolerance.py); an error text names each package's own
#: remedy
UNCOMPARED = {"ema_s", "stragglers", "error"}


@pytest.mark.parametrize("case", list(STRESS_CASES))
def test_case_matches_the_reference_run(runs, case):
    """Status, error type and every payload field (``compiles``, the
    quanta, ``recoveries``, ``replay_under``, ...) of the port's rank-0
    record, and of its other rank's, against the reference's record."""
    doc, ref, _ = runs
    want = next(c for c in ref["cases"] if c["case"] == case)
    for r in doc["runs"][-1]["ranks"]:
        got = next(c for c in r["results"] if c["case"] == case)
        assert set(got) == set(want), (r["rank"], case)
        for key in set(want) - UNCOMPARED:
            assert got[key] == want[key], (r["rank"], case, key)
