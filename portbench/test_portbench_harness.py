"""The harness on the CPU: cells load, a run fails without a card or a
program, tiny copies of the cells run and check, the readers read, and
the process never holds the JAX stack or the JAX package."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import check, devtrace, harness, reference, tiny
from portbench.harness import RunData

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
NO_CARD = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


def run_py(cwd, *args):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "kmeans.proxy",
         "--seed", "5", "--seconds", "1", *args], cwd=cwd, env=NO_CARD,
        capture_output=True, text=True, timeout=300)


def test_benchmark_json_keeps_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    cells = 24  # the most a later benchmark may have, at this length
    assert (2 + 14 * cells) * (BENCH["run_seconds"] + 60) \
        + cells * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(
        names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"proxy_ms", "proxy_p95_ms", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    assert {w["config"] for w in BENCH["workloads"]} == {
        c["name"] for c in BENCH["configs"]}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_from_its_files(name):
    from repro_torch.core.proxy_graph import ProxyBenchmark

    cell = harness.load_cell(name)
    pb = ProxyBenchmark.from_json(json.dumps(cell.config["proxy"]))
    for node in cell.config["proxy"]["nodes"]:
        mod = reference.motif(node["motif"])
        assert reference.variant_of(mod, node["variant"]) == node["variant"]
    assert set(cell.traffic) == {"why", "substrate"}
    assert cell.traffic["substrate"] in ("torch", "hopper")
    assert set(cell.limits) <= set(check.NUMBERS)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.load_reader(m["name"]))
    assert len(pb.nodes) == len(cell.config["proxy"]["nodes"])
    prov = cell.config["provenance"]
    for key in ("commit", "chip_call", "input_seed", "iterations",
                "mean_accuracy"):
        assert key in prov


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = run_py(ROOT)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "CUDA device" in out.stderr


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
    with pytest.raises(harness.ProgramMissing):
        harness.import_program(tmp_path)


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cells_run_and_check_on_the_cpu(name, tmp_path):
    cell = harness.load_cell(name, tiny.tiny_root(tmp_path, [name]))
    r = harness.run_cell(cell, 2 ** 31 + 11, 0.05, False,
                         torch.device("cpu"), 0.0)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"proxy_ms", "proxy_p95_ms", "setup_s"}
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(cell.limits)
    assert r["device"]["platform"] == "cpu"  # never a device number


def test_no_jax_nor_the_jax_package_after_a_run(tmp_path):
    code = f"""
import sys, torch
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from portbench import harness, tiny
root = tiny.tiny_root(Path({str(tmp_path)!r}), ["kmeans.proxy"])
r = harness.run_cell(harness.load_cell("kmeans.proxy", root), 9, 0.05, False,
                     torch.device("cpu"), 0.0)
bench = str(Path({str(ROOT)!r}) / "benchmarks")
print(r["correct"], harness.forbidden_modules(), "repro_torch" in sys.modules,
      [m for m, v in list(sys.modules.items())
       if str(getattr(v, "__file__", "") or "").startswith(bench)])
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=NO_CARD)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "True [] True []"


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("repro_torch.core", "reprox", "jaxtyping", "jax.numpy",
                 "repro", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert {"jax.numpy", "repro", "flax.linen"} <= set(
        harness.forbidden_modules())
    assert not {"repro_torch.core", "reprox", "jaxtyping"} & set(
        harness.forbidden_modules())


def synthetic_run():
    tr = devtrace.Trace(replays=4, kernels=12, busy_s=0.008, window_s=0.010,
                        device_ops=[], idle_gaps=[], products=[
                            ("aten::mm", [[8192, 2048], [2048, 128]], 100.0),
                            ("repro_torch::matmul",
                             [[32, 2048], [2048, 2048]], 20.0)],
                        eager_runs=1, inputgen_ms=0.07)
    return RunData(setup_s=6.5, window_s=2.0, run_ms=[1.0] * 19 + [3.0],
                   flops_per_run=6.7e9, peaks={"float32_flops_per_s": 67e12},
                   trace=tr)


@pytest.mark.parametrize("name,want", [
    ("proxy_ms", 100.0), ("proxy_p95_ms", 1.0), ("setup_s", 6.5),
    ("launches_per_run", 3.0), ("inputgen_ms", 0.07), ("device_idle", 20.0),
    ("proxy_mfu", 0.1),
    ("matmul_roofline", 100 * (2 * 8192 * 2048 * 128 / 67e12
                               + (32 * 2048 * 2 + 2048 * 2048) * 4 / 3.35e12)
     / 120e-6)])
def test_readers_read_a_run(name, want):
    assert harness.load_reader(name)(synthetic_run()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["launches_per_run", "inputgen_ms",
                                  "device_idle", "matmul_roofline"])
def test_readers_with_nothing_to_read_give_nothing(name):
    run = synthetic_run()
    run.trace = None
    assert harness.load_reader(name)(run) is None


@pytest.mark.parametrize("name", CELLS)
def test_the_product_calls_are_every_product_of_the_proxy(name, tmp_path,
                                                          monkeypatch):
    from repro_torch.core.proxy_graph import ProxyBenchmark

    cell = harness.load_cell(name, tiny.tiny_root(tmp_path, [name]))
    proxy = cell.config["proxy"]
    fn = ProxyBenchmark.from_json(json.dumps(proxy)).with_substrate(
        cell.traffic["substrate"]).build_fn(torch.device("cpu"))
    fn(3)

    def work():
        fn(3)
        fn(4)

    calls = harness.product_calls(work, proxy, 2, torch.device("cpu"))
    assert len(calls) == 2 * reference.products(proxy) > 0
    want = {"hopper": "repro_torch::matmul", "torch": "aten::mm"}
    assert {op for op, _, _ in calls} == {want[cell.traffic["substrate"]]}
    monkeypatch.setattr(devtrace, "PRODUCT_OPS", ("aten::bmm",))
    with pytest.raises(harness.ProductsMissed):
        harness.product_calls(work, proxy, 2, torch.device("cpu"))


def test_reduce_a_timeline():
    tl = devtrace.Timeline(
        device=[("k1", "kernel", 0.0, 10.0), ("k2", "kernel", 5.0, 10.0),
                ("m", "gpu_memset", 30.0, 5.0), ("k1", "kernel", 40.0, 10.0),
                ("k3", "kernel", 60.0, 5.0)],
        host=[("cudaGraphLaunch", 14.0, 2.0),
              ("cudaEventSynchronize", 16.0, 30.0)])
    tr = devtrace.reduce(tl, 2)
    assert tr.kernels == 4
    assert (tr.busy_s, tr.window_s) == (pytest.approx(35e-6),
                                         pytest.approx(65e-6))
    assert tr.device_ops[0] == ("k1", pytest.approx(20e-6))
    assert dict(tr.idle_gaps) == {
        "cudaGraphLaunch": pytest.approx(15e-6),
        "cudaEventSynchronize": pytest.approx(5e-6),
        "no host call": pytest.approx(10e-6)}
