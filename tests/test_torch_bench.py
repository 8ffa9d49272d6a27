"""The port's kernel driver (``repro_torch.bench.kernels_bench``) on the
CPU, and the port's import rule.

The driver runs once for the module, on ``device="cpu"`` with
``--check``; its CSV rows keep the reference driver's names
(``benchmarks/kernels_bench.py``) with the substrates ``torch`` and
``hopper`` for ``xla`` and ``pallas``, and its JSON keeps the reference's
top-level keys.
"""
import ast
import contextlib
import inspect
import io
import json
from pathlib import Path

import pytest
import torch

from benchmarks import kernels_bench as jkb
from repro.core.motifs import lowered_motifs as j_lowered_motifs
from repro_torch.bench import kernels_bench as tkb
from repro_torch.core.motifs import base as tbase
from repro_torch.core.motifs import lowered_motifs

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro", "benchmarks"}


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("kb") / "kernels_bench.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tkb.main(["--device", "cpu", "--check", "--out", str(out)])
    lines = buf.getvalue().splitlines()
    return rc, lines, json.loads(out.read_text()), out


def _reference_micro_names():
    """First arguments of the reference's ``bench(...)`` calls, in order."""
    tree = ast.parse(inspect.getsource(jkb.micro_rows))
    return [n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "id", "") == "bench"]


def test_kernels_bench_rows_keep_the_reference_names(bench_run):
    rc, lines, _, _ = bench_run
    assert rc == 0
    assert lines[0] == "name,us_per_call,derived"
    micro = [n.replace("matmul_pallas_interpret_256", "matmul_hopper_256")
             for n in _reference_micro_names()]
    motifs = []
    assert lowered_motifs() == j_lowered_motifs("pallas")
    for m in j_lowered_motifs("pallas"):
        variant = jkb.MOTIF_CASES[m][0]
        motifs += [f"motif_{m}_{variant}_torch", f"motif_{m}_{variant}_hopper",
                   f"parity_{m}_{variant}"]
    names = [line.split(",")[0] for line in lines[1:]]
    assert names == micro + motifs
    for line in lines[1:]:
        name, us, derived = line.split(",", 2)
        assert float(us) >= 0.0
        if name.startswith("parity_"):
            assert derived == "ok", line


def test_kernels_bench_json_keeps_the_reference_keys(bench_run):
    _, _, doc, out = bench_run
    assert {"bench", "backend", "rows", "motif_substrate", "cache",
            "parity"} <= set(doc)
    assert doc["bench"] == "kernels_bench" and doc["backend"] == "cpu"
    assert doc["device"] == {"type": "cpu", "name": "cpu", "count": 1}
    assert doc["parity"] == {"checked": True, "failures": []}
    assert len(doc["rows"]) == len(_reference_micro_names()) + 3 * len(
        lowered_motifs())
    assert [r["motif"] for r in doc["motif_substrate"]] == list(
        lowered_motifs())
    for row in doc["motif_substrate"]:
        assert row["wall_torch_s"] > 0 and row["wall_hopper_s"] > 0
        assert row["flops_torch"] > 0 and row["bytes_hopper"] > 0
    assert doc["cache"]["compiles"] == 2 * len(lowered_motifs())
    # the atomic write leaves no temporary file beside the result
    assert sorted(p.name for p in out.parent.iterdir()) == [out.name]


def test_kernels_bench_check_catches_a_wrong_lowering(monkeypatch):
    def wrong(motif, p, inputs, variant):
        good = tbase.get_motif("statistics").apply(p, inputs, variant)
        return {k: v + 1.0 for k, v in good.items()}

    monkeypatch.setitem(tbase.LOWERINGS, ("statistics", "hopper"), wrong)
    variant, p = tkb.MOTIF_CASES["statistics"]
    with contextlib.redirect_stdout(io.StringIO()):
        bad = tkb.parity_check("statistics", variant, p, torch.device("cpu"))
    assert bad and all("statistics/average" in b for b in bad)


def test_kernels_bench_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tkb.main([])


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_the_port_imports_nothing_of_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    # the session layer's modules are among those scanned
    scanned = {f.relative_to(ROOT).as_posix() for f in files}
    assert {f"src/repro_torch/{m}.py" for m in (
        "runtime/__init__", "runtime/telemetry", "core/store", "core/priors",
        "core/evaluator", "bench/paper_repro", "bench/_io")} <= scanned
    # and the model zoo's (every config module among them)
    assert {f"src/repro_torch/{m}.py" for m in (
        "configs/__init__", "configs/base", "configs/qwen3_4b",
        "configs/whisper_small", "models/__init__", "models/params",
        "models/flash", "models/layers", "models/trunk", "models/model_zoo",
        "models/mamba2", "models/rglru", "models/whisper",
        "runtime/serve_loop")} <= scanned
    # and the training path's
    assert {f"src/repro_torch/{m}.py" for m in (
        "optim/__init__", "optim/adamw", "optim/compression",
        "optim/schedules", "data/__init__", "data/pipeline",
        "runtime/train_loop", "launch/__init__", "launch/mesh",
        "launch/train", "bench/train_lm", "convert")} <= scanned
    assert len([f for f in scanned
                if f.startswith("src/repro_torch/configs/")]) == 12
    bad = [f"{f.relative_to(ROOT)}:{line} imports {root}"
           for f in files for line, root in _imported_roots(f)
           if root in FORBIDDEN]
    assert bad == []
