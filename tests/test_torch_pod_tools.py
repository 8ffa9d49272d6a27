"""The dry run's tools against the JAX package's: ``bench/hillclimb``
(``benchmarks/hillclimb.py``), ``bench/roofline`` and the roofline section
of ``bench/run`` (``benchmarks/roofline.py``), ``bench/proxy_for_pod_model``
(``examples/proxy_for_pod_model.py``) and ``bench/quickstart``
(``examples/quickstart.py``).

* ``apply_opts``: every flag gives the reference's config, field for
  field (the reference's function is read from its source by ``ast``:
  importing ``benchmarks.hillclimb`` would set ``XLA_FLAGS`` for the
  whole test process).
* ``fmt_row`` and the table: string for string on the same records.
* hillclimb's JSON document has the reference's keys, and a flag set
  measured twice is a cache hit (on a small fake world and a reduced
  config, so the test takes seconds).
* ``LM_HINTS`` equal the reference's; the pod proxy and the quickstart
  run end to end on the CPU at a small fake world and a few iterations.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest
import torch_parity  # noqa: F401  (one torch thread a test worker)

from benchmarks import roofline as jroof
from repro.configs import get_config as ref_get
from repro_torch.bench import hillclimb, proxy_for_pod_model, quickstart
from repro_torch.bench import roofline as troof
from repro_torch.bench import run as trun
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.train import reduce_config

ROOT = Path(__file__).resolve().parents[1]


def _reference_function(path: str, name: str, namespace: dict):
    tree = ast.parse((ROOT / path).read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"),
         namespace)
    return namespace[name]


REF_APPLY = _reference_function("benchmarks/hillclimb.py", "apply_opts",
                                {"dataclasses": dataclasses})

OPTS = [["ce_onehot"], ["norm_mixed"], ["attn_p_bf16"], ["qchunk=128"],
        ["kvchunk=512"], ["no_remat"], ["grad_accum=4"],
        ["shard:kv_seq=model"], ["shard:expert=data,model"], ["shard:vocab="],
        ["moment_dtype=bfloat16"], ["param_dtype=bfloat16"],
        ["moe_scan"], ["ep_major"], ["capacity=2.0"], ["group_size=1024"],
        ["", "ce_onehot", "qchunk=256", "moe_scan"]]


@pytest.mark.parametrize("opts", OPTS, ids=lambda o: ",".join(o) or "none")
def test_apply_opts_is_the_reference_s(opts):
    name = ("deepseek-v2-lite-16b" if any(o.startswith(("moe", "ep_",
                                                         "capacity",
                                                         "group_size"))
                                          for o in opts) else "qwen3-4b")
    want = dataclasses.asdict(REF_APPLY(ref_get(name), opts))
    got = dataclasses.asdict(hillclimb.apply_opts(get_config(name), opts))
    assert got == want


def test_apply_opts_refuses_what_the_reference_refuses():
    for fn, cfg in ((REF_APPLY, ref_get("qwen3-4b")),
                    (hillclimb.apply_opts, get_config("qwen3-4b"))):
        with pytest.raises(ValueError, match="unknown opt"):
            fn(cfg, ["warp_speed"])
        with pytest.raises(AssertionError):
            fn(cfg, ["moe_scan"])  # a dense config has no MoE


def _records():
    """A few real dry-run records (a reduced config on a fake (2, 2)
    world), a skipped cell, and one on another mesh."""
    cfg = reduce_config(get_config("tinyllama-1.1b"), 8)
    out = []
    with dryrun.fake_mesh((2, 2), ("data", "model")) as mesh:
        for name, kind in (("train", "train"), ("decode", "decode")):
            out.append(dryrun.cell_record(
                "tinyllama-1.1b", name, cfg,
                dryrun.ShapeCell(name, 128, 4, kind), mesh, verbose=False))
    out.append(dryrun.run_cell("qwen3-4b", "long_500k", False))
    out.append(dict(out[0], mesh="2x16x16", arch="other"))
    return out


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    path = tmp_path_factory.mktemp("roof") / "dryrun.json"
    recs = json.loads(json.dumps(_records(), default=str))
    path.write_text(json.dumps(recs))
    return recs, str(path)


def test_fmt_row_and_table_are_the_reference_s(records, capsys):
    recs, path = records
    for r in recs:
        assert troof.fmt_row(r) == jroof.fmt_row(r)
    for mesh in ("2x2", "2x16x16"):
        assert jroof.main(["--json", path, "--mesh", mesh]) == 0
        want = capsys.readouterr().out
        assert troof.main(["--json", path, "--mesh", mesh]) == 0
        assert capsys.readouterr().out == want
        assert trun.roofline_section(path, mesh=mesh) == 0
        assert want in capsys.readouterr().out
    assert troof.main(["--json", path + ".missing"]) == 1


def _reference_row_keys():
    """The keys of the reference's ``measure`` result, from its source."""
    tree = ast.parse((ROOT / "benchmarks/hillclimb.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "measure")
    ret = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict))
    keys = {k.value for k in ret.keys if k is not None}
    spread = [v for k, v in zip(ret.keys, ret.values) if k is None][0]
    keys |= {e.value for e in spread.generators[0].iter.elts}
    return keys - {"coll_by_kind"}


def test_hillclimb_document_and_cache_hits(monkeypatch, tmp_path, capsys):
    small = reduce_config(get_config("tinyllama-1.1b"), 8)
    monkeypatch.setattr(hillclimb, "get_config", lambda name: small)
    monkeypatch.setattr(hillclimb, "production_shape",
                        lambda multi_pod=False: ((2, 2), ("data", "model")))
    monkeypatch.setattr(hillclimb, "SHAPES_BY_NAME",
                        {"train_4k": dryrun.ShapeCell("train_4k", 128, 4,
                                                      "train")})
    out = tmp_path / "hc.json"
    assert hillclimb.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k",
                           "--opts", "ce_onehot;qchunk=64", "--baseline",
                           "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert set(doc["rows"]) == {"baseline", "+ce_onehot", "+qchunk=64"}
    for row in doc["rows"].values():
        assert set(row) == _reference_row_keys()
        assert row["flops"] > 0 and row["coll_bytes"] > 0
    # every row measured cold (a miss and a compile) and warm (a hit)
    cache = doc["cache"]
    assert (cache["misses"], cache["hits"], cache["compiles"],
            cache["entries"]) == (3, 3, 3, 3)
    assert "deltas for +ce_onehot" in capsys.readouterr().out


def test_lm_hints_are_the_reference_s():
    spec = importlib.util.spec_from_file_location(
        "ref_pod_proxy", ROOT / "examples/proxy_for_pod_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert [(h.motif, h.variant) for h in proxy_for_pod_model.LM_HINTS] == \
        [(h.motif, h.variant) for h in mod.LM_HINTS]


def test_pod_proxy_runs_end_to_end_on_the_cpu(capsys):
    assert proxy_for_pod_model.main(["--device", "cpu", "--iters", "2",
                                     "--mesh", "4x2", "--reduce", "16"]) == 0
    out = capsys.readouterr().out
    assert "fake 4x2 world" in out and "flops/dev=" in out
    assert "proxy DAG: ['matrix:matmul', 'statistics:softmax', " \
           "'logic:relu', 'sampling:topk']" in out


def test_quickstart_runs_end_to_end_on_the_cpu(capsys):
    assert quickstart.main(["--device", "cpu", "--iters", "2",
                            "--scale", "0.05"]) == 0
    out = capsys.readouterr().out
    assert "[proxy-kmeans]" in out and "Qualified proxy DAG:" in out
