"""The paper's §IV case studies and the bench runner
(``repro_torch.bench.case_studies``, ``repro_torch.bench.run``) against
the reference's ``benchmarks/case_studies.py`` and ``benchmarks/run.py``.

Case C is arithmetic on signatures: given the reference's own hardware
table and the same signatures, the port's ratios equal the reference's
to ``rel=1e-12`` and order the workloads the same way.  Cases A and B run
quickly on the CPU at small sizes and must carry every key of the
reference's documents, read from its source.  The runner calls each
section with the reference's arguments (both runners run with their
sections stubbed).
"""
import ast
import inspect
import json
from types import SimpleNamespace

import pytest
import torch

from torch_parity import to_torch  # noqa: F401  (sets one thread a worker)

from benchmarks import case_studies as jcs
from repro.core.signature import Signature as JSignature
from repro_torch.bench import case_studies as tcs
from repro_torch.bench import run as trun
from repro_torch.core.motifs import PVector
from repro_torch.core.signature import Signature

#: hand-built signatures: (flops, bytes, collective bytes), compute-,
#: byte- and link-bound on either generation, collectives zero or not
SIGS = {
    "compute": (4e12, 1e9, {}),
    "bytes": (1e9, 3e10, {}),
    "ridge": (2.4e12, 1e10, {}),
    "link": (1e10, 1e9, {"all-reduce": 4e9}),
    "mixed": (5e11, 4e9, {"all-gather": 1e8, "all-to-all": 3e8}),
}
#: the proxies' signatures: each real one moved, so the orders can differ
PROXY_SCALE = {"compute": (1.0, 40.0), "bytes": (30.0, 0.5),
               "ridge": (1.0, 1.0), "link": (1.0, 1.0),
               "mixed": (2.0, 1.0)}


def _sig(cls, flops, nbytes, coll):
    return cls(flops=flops, bytes=nbytes, collective_bytes=dict(coll))


def _proxy_fields(name):
    flops, nbytes, coll = SIGS[name]
    fs, bs = PROXY_SCALE[name]
    return flops * fs, nbytes * bs, coll


@pytest.mark.parametrize("name", sorted(SIGS))
def test_roofline_step_time_and_ratio_equal_the_reference(name):
    t, j = _sig(Signature, *SIGS[name]), _sig(JSignature, *SIGS[name])
    for hw in jcs.HW_GENS.values():
        assert tcs.roofline_step_time(t, hw) == pytest.approx(
            jcs._roofline_step_time(j, hw), rel=1e-12)
    v4, v5e = jcs.HW_GENS["v4"], jcs.HW_GENS["v5e"]
    want = (jcs._roofline_step_time(j, v4)
            / max(jcs._roofline_step_time(j, v5e), 1e-12))
    assert tcs.generation_ratio(t, jcs.HW_GENS) == pytest.approx(
        want, rel=1e-12)


#: stand-in workloads whose steps' signatures are ``SIGS``
FAKES = {name: SimpleNamespace(name=name, step=name, hints=(),
                               inputs=lambda *a, **k: ())
         for name in SIGS}


def _generate(step, *args, name, **kw):
    return SimpleNamespace(step=step), None


def test_case_c_matches_the_reference_on_the_same_signatures(monkeypatch):
    """Both packages' case C, with the signatures stubbed to ``SIGS``
    (real) and their moved copies (proxy) and the reference's table."""
    monkeypatch.setattr(jcs, "WORKLOADS", FAKES)
    monkeypatch.setattr(jcs, "get_workload", FAKES.__getitem__)
    monkeypatch.setattr(jcs, "signature_of_jitted",
                        lambda step, *a, **k: _sig(JSignature, *SIGS[step]))
    monkeypatch.setattr(jcs, "generate_proxy", _generate)
    monkeypatch.setattr(jcs, "proxy_signature", lambda pb, **k: _sig(
        JSignature, *_proxy_fields(pb.step)))
    want = jcs.case_c_cross_architecture(4)

    monkeypatch.setattr(tcs, "WORKLOADS", FAKES)
    monkeypatch.setattr(tcs, "signature_of_call",
                        lambda step, *a, **k: _sig(Signature, *SIGS[step]))
    monkeypatch.setattr(tcs, "generate_proxy", _generate)
    monkeypatch.setattr(tcs, "proxy_signature", lambda pb, **k: _sig(
        Signature, *_proxy_fields(pb.step)))
    got = tcs.case_c_cross_architecture(4, hw_gens=jcs.HW_GENS,
                                        device="cpu")
    for key in ("real_ratios", "proxy_ratios"):
        assert got[key].keys() == want[key].keys()
        for name in want[key]:
            assert got[key][name] == pytest.approx(want[key][name],
                                                   rel=1e-12)
    for key in ("case", "real_order", "proxy_order", "trend_consistent"):
        assert got[key] == want[key], key
    assert got["real_order"] != got["proxy_order"]  # the stubs moved
    assert got["generations"] == ["v4", "v5e"]


def test_hw_gens_are_two_generations_of_the_card_in_the_reference_keys():
    assert list(tcs.HW_GENS) == ["a100_sxm4_80gb", "h100_sxm5_80gb_700w"]
    for hw in tcs.HW_GENS.values():
        assert set(hw) == set(next(iter(jcs.HW_GENS.values())))
    assert tcs.HW_GENS["h100_sxm5_80gb_700w"] == {
        "peak": 989e12, "hbm": 3.35e12, "ici": 450e9}
    assert tcs.HW_GENS["a100_sxm4_80gb"] == {
        "peak": 312e12, "hbm": 2.039e12, "ici": 300e9}


# -- the documents carry the reference's keys ---------------------------------


def _reference_keys(fn) -> set:
    """Every string key of a dict literal in the reference function."""
    tree = ast.parse(inspect.getsource(fn))
    return {k.value for node in ast.walk(tree) if isinstance(node, ast.Dict)
            for k in node.keys if isinstance(k, ast.Constant)}


def test_the_key_lists_are_the_reference_documents():
    for fn, case in ((jcs.case_a_data_input, "A_data_input"),
                     (jcs.case_c_cross_architecture,
                      "C_cross_architecture")):
        assert _reference_keys(fn) == set(tcs.CASE_KEYS[case])
    b = _reference_keys(jcs.case_b_config_adaptability)
    assert b == {"case"} | set(tcs.WORKLOAD_KEYS)
    assert tcs.CASE_KEYS["B_config_adaptability"] == ("case", "terasort",
                                                      "pagerank")
    assert tcs.missing_keys([{"case": "B_config_adaptability",
                              "terasort": {"orig_mean_acc": 1.0}}]) == [
        "[0].pagerank", "[0].terasort.newcfg_mean_acc",
        "[0].pagerank.orig_mean_acc", "[0].pagerank.newcfg_mean_acc"]


SMALL = PVector(data_size=1 << 10, chunk_size=64, num_tasks=2, batch_size=4,
                height=8, width=8, channels=4)


def test_case_a_quick_cpu_run_has_the_reference_keys():
    doc = tcs.case_a_data_input(
        2, 0.005, base_p=SMALL.replace(distribution="normal", sparsity=0.9),
        device="cpu")
    assert tcs.missing_keys([doc]) == []
    assert doc["case"] == "A_data_input"
    assert 0.0 <= doc["sparse_mean_acc"] <= 1.0
    assert 0.0 <= doc["dense_mean_acc"] <= 1.0
    assert set(doc["timing"]) == {"real_sparse", "proxy_sparse",
                                  "real_dense", "proxy_dense"}
    assert all(t["mode"] == "eager" for t in doc["timing"].values())


def test_case_b_quick_cpu_run_has_the_reference_keys():
    doc = tcs.case_b_config_adaptability(
        2, scales=(0.002, 0.004),
        base_p={n: SMALL.replace(channels=24 if n == "terasort" else 16,
                                 distribution="zipf" if n == "pagerank"
                                 else "uniform")
                for n in ("terasort", "pagerank")},
        device="cpu")
    assert tcs.missing_keys([doc]) == []
    assert set(doc) == {"case", "terasort", "pagerank"}
    for name in ("terasort", "pagerank"):
        assert 0.0 <= doc[name]["newcfg_mean_acc"] <= 1.0
        assert set(doc[name]["timing"]) == {"real_orig", "proxy_orig",
                                            "real_newcfg", "proxy_newcfg"}


def test_case_c_quick_cpu_run_has_the_reference_keys():
    doc = tcs.case_c_cross_architecture(2, scale=0.01, base_p=SMALL,
                                        device="cpu")
    assert tcs.missing_keys([doc]) == []
    names = sorted(tcs.WORKLOADS)
    assert sorted(doc["real_order"]) == sorted(doc["proxy_order"]) == names
    assert all(r > 0 for r in doc["real_ratios"].values())


def test_main_flags_and_document(monkeypatch, tmp_path):
    calls = []

    def stub(case):
        def run(iters, **kw):
            calls.append((case, iters, kw))
            return {"case": case}
        return run

    for case in ("a_data_input", "b_config_adaptability",
                 "c_cross_architecture"):
        monkeypatch.setattr(tcs, f"case_{case}", stub(case))
    out = tmp_path / "cs.json"
    assert tcs.main(["--case", "b", "--iters", "3", "--device", "cpu",
                     "--substrate", "hopper", "--out", str(out)]) == 0
    assert calls == [("b_config_adaptability", 3,
                      {"device": torch.device("cpu"),
                       "substrate": "hopper"})]
    assert json.loads(out.read_text()) == [{"case": "b_config_adaptability"}]
    calls.clear()
    assert tcs.main(["--device", "cpu", "--out", str(out)]) == 0
    assert [(c, i) for c, i, _ in calls] == [
        ("a_data_input", 16), ("b_config_adaptability", 16),
        ("c_cross_architecture", 16)]
    assert all(kw["substrate"] == "torch" for _, _, kw in calls)


# -- the runner ---------------------------------------------------------------


def _record_sections(monkeypatch, modules, fail=None):
    # the roofline section runs the dry run when no sweep is on disk;
    # its table is held to the reference's in test_torch_pod_tools.py
    monkeypatch.setattr(trun, "roofline_section",
                        lambda *a, **k: print("roofline table stub") or 0)
    calls = {}
    for name, mod in modules.items():
        def main(argv=None, _name=name):
            calls[_name] = list(argv or [])
            if _name == fail:
                raise RuntimeError(f"{_name} broke")
            return 0
        monkeypatch.setattr(mod, "main", main)
    return calls


def test_run_calls_each_section_with_the_reference_arguments(monkeypatch,
                                                             capsys):
    from benchmarks import kernels_bench as jkb
    from benchmarks import paper_repro as jpr
    from benchmarks import run as jrun
    from repro_torch.bench import kernels_bench as tkb
    from repro_torch.bench import paper_repro as tpr

    want = _record_sections(monkeypatch, {"kernels_bench": jkb,
                                          "paper_repro": jpr,
                                          "case_studies": jcs})
    assert jrun.main() == 0
    got = _record_sections(monkeypatch, {"kernels_bench": tkb,
                                         "paper_repro": tpr,
                                         "case_studies": tcs})
    assert trun.main(["--device", "cpu"]) == 0
    assert set(got) == set(want) == {"kernels_bench", "paper_repro",
                                     "case_studies"}
    for name in want:
        assert got[name] == want[name] + ["--device", "cpu"], name
    assert "roofline" in capsys.readouterr().out
    assert trun.main([]) == 0
    assert got == want  # no --device: the reference's arguments exactly


@pytest.mark.parametrize("broken", ["kernels_bench", "paper_repro",
                                    "case_studies"])
def test_run_exits_1_when_a_section_raises(monkeypatch, capsys, broken):
    from repro_torch.bench import kernels_bench as tkb
    from repro_torch.bench import paper_repro as tpr

    calls = _record_sections(monkeypatch, {"kernels_bench": tkb,
                                           "paper_repro": tpr,
                                           "case_studies": tcs},
                             fail=broken)
    assert trun.main(["--device", "cpu"]) == 1
    assert set(calls) == {"kernels_bench", "paper_repro", "case_studies"}
    out = capsys.readouterr().out
    label = "kernels" if broken == "kernels_bench" else broken
    assert f"failures=[('{label}', \"RuntimeError('{broken} broke')\")]" \
        in out
