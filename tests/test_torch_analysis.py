"""The port's reprolint (``repro_torch.analysis``) held against the
reference's (``repro.analysis``) on the CPU.

* **Shared fixtures.**  The reference test file's fixture trees
  (``tests/test_analysis.py``), written once under ``src/repro`` and once
  under ``src/repro_torch``: both analyzers give the same
  ``(rule, file under their root, line, message)`` for every rule but
  ``trace-purity``, and for ``trace-purity`` under a ``vmap`` root.
* **The port's roots.**  One fixture for each root spelling the port adds
  (``timed_wall(lambda: ...)``, ``CapturedGraph(fn)``,
  ``profile_call(local)``, ``define_op(schema, impl)``, a wrapper of
  ``vmap``), each firing on a clock read and clean without one.
* **The real trees.**  The port's ``trace-purity`` reaches every function
  the reference's rule reaches that has a counterpart at the same path
  and qualified name, but for the exceptions listed with their reasons;
  an unregistered ``PVector`` field and a clock read spliced into copies
  of the port's own files fire; and the port is clean under its lint.
"""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import analyze as ref_analyze
from repro.analysis import rule_ids as ref_rule_ids
from repro.analysis.rules import purity as ref_purity
from repro.analysis.walker import collect as ref_collect
from repro.analysis.walker import walk_functions as ref_walk_functions
from repro_torch.analysis import analyze, build_context, rule_ids, run_rules
from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import doc_tables
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.rules import purity
from repro_torch.analysis.walker import IGNORE_RE, collect, parse_source

REPO = Path(__file__).resolve().parents[1]

# ---------------------------------------------------------------------------
# fixture trees (the reference test file's, in both packages)
# ---------------------------------------------------------------------------

BASE_PY = '''\
from dataclasses import dataclass

STRUCTURAL_FIELDS = ("data_size",)
LIFTED_FIELDS = ("sparsity",)


@dataclass(frozen=True)
class PVector:
    data_size: int = 1
    sparsity: float = 0.0

    def structural_key(self):
        return (self.data_size,)

    def lifted_row(self):
        return (self.sparsity,)
'''

EVAL_DOC = """# Evaluator contract (fixture)

## The structural-vs-lifted P-field table

| field | role |
|---|---|
| `data_size` | structural |
| `sparsity` | lifted |
"""

OBS_DOC = """# Observability contract (fixture)

## The span-kind table

| span kind | required attrs | emitted by |
|---|---|---|
| `eval.batch` | `candidates` | engine |

## The instant-event table

| event kind | required attrs | emitted by |
|---|---|---|
| `cache.hit` | `key` | cache |

## The metric-name table

| metric name | kind | meaning |
|---|---|---|
| `requests_total` | counter | served requests |
"""

#: what a vmap root is spelled as in each package
SPELLING = {"repro": {"__IMPORT__": "import jax", "__VMAP__": "jax.vmap"},
            "repro_torch": {"__IMPORT__": "import torch",
                            "__VMAP__": "torch.func.vmap"}}

GHOST = BASE_PY.replace("    sparsity: float = 0.0",
                        "    sparsity: float = 0.0\n    ghost: int = 0")


def mini_repo(root, pkg="repro_torch", files=None, base=BASE_PY,
              eval_doc=EVAL_DOC, obs_doc=OBS_DOC):
    """A throwaway repo tree with ``pkg`` under ``src/`` (both packages
    when ``pkg`` is None); ``base=None`` leaves out core/motifs/base.py."""
    docs = root / "docs"
    docs.mkdir(parents=True, exist_ok=True)
    (docs / "EVALUATOR.md").write_text(eval_doc)
    (docs / "OBSERVABILITY.md").write_text(obs_doc)
    for name in ((pkg,) if pkg else tuple(SPELLING)):
        src = root / "src" / name
        src.mkdir(parents=True)
        if base is not None:
            (src / "core" / "motifs").mkdir(parents=True)
            (src / "core" / "motifs" / "base.py").write_text(base)
        for rel, text in (files or {}).items():
            for token, spelt in SPELLING[name].items():
                text = text.replace(token, spelt)
            p = src / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(textwrap.dedent(text))
    return root


def run(root, *rules, baseline=None):
    return analyze(root, baseline_path=baseline,
                   rule_ids=list(rules) or None)


_EXC_TMPL = """\
    def f():
        try:
            return 1
        except {handler}
            return 0
"""

_PURITY_TMPL = ("import os\nimport random\n__IMPORT__\nimport numpy as np"
                "\n\n\ndef traced(x):\n{body}\n\nfast = __VMAP__(traced)\n")

#: name -> (fixture tree, the findings' count); the trees are the
#: reference test file's, with every trace root spelt as a vmap
SHARED = {
    "kv-clean": (dict(), 0),
    "kv-ghost": (dict(base=GHOST), 2),
    "kv-structural-key-read": (dict(base=BASE_PY.replace(
        "    data_size: int = 1", "    data_size: int = 1\n    extra: int = 0"
    ).replace("        return (self.data_size,)",
              "        return (self.data_size, self.extra)")), 1),
    "kv-stale-entry": (dict(base=BASE_PY.replace(
        'STRUCTURAL_FIELDS = ("data_size",)',
        'STRUCTURAL_FIELDS = ("data_size", "legacy")')), 1),
    "kv-motif-read": (dict(base=GHOST, files={
        "core/motifs/execute.py": """\
            def execute(p, x):
                return x * p.ghost + p.data_size
        """}), 3),
    "kv-missing-base": (dict(base=None), 1),
    "tp-reachable-clock": (dict(files={"core/engine.py": """\
        import time
        __IMPORT__


        def helper():
            return time.time()


        def traced(x):
            return x + helper()


        fast = __VMAP__(traced)
    """}), 1),
    "tp-unreachable-clock": (dict(files={"core/engine.py": """\
        import time
        __IMPORT__


        def host_side_timer():
            return time.time()


        def traced(x):
            return x + 1


        fast = __VMAP__(traced)
    """}), 0),
    "tp-factory": (dict(files={"kernels/k.py": """\
        import time
        __IMPORT__


        def make():
            def lane(x):
                return x + time.monotonic()
            return lane


        fast = __VMAP__(make())
    """}), 1),
    "tp-outside-scope": (dict(files={"runtime/bench.py": """\
        import time
        __IMPORT__


        def traced(x):
            return x + time.time()


        fast = __VMAP__(traced)
    """}), 0),
    "tp-inline-ignore": (dict(files={"core/engine.py": """\
        import time
        __IMPORT__


        def traced(x):
            return x + time.time()  # reprolint: ignore[trace-purity]


        fast = __VMAP__(traced)
    """}), 0),
    **{f"tp-catalogue-{i}": (dict(files={"core/engine.py": _PURITY_TMPL.format(
        body="".join(f"    {ln}\n" for ln in body.splitlines()))}), 1)
       for i, body in enumerate([
           "return x + np.random.rand()",
           "return random.random() + x",
           "return float(os.environ['SEED']) + x",
           "return x.item()",
           "acc = 0\nfor v in {1, 2, 3}:\n    acc += v\nreturn acc + x"])},
    "aio-open-w": (dict(files={"results.py": """\
        import json


        def dump(path, doc):
            with open(path, "w") as f:
                json.dump(doc, f)
    """}), 1),
    "aio-binary-and-read": (dict(files={"results.py": """\
        def save(path, payload, other):
            with open(path, "wb") as f:
                f.write(payload)
            with open(other) as f:
                return f.read()
    """}), 0),
    "aio-write-text-and-fdopen": (dict(files={"results.py": """\
        import os
        from pathlib import Path


        def a(p, text):
            Path(p).write_text(text)


        def b(fd, text):
            with os.fdopen(fd, "w") as f:
                f.write(text)
    """}), 2),
    "aio-helper-allowlisted": (dict(files={"core/store.py": """\
        import os


        def atomic_write_text(path, text):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, path)
    """}), 0),
    "aio-wildcard-ignore": (dict(files={"results.py": """\
        def dump(path, text):
            with open(path, "w") as f:  # reprolint: ignore[*]
                f.write(text)
    """}), 0),
    **{f"exc-{i}": (dict(files={"core/thing.py": _EXC_TMPL.format(
        handler=handler)}), n) for i, (handler, n) in enumerate([
            ("Exception:", 1),
            ("Exception:  # noqa: BLE001", 1),
            ("BaseException as e:", 1),
            ("(ValueError, Exception):", 1),
            ("Exception:  # noqa: BLE001 — provider isolation is the "
             "contract", 0),
            ("ValueError:", 0)])},
    "exc-reraising-cleanup": (dict(files={"core/thing.py": """\
        def f(tmp):
            try:
                return 1
            except BaseException:
                tmp.unlink()
                raise
    """}), 0),
    "exc-untyped-raise": (dict(files={
        "runtime/server.py": """\
            class ServerClosed(RuntimeError):
                pass


            def submit(closed):
                if closed:
                    raise RuntimeError("server closed")
        """,
        "core/elsewhere.py": """\
            def g():
                raise RuntimeError("fine here: not a typed-raise scope")
        """}), 1),
    "exc-typed-raise": (dict(files={"runtime/server.py": """\
        class ServerClosed(RuntimeError):
            pass


        def submit(closed, e=None):
            if closed:
                raise ServerClosed("closed")
            if e is not None:
                raise e
    """}), 0),
    "tel-documented": (dict(files={"core/engine.py": """\
        def work(hub, reg, name):
            with hub.span("eval.batch", candidates=3):
                hub.event("cache.hit", key="k")
            reg.counter("requests_total").inc()
            hub.span(name)  # dynamic: the dynamic tests' job
    """}), 0),
    "tel-undocumented": (dict(files={"core/engine.py": """\
        def work(hub, reg):
            with hub.span("eval.bogus"):
                hub.event("cache.bogus", key="k")
            reg.gauge("undocumented_gauge").set(1)
    """}), 3),
    "tel-missing-doc": (dict(obs_doc="# no tables here\n"), 1),
}


def _keyed(report, pkg):
    """The report's findings and inline-ignored findings as
    ``(rule, file under src/<pkg>, line, message)``, sorted."""
    prefix = f"src/{pkg}/"

    def key(f):
        rel = f.file[len(prefix):] if f.file.startswith(prefix) else f.file
        return (f.rule, rel, f.line, f.message)

    return (sorted(map(key, report.findings)),
            sorted(map(key, report.ignored)))


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_fixtures_match_the_reference(tmp_path, case):
    tree, n = SHARED[case]
    root = mini_repo(tmp_path / "repo", pkg=None, **tree)
    want = ref_analyze(root, src_root=root / "src" / "repro")
    got = analyze(root)
    assert _keyed(got, "repro_torch") == _keyed(want, "repro")
    assert len(got.findings) == n, [f.render() for f in got.findings]
    assert got.files_scanned == want.files_scanned


# ---------------------------------------------------------------------------
# trace-purity: the port's roots
# ---------------------------------------------------------------------------

#: spelling -> (file, source with CLOCK where the clock read goes, line
#: of the read, the function that holds it)
PORT_ROOTS = {
    "timed_wall-lambda": ("core/bench_step.py", """\
        import time
        from repro_torch.core.signature import timed_wall


        def helper(x):
            return x + CLOCK


        def measure(x, dev):
            return timed_wall(lambda: helper(x), device=dev)
    """, 6, "helper"),
    "CapturedGraph-name": ("core/graph.py", """\
        import time


        def body():
            return CLOCK


        def replay_twice(dev):
            with CapturedGraph(body, 2, dev) as graph:
                graph.replay()
                graph.replay()
    """, 5, "body"),
    "profile_call-local": ("core/profile.py", """\
        import time


        def make_runner(scale):
            def runner(x):
                return x * scale + CLOCK
            return runner


        def profile(x):
            fn = make_runner(2.0)
            return profile_call(fn, x)
    """, 6, "make_runner"),
    "define_op-impl": ("kernels/op.py", """\
        import time
        from repro_torch.kernels import _build


        def _op_impl(x):
            return x + CLOCK


        _build.define_op("op(Tensor x) -> Tensor", _op_impl)
    """, 6, "_op_impl"),
    "vmap-wrapper": ("core/population.py", """\
        import time
        import torch


        class Entry:
            def __init__(self, fn):
                self.vmapped = torch.func.vmap(fn)


        def make_lanes():
            def lane(x):
                return x + CLOCK
            return lane


        ENTRY = Entry(make_lanes())
    """, 12, "make_lanes"),
}


@pytest.mark.parametrize("clock", ["time.time()", "1.0"])
@pytest.mark.parametrize("spelling", sorted(PORT_ROOTS))
def test_port_root_spellings(tmp_path, spelling, clock):
    rel, src, line, qual = PORT_ROOTS[spelling]
    root = mini_repo(tmp_path / "repo",
                     files={rel: src.replace("CLOCK", clock)})
    report = run(root, "trace-purity")
    if clock == "1.0":
        assert report.findings == []
        return
    (f,) = report.findings
    assert (f.file, f.line) == (f"src/repro_torch/{rel}", line)
    assert f.message.startswith(f"host clock read time.time() in {qual!r}")


def _reference_reach():
    """``(file, qualname)`` of every function the reference's rule
    reaches over src/repro, from its own helpers."""
    files = [sf for sf in ref_collect(REPO / "src" / "repro", REPO)
             if sf.rel_src.startswith(ref_purity.SCOPES)]
    index = {}
    roots = set()
    for sf in files:
        for qual, fn in ref_walk_functions(sf.tree):
            index.setdefault(fn.name, []).append((sf, fn, qual))
            if ref_purity._decorator_roots(fn):
                roots.add(fn.name)
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                roots |= ref_purity._root_names_from_call(node)
    seen, out = set(), set()
    work = [e for name in roots for e in index.get(name, ())]
    while work:
        sf, fn, qual = work.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        out.add((sf.rel_src, qual))
        work += [e for name in ref_purity._referenced_names(fn)
                 for e in index.get(name, ()) if id(e[1]) not in seen]
    return out


#: counterparts of reference-reached functions that the port's rule may
#: not reach, each with its reason
PORT_UNREACHED = {
    ("kernels/bitonic_sort.py", "sort_sentinel"):
        "the op pads with the SENTINELS table; nothing under core/ or "
        "kernels/ calls sort_sentinel, a public helper",
    ("kernels/flash_attention.py", "flash_attention_single"):
        "the op covers every batch and head in one launch, where the "
        "reference vmaps its single-head kernel; nothing under core/ or "
        "kernels/ calls the one-head wrapper",
}


def test_port_reaches_the_reference_reach_on_the_real_trees():
    ref = _reference_reach()
    port_files = collect(REPO / "src" / "repro_torch", REPO)
    port_funcs = {(sf.rel_src, q) for sf in port_files
                  for q, _ in ref_walk_functions(sf.tree)}
    counterparts = ref & port_funcs
    assert len(ref) >= 100 and len(counterparts) >= 77
    reached = {(sf.rel_src, q) for sf, _, q in purity.reachable(port_files)}
    assert counterparts - reached == set(PORT_UNREACHED)
    # the kernel wrappers, their plain versions and the population form
    # are reached through the op definitions and the vmap wrapper
    assert {("kernels/ref.py", "matmul"), ("kernels/matmul.py", "matmul"),
            ("kernels/moe_dispatch.py", "moe_dispatch"),
            ("core/proxy_graph.py", "ProxyBenchmark.build_lifted_fn")
            } <= reached


def _copy_port(dst: Path) -> Path:
    root = mini_repo(dst, base=None)
    shutil.copytree(REPO / "src" / "repro_torch", root / "src" /
                    "repro_torch", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("_build", "csrc",
                                                  "__pycache__"))
    return root


def test_clock_spliced_into_build_eval_fn_fires(tmp_path):
    root = _copy_port(tmp_path / "repo")
    assert run(root, "trace-purity").findings == []
    path = root / "src" / "repro_torch" / "core" / "proxy_graph.py"
    text = path.read_text()
    (fn,) = [n for n in ast.walk(ast.parse(text))
             if isinstance(n, ast.FunctionDef) and n.name == "build_eval_fn"]
    at = fn.body[-1].lineno  # its return: the traced body it hands out
    lines = text.splitlines(keepends=True)
    indent = re.match(r"\s*", lines[at - 1]).group(0)
    lines.insert(at - 1, f"{indent}_t0 = time.time()\n")
    path.write_text("".join(lines))
    (f,) = run(root, "trace-purity").findings
    assert (f.file, f.line) == ("src/repro_torch/core/proxy_graph.py", at)
    assert "'ProxyBenchmark.build_eval_fn'" in f.message


# ---------------------------------------------------------------------------
# key-visibility on the port's real base.py
# ---------------------------------------------------------------------------


def test_phantom_field_in_the_real_base_fires_twice(tmp_path):
    real_base = (REPO / "src/repro_torch/core/motifs/base.py").read_text()
    real_doc = (REPO / "docs/EVALUATOR.md").read_text()
    clean = run(mini_repo(tmp_path / "a", base=real_base, eval_doc=real_doc),
                "key-visibility")
    assert clean.findings == []
    m = re.search(r"(class PVector.*?\n)(\s+)(\w+\s*:)", real_base, re.S)
    injected = (real_base[:m.start(3)] + "phantom_knob: int = 0\n"
                + m.group(2) + real_base[m.start(3):])
    report = run(mini_repo(tmp_path / "b", base=injected, eval_doc=real_doc),
                 "key-visibility")
    msgs = [f.message for f in report.findings]
    assert len(msgs) == 2 and all("'phantom_knob'" in m for m in msgs)
    assert any("invisible to the cache key" in m for m in msgs)
    assert any("no row in the docs/EVALUATOR.md" in m for m in msgs)


# ---------------------------------------------------------------------------
# suppression machinery: inline ignores + baseline
# ---------------------------------------------------------------------------


def test_ignore_regex_parses_lists_and_wildcard():
    m = IGNORE_RE.search("x = 1  # reprolint: ignore[atomic-io, a-b]")
    assert m and m.group(1) == "atomic-io, a-b"
    assert IGNORE_RE.search("# reprolint: ignore[*]")


def test_comment_only_ignore_shields_next_line(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("# reprolint: ignore[atomic-io]\n"
                 "f = open('x', 'w')\n"
                 "g = open('y', 'w')\n")
    sf = parse_source(p, tmp_path, tmp_path)
    assert sf.ignored(1, "atomic-io") and sf.ignored(2, "atomic-io")
    assert not sf.ignored(3, "atomic-io")
    assert not sf.ignored(2, "trace-purity")


def _violating_repo(tmp_path):
    return mini_repo(tmp_path / "repo", files={
        "results.py": """\
            def dump(path, text):
                with open(path, "w") as f:
                    f.write(text)
        """})


def _baseline(tmp_path, entries):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"version": 1, "entries": entries}))
    return p


SITE = {"rule": "atomic-io", "file": "src/repro_torch/results.py"}


@pytest.mark.parametrize("lines,clean,active,stale", [
    ([2], True, 0, []),      # an exact match grandfathers the finding
    ([2, 99], False, 0, [99]),  # an entry that matches nothing is stale
    ([3], False, 1, [3]),    # matching is exact, not fuzzy
])
def test_baseline(tmp_path, lines, clean, active, stale):
    b = _baseline(tmp_path, [{**SITE, "line": n, "note": "legacy writer"}
                             for n in lines])
    report = run(_violating_repo(tmp_path), "atomic-io", baseline=b)
    assert report.clean is clean
    assert len(report.findings) == active
    assert len(report.baselined) == 1 - active
    assert [e["line"] for e in report.stale_baseline] == stale


def test_baseline_entry_without_note_is_rejected(tmp_path):
    b = _baseline(tmp_path, [{**SITE, "line": 2}])
    with pytest.raises(ValueError, match="note"):
        baseline_mod.load(b)


def test_checked_in_baseline_is_well_formed_and_empty():
    """Every finding on the port was fixed or suppressed inline with its
    reason; a PR growing the baseline needs a note for each entry."""
    assert baseline_mod.DEFAULT_BASELINE == \
        "src/repro_torch/analysis/baseline.json"
    assert baseline_mod.load(REPO / baseline_mod.DEFAULT_BASELINE) == []


# ---------------------------------------------------------------------------
# engine, CLI, registry, imports and the port's gate
# ---------------------------------------------------------------------------


def test_unknown_rule_id_raises(tmp_path):
    ctx = build_context(mini_repo(tmp_path / "repo"))
    with pytest.raises(KeyError, match="no-such-rule"):
        run_rules(ctx, ["no-such-rule"])


def test_report_dict_shape(tmp_path):
    doc = run(_violating_repo(tmp_path)).as_dict()
    assert set(doc) == {"clean", "wall_s", "files_scanned",
                        "baseline_size", "rules", "findings",
                        "baselined", "stale_baseline"}
    assert doc["clean"] is False
    assert set(doc["rules"]) == set(rule_ids())
    (f,) = [f for f in doc["findings"] if f["rule"] == "atomic-io"]
    assert f["file"] == "src/repro_torch/results.py" and f["line"] == 2
    assert "repro_torch.core.store.atomic_write_text" in f["hint"]


def test_cli_check_report_filter_and_list(tmp_path, capsys):
    root = _violating_repo(tmp_path)
    assert cli_main(["--check"], repo_root=root) == 1
    assert "src/repro_torch/results.py:2: [atomic-io]" in \
        capsys.readouterr().out
    out = tmp_path / "results" / "reprolint_torch.json"
    assert cli_main(["--out", str(out)], repo_root=root) == 0  # no --check
    doc = json.loads(out.read_text())
    assert doc["clean"] is False
    assert doc["rules"]["atomic-io"]["findings"] == 1
    assert cli_main(["--check", "--rules", "telemetry-names"],
                    repo_root=root) == 0
    assert cli_main(["--list-rules"], repo_root=root) == 0
    assert "key-visibility" in capsys.readouterr().out


def test_cli_module_checks_the_checkout_from_any_directory(tmp_path):
    """``python -m repro_torch.analysis.cli --check`` finds the repo from
    its own file, not from the working directory."""
    out = tmp_path / "reprolint_torch.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.cli", "--check",
         "--out", str(out)], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(out.read_text())
    assert doc["clean"] is True and doc["files_scanned"] > 100
    assert list(doc["rules"]) == list(ref_rule_ids())


def test_rule_registry_matches_the_reference_and_the_doc():
    doc = [rid for rid, _ in
           doc_tables.analysis_rule_rows(REPO / "docs" / "ANALYSIS.md")]
    assert rule_ids() == ref_rule_ids() == tuple(doc)


def test_analysis_imports_nothing_of_jax_or_the_reference():
    files = sorted((REPO / "src" / "repro_torch" / "analysis").rglob("*.py"))
    assert len(files) == 13
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, path
                mods = [node.module]
            else:
                continue
            roots = {m.split(".")[0] for m in mods}
            assert not roots & {"jax", "jaxlib", "repro"}, (path, mods)


def test_the_port_is_clean_under_its_lint():
    """The port's gate, which ``chip_smoke.py``'s lint phase also runs."""
    report = analyze(REPO)
    rendered = "\n".join(f.render() for f in report.findings)
    assert report.clean, f"reprolint findings on src/repro_torch:\n{rendered}"
    assert report.files_scanned > 100
    assert report.rule_ids == rule_ids()
