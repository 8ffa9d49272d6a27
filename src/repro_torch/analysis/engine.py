"""The reprolint engine: context construction, rule running, reporting
(port of ``repro/analysis/engine.py``).

``analyze(repo_root)`` is the whole pipeline: walk ``src/repro_torch``, run
every registered rule, apply inline ``# reprolint: ignore[...]``
suppressions, split against the checked-in baseline, and return a
:class:`Report` the CLI renders and serialises to
``results/reprolint_torch.json``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import rules as rules_mod
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.walker import SourceFile, collect

#: the default analysis root, relative to the repo root
DEFAULT_ROOT = "src/repro_torch"


@dataclass
class AnalysisContext:
    """Everything a rule may consult."""

    repo_root: Path
    src_root: Path
    docs_dir: Path
    files: List[SourceFile]
    _by_rel_src: Dict[str, SourceFile] = field(default_factory=dict)

    def __post_init__(self):
        self._by_rel_src = {sf.rel_src: sf for sf in self.files}

    def get(self, rel_src: str) -> Optional[SourceFile]:
        return self._by_rel_src.get(rel_src)

    def by_rel(self, rel: str) -> Optional[SourceFile]:
        for sf in self.files:
            if sf.rel == rel:
                return sf
        return None


def build_context(repo_root: Path, src_root: Optional[Path] = None,
                  docs_dir: Optional[Path] = None) -> AnalysisContext:
    repo_root = Path(repo_root).resolve()
    src_root = (Path(src_root) if src_root is not None
                else repo_root / DEFAULT_ROOT).resolve()
    docs_dir = (Path(docs_dir) if docs_dir is not None
                else repo_root / "docs").resolve()
    return AnalysisContext(repo_root=repo_root, src_root=src_root,
                           docs_dir=docs_dir,
                           files=collect(src_root, repo_root))


@dataclass
class Report:
    """One full analysis run."""

    findings: List[Finding]          # active (not ignored, not baselined)
    baselined: List[Finding]
    ignored: List[Finding]           # inline-suppressed
    stale_baseline: List[Dict[str, Any]]
    rule_ids: Tuple[str, ...]
    files_scanned: int
    baseline_size: int
    wall_s: float

    @property
    def clean(self) -> bool:
        return not self.findings and not self.stale_baseline

    def rule_counts(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {
            r: {"findings": 0, "baselined": 0, "ignored": 0}
            for r in self.rule_ids}
        for bucket, fs in (("findings", self.findings),
                           ("baselined", self.baselined),
                           ("ignored", self.ignored)):
            for f in fs:
                out.setdefault(f.rule, {"findings": 0, "baselined": 0,
                                        "ignored": 0})[bucket] += 1
        return out

    def as_dict(self) -> Dict[str, Any]:
        return {
            "clean": self.clean,
            "wall_s": self.wall_s,
            "files_scanned": self.files_scanned,
            "baseline_size": self.baseline_size,
            "rules": self.rule_counts(),
            "findings": [f.as_dict() for f in self.findings],
            "baselined": [f.as_dict() for f in self.baselined],
            "stale_baseline": list(self.stale_baseline),
        }


def run_rules(ctx: AnalysisContext,
              rule_ids: Optional[Sequence[str]] = None,
              ) -> Tuple[List[Finding], List[Finding]]:
    """Run the selected rules; returns (kept, inline-ignored)."""
    ids = tuple(rule_ids) if rule_ids else rules_mod.rule_ids()
    unknown = set(ids) - set(rules_mod.rule_ids())
    if unknown:
        raise KeyError(f"unknown rule ids {sorted(unknown)}; "
                       f"have {list(rules_mod.rule_ids())}")
    kept: List[Finding] = []
    ignored: List[Finding] = []
    for rid in ids:
        for f in rules_mod.run_rule(rid, ctx):
            sf = ctx.by_rel(f.file)
            if sf is not None and sf.ignored(f.line, f.rule):
                ignored.append(f)
            else:
                kept.append(f)
    kept.sort(key=Finding.sort_key)
    ignored.sort(key=Finding.sort_key)
    return kept, ignored


def analyze(repo_root: Path, src_root: Optional[Path] = None,
            docs_dir: Optional[Path] = None,
            baseline_path: Optional[Path] = None,
            rule_ids: Optional[Sequence[str]] = None) -> Report:
    t0 = time.perf_counter()
    ctx = build_context(repo_root, src_root, docs_dir)
    findings, ignored = run_rules(ctx, rule_ids)
    bpath = (Path(baseline_path) if baseline_path is not None
             else Path(repo_root) / baseline_mod.DEFAULT_BASELINE)
    entries = baseline_mod.load(bpath)
    active, baselined, stale = baseline_mod.split(findings, entries)
    return Report(
        findings=active,
        baselined=baselined,
        ignored=ignored,
        stale_baseline=stale,
        rule_ids=tuple(rule_ids) if rule_ids else rules_mod.rule_ids(),
        files_scanned=len(ctx.files),
        baseline_size=len(entries),
        wall_s=time.perf_counter() - t0,
    )
