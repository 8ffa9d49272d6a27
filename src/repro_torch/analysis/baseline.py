"""The reprolint baseline: grandfathered findings, strictly shrinking
(port of ``repro/analysis/baseline.py``).

The baseline file (``src/repro_torch/analysis/baseline.json``) lists findings
that predate a rule and are tolerated at ``--check`` time.  Two
invariants keep it honest (``docs/ANALYSIS.md`` states the policy):

* **entries must stay live** — every entry must match a finding the
  current run actually produces at exactly ``(rule, file, line)``.  An
  entry whose line moved, whose file shrank past it, or whose violation
  was fixed is *stale* and fails the gate: fixing a grandfathered site
  forces the entry's removal in the same PR, so the baseline only ever
  shrinks by accident of progress — and grows only by deliberate,
  justified addition (every entry carries a ``note``).
* **matching is exact** — no fuzzy line windows.  A refactor that moves
  a grandfathered site must re-justify it at its new location.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.analysis.findings import Finding

BASELINE_VERSION = 1

#: repo-relative default location of the checked-in baseline
DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.json"


def load(path: Path) -> List[Dict[str, Any]]:
    """Baseline entries; a missing file is an empty baseline."""
    p = Path(path)
    if not p.exists():
        return []
    doc = json.loads(p.read_text())
    entries = doc.get("entries", [])
    for e in entries:
        for field in ("rule", "file", "line"):
            if field not in e:
                raise ValueError(
                    f"baseline entry missing {field!r}: {e!r}")
        if not e.get("note"):
            raise ValueError(
                f"baseline entry for {e['file']}:{e['line']} has no "
                "'note' — every grandfathered site needs a justification")
    return entries


def split(findings: Sequence[Finding],
          entries: Sequence[Dict[str, Any]],
          ) -> Tuple[List[Finding], List[Finding], List[Dict[str, Any]]]:
    """Partition into (active, baselined, stale-entries).

    A finding matching an entry on ``(rule, file, line)`` is baselined;
    an entry matching no finding is stale (the gate fails on it — the
    entry must be deleted, which is how the baseline shrinks).
    """
    keys = {(e["rule"], e["file"], int(e["line"])): e for e in entries}
    active: List[Finding] = []
    baselined: List[Finding] = []
    matched = set()
    for f in findings:
        k = (f.rule, f.file, f.line)
        if k in keys:
            matched.add(k)
            baselined.append(f)
        else:
            active.append(f)
    stale = [e for k, e in keys.items() if k not in matched]
    return active, baselined, stale
