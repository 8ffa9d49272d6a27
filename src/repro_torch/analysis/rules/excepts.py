"""Rule ``except-typing`` — failure paths must be typed or justified
(port of ``repro/analysis/rules/excepts.py``).

Two halves, both about keeping the stress tier's ``typed_errors`` gate
meaningful (``docs/TUNER.md`` stress-tier contract):

* **Broad catches need a reason.**  ``except Exception`` / bare
  ``except`` / ``except BaseException`` swallows the typed errors the
  conformance gates classify on.  Sometimes a total fallback IS the
  contract (the store's never-crash triad) — then the site must say so:
  ``# noqa: BLE001 — <reason>`` on the handler line.  A bare
  ``# noqa: BLE001`` with no reason is a suppression, not a
  justification, and still flags.  Cleanup handlers that re-raise
  (``except BaseException: ...; raise``) are exempt: nothing is
  swallowed.

* **Raises in cluster/runtime code use the typed hierarchy.**
  ``core/cluster.py`` and ``runtime/`` are the layers whose callers
  (the stress matrix, ``FaultTolerantRunner``, the server dispatcher)
  dispatch on exception type; raising generic ``Exception`` /
  ``RuntimeError`` there defeats them.  Use ``ClusterError``,
  ``ServerClosed``, or a precise builtin.
"""
from __future__ import annotations

import ast
import re
from typing import List, Optional

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import rule
from repro_torch.analysis.walker import SourceFile, call_name

#: a justified broad-except comment: noqa code + a dash + actual words
NOQA_REASON_RE = re.compile(r"#\s*noqa:\s*BLE001\b[^\S\n]*[—–-]+\s*\S")
NOQA_BARE_RE = re.compile(r"#\s*noqa:\s*BLE001\b")

BROAD = frozenset({"Exception", "BaseException"})

#: files whose raise sites must use the typed hierarchy
TYPED_RAISE_SCOPES = ("core/cluster.py", "runtime/")
#: generic types that defeat typed dispatch when raised there
UNTYPED_RAISES = frozenset({"Exception", "BaseException", "RuntimeError"})

EXC_HINT = ("narrow the handler to the concrete exception types this "
            "site expects, or justify the broad catch in place: "
            "'# noqa: BLE001 — <why swallowing everything is the "
            "contract here>'")
RAISE_HINT = ("raise a typed error (ClusterError, ServerClosed, or a "
              "precise builtin like ValueError/TimeoutError) so the "
              "stress tier's typed_errors gate and retry policies can "
              "dispatch on it")


def _is_broad(h: ast.ExceptHandler) -> Optional[str]:
    """The broad-catch spelling, or None for a typed handler."""
    t = h.type
    if t is None:
        return "bare except"
    names = []
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in elts:
        n = e.id if isinstance(e, ast.Name) else (
            e.attr if isinstance(e, ast.Attribute) else None)
        if n in BROAD:
            names.append(n)
    return f"except {'/'.join(names)}" if names else None


def _reraises(h: ast.ExceptHandler) -> bool:
    """A handler whose body re-raises (bare ``raise`` or ``raise e`` of
    the bound name) swallows nothing — cleanup-only, exempt."""
    bound = h.name
    for node in ast.walk(h):
        if isinstance(node, ast.Raise):
            if node.exc is None:
                return True
            if (bound and isinstance(node.exc, ast.Name)
                    and node.exc.id == bound):
                return True
    return False


def _justified(sf: SourceFile, line: int) -> Optional[bool]:
    """True = justified, False = bare noqa without reason, None = no
    noqa at all.  Looks at the handler line and the line above (for a
    comment that had to wrap)."""
    for ln in (line, line - 1):
        text = sf.line_text(ln)
        if NOQA_REASON_RE.search(text):
            return True
        if NOQA_BARE_RE.search(text):
            return False
    return None


@rule("except-typing",
      "broad excepts need '# noqa: BLE001 — reason'; cluster/runtime "
      "raises must use the typed error hierarchy")
def run(ctx) -> List[Finding]:
    findings: List[Finding] = []
    for sf in ctx.files:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ExceptHandler):
                broad = _is_broad(node)
                if broad is None or _reraises(node):
                    continue
                j = _justified(sf, node.lineno)
                if j is True:
                    continue
                detail = ("carries a bare '# noqa: BLE001' with no "
                          "reason" if j is False else
                          "has no justification comment")
                findings.append(Finding(
                    "except-typing", sf.rel, node.lineno,
                    f"broad '{broad}' {detail} — it swallows the typed "
                    "errors the conformance gates classify on", EXC_HINT))
            elif isinstance(node, ast.Raise):
                if not sf.rel_src.startswith(TYPED_RAISE_SCOPES):
                    continue
                exc = node.exc
                if not isinstance(exc, ast.Call):
                    continue  # bare re-raise / `raise e` are fine
                name = call_name(exc.func)
                if name in UNTYPED_RAISES:
                    findings.append(Finding(
                        "except-typing", sf.rel, node.lineno,
                        f"untyped 'raise {name}(...)' in {sf.rel_src} — "
                        "cluster/runtime failure paths must use the "
                        "typed error hierarchy", RAISE_HINT))
    return findings
