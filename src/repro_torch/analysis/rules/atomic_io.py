"""Rule ``atomic-io`` — result/store writes must be atomic (port of
``repro/analysis/rules/atomic_io.py``).

The serving story (``docs/SERVING.md``) rests on a durability promise:
a reader observes either the previous complete file or the new one,
never a partial.  ``repro_torch.core.store.atomic_write_text`` (unique
temp + fsync + ``os.replace``) is the one primitive that delivers it,
and ``repro_torch.bench._io.write_json`` rides on top for JSON
artifacts.  A bare
``open(path, "w")`` anywhere under ``src/`` breaks the promise the
moment a crash lands between ``open`` and ``close``: a truncated
manifest/report that parses as garbage or — worse — as valid-but-stale
JSON.  This rule flags every text-mode write that bypasses the helper.

The helper's own ``open(tmp, "w")`` is the single allowlisted site
(it writes a unique temp name, invisible until the rename commits).
Binary payload writes (``"wb"``, e.g. checkpoint ``.npy`` leaves inside
a not-yet-renamed temp directory) are out of scope: their atomicity is
the enclosing directory rename.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import rule
from repro_torch.analysis.walker import enclosing_function_map

#: (rel_src file, enclosing function) pairs exempt from the rule
ALLOWLIST = (("core/store.py", "atomic_write_text"),)

HINT = ("route the write through repro_torch.core.store.atomic_write_text "
        "(or repro_torch.bench._io.write_json for JSON artifacts) so a crash "
        "mid-write leaves the old file or the new one, never a partial")


def _write_mode(call: ast.Call) -> Optional[str]:
    """The literal text-write mode of an ``open``/``os.fdopen`` call,
    or None when the call is not a text-mode write."""
    f = call.func
    is_open = (isinstance(f, ast.Name) and f.id == "open") or (
        isinstance(f, ast.Attribute) and f.attr == "fdopen"
        and isinstance(f.value, ast.Name) and f.value.id == "os")
    if not is_open:
        return None
    mode_node: Optional[ast.AST] = None
    if len(call.args) >= 2:
        mode_node = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode_node = kw.value
    if not (isinstance(mode_node, ast.Constant)
            and isinstance(mode_node.value, str)):
        return None
    mode = mode_node.value
    if "w" in mode and "b" not in mode:
        return mode
    return None


@rule("atomic-io",
      "text-mode writes under src/ must go through "
      "core.store.atomic_write_text / bench._io.write_json")
def run(ctx) -> List[Finding]:
    findings: List[Finding] = []
    for sf in ctx.files:
        scopes = enclosing_function_map(sf.tree)
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            mode = _write_mode(node)
            if mode is None:
                continue
            fname = scopes.get(id(node), "<module>")
            # allowlist matches the innermost function name
            leaf = fname.rsplit(".", 1)[-1]
            if (sf.rel_src, leaf) in ALLOWLIST:
                continue
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "fdopen"):
                what = f"os.fdopen(..., {mode!r})"
            else:
                what = f"open(..., {mode!r})"
            findings.append(Finding(
                "atomic-io", sf.rel, node.lineno,
                f"non-atomic text write {what} in {fname} — a crash "
                "mid-write leaves a truncated file", HINT))
        # Path(...).write_text is the same truncating write in disguise
        for node in ast.walk(sf.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "write_text"):
                fname = scopes.get(id(node), "<module>")
                leaf = fname.rsplit(".", 1)[-1]
                if (sf.rel_src, leaf) in ALLOWLIST:
                    continue
                findings.append(Finding(
                    "atomic-io", sf.rel, node.lineno,
                    f"non-atomic .write_text(...) in {fname} — a crash "
                    "mid-write leaves a truncated file", HINT))
    return findings
