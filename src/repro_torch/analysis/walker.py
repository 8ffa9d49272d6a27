"""Repo walker: parsed source files + inline-suppression collection
(port of ``repro/analysis/walker.py``).

Every rule consumes :class:`SourceFile` objects — the parsed AST next to
the raw lines (for comment inspection; ``ast`` drops comments) and the
per-line ``# reprolint: ignore[rule, ...]`` suppressions.  An ignore
comment applies to its own line; a comment-only line also covers the
next line, so a suppression can sit above a long statement:

    # reprolint: ignore[atomic-io] — scratch file, never read back
    with open(tmp_probe, "w") as f:
        ...
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, FrozenSet, Iterator, List, Optional, Tuple

IGNORE_RE = re.compile(r"#\s*reprolint:\s*ignore\[([\w\-*,\s]+)\]")
#: the wildcard id: suppresses every rule on the line
IGNORE_ALL = "*"


@dataclass
class SourceFile:
    """One parsed ``.py`` file under analysis."""

    path: Path                 # absolute
    rel: str                   # posix path relative to the repo root
    rel_src: str               # posix path relative to the analysis root
    text: str
    lines: List[str]
    tree: ast.Module
    #: line (1-indexed) -> rule ids suppressed there
    ignores: Dict[int, FrozenSet[str]] = field(default_factory=dict)

    def line_text(self, line: int) -> str:
        return self.lines[line - 1] if 1 <= line <= len(self.lines) else ""

    def ignored(self, line: int, rule: str) -> bool:
        ids = self.ignores.get(line, frozenset())
        return rule in ids or IGNORE_ALL in ids


def _collect_ignores(lines: List[str]) -> Dict[int, FrozenSet[str]]:
    out: Dict[int, FrozenSet[str]] = {}
    for i, raw in enumerate(lines, start=1):
        m = IGNORE_RE.search(raw)
        if not m:
            continue
        ids = frozenset(p.strip() for p in m.group(1).split(",") if p.strip())
        out[i] = out.get(i, frozenset()) | ids
        # a comment-only line shields the statement below it
        if raw.split("#", 1)[0].strip() == "":
            out[i + 1] = out.get(i + 1, frozenset()) | ids
    return out


def parse_source(path: Path, repo_root: Path,
                 src_root: Path) -> SourceFile:
    text = path.read_text()
    lines = text.splitlines()
    tree = ast.parse(text, filename=str(path))
    return SourceFile(
        path=path,
        rel=path.relative_to(repo_root).as_posix(),
        rel_src=path.relative_to(src_root).as_posix(),
        text=text,
        lines=lines,
        tree=tree,
        ignores=_collect_ignores(lines),
    )


def collect(src_root: Path, repo_root: Path) -> List[SourceFile]:
    """Parse every ``.py`` under ``src_root``, sorted by relative path.

    A file that fails to parse raises ``SyntaxError`` — the analyzer has
    nothing useful to say about a repo that does not parse, and tier-1
    would be broken anyway.
    """
    files = []
    for path in sorted(src_root.rglob("*.py")):
        files.append(parse_source(path, repo_root, src_root))
    return files


# ---------------------------------------------------------------------------
# shared AST helpers (used by several rules)
# ---------------------------------------------------------------------------


def walk_functions(tree: ast.Module) -> Iterator[Tuple[str, ast.AST]]:
    """Yield ``(qualname, node)`` for every function/method, including
    nested ones (qualname joins enclosing class/function names with dots)."""

    def visit(node: ast.AST, prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child
                yield from visit(child, q + ".")
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, f"{prefix}{child.name}.")
            else:
                yield from visit(child, prefix)

    yield from visit(tree, "")


def enclosing_function_map(tree: ast.Module) -> Dict[int, str]:
    """Map every AST node id() inside a function to that function's
    qualname (innermost wins)."""
    out: Dict[int, str] = {}
    for qual, fn in walk_functions(tree):
        for node in ast.walk(fn):
            out[id(node)] = qual
    return out


def call_name(func: ast.AST) -> Optional[str]:
    """The simple name of a called expression: ``foo`` for ``foo(...)``
    and ``obj.foo(...)`` alike; None for anything else."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a pure Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def str_const(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
