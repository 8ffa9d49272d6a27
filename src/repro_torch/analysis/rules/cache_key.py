"""Rule ``key-visibility`` — cache-key completeness (port of
``repro/analysis/rules/cache_key.py``).

The evaluator contract (``docs/EVALUATOR.md``) promises *equal shape
signatures => byte-identical eval-form HLO*; the port's counterpart
is one profiled eval form per shape class, whose signature the
evaluator caches and the store replays.  That only holds if every
``PVector`` field either joins ``structural_key`` (via
``STRUCTURAL_FIELDS`` or an explicit ``self.<field>`` read) or rides as
a traced argument (``LIFTED_FIELDS``).  A field that is neither is
**silently aliasing**: two candidates differing only there share a
cache entry and the tuner steers on metrics of a program that was never
compiled.  The dynamic contract tests can only catch this for inputs
they happen to exercise; this rule catches the whole class at PR time:

* every ``PVector`` dataclass field must be key-visible
  (``STRUCTURAL_FIELDS`` ∪ ``LIFTED_FIELDS`` ∪ fields
  ``structural_key``/``lifted_row`` read off ``self``);
* every field must have a row in the ``docs/EVALUATOR.md`` P-field
  table (the checklist the doc enforces dynamically, checked statically
  here so the finding lands on the field's own ``file:line``);
* entries of ``STRUCTURAL_FIELDS``/``LIFTED_FIELDS`` that are not
  dataclass fields are stale and flagged;
* any ``p.<field>`` read inside motif execution code
  (``core/motifs/``, including the kernel lowerings) must be
  key-visible — reading an invisible field is exactly the aliasing
  read the contract forbids.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis import doc_tables
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import rule
from repro_torch.analysis.walker import SourceFile, walk_functions

#: where the P-vector contract lives, relative to the analysis root
BASE_REL = "core/motifs/base.py"
#: motif execution code whose ``p.<attr>`` reads are checked
MOTIF_SCOPE = "core/motifs/"
#: the declared field-list globals in BASE_REL
FIELD_LISTS = ("STRUCTURAL_FIELDS", "LIFTED_FIELDS")
#: PVector methods whose ``self.<attr>`` reads make a field key-visible
KEY_METHODS = ("structural_key", "lifted_row")

HINT = ("add the field to STRUCTURAL_FIELDS or LIFTED_FIELDS and to the "
        "docs/EVALUATOR.md P-field table (see the new-knob checklist "
        "there), or drop it from PVector")


def _tuple_of_strs(node: ast.AST) -> Optional[Tuple[str, ...]]:
    if isinstance(node, ast.Tuple):
        vals = []
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant)
                    and isinstance(elt.value, str)):
                return None
            vals.append(elt.value)
        return tuple(vals)
    return None


class PVectorContract:
    """The statically-derived P-vector contract of one base.py."""

    def __init__(self):
        self.fields: Dict[str, int] = {}       # field name -> lineno
        self.lists: Dict[str, Tuple[Tuple[str, ...], int]] = {}
        self.key_reads: Set[str] = set()       # self.<attr> in KEY_METHODS
        self.methods: Set[str] = set()         # defs/properties on PVector
        self.class_line: int = 0

    @property
    def visible(self) -> Set[str]:
        out = set(self.key_reads) | set(self.methods)
        for name, (vals, _) in self.lists.items():
            out |= set(vals)
        return out


def pvector_contract(sf: SourceFile) -> Optional[PVectorContract]:
    """Parse ``class PVector`` + the field-list globals out of base.py."""
    c = PVectorContract()
    cls = None
    for node in sf.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == "PVector":
            cls = node
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id in FIELD_LISTS:
                    vals = _tuple_of_strs(node.value)
                    if vals is not None:
                        c.lists[tgt.id] = (vals, node.lineno)
        elif isinstance(node, ast.AnnAssign):
            tgt = node.target
            if isinstance(tgt, ast.Name) and tgt.id in FIELD_LISTS:
                vals = _tuple_of_strs(node.value)
                if vals is not None:
                    c.lists[tgt.id] = (vals, node.lineno)
    if cls is None:
        return None
    c.class_line = cls.lineno
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                          ast.Name):
            c.fields[node.target.id] = node.lineno
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            c.methods.add(node.name)
            if node.name in KEY_METHODS:
                for sub in ast.walk(node):
                    if (isinstance(sub, ast.Attribute)
                            and isinstance(sub.value, ast.Name)
                            and sub.value.id == "self"):
                        c.key_reads.add(sub.attr)
    return c


def _p_params(fn: ast.AST) -> Set[str]:
    """Parameter names of ``fn`` that carry the P vector: named ``p`` or
    annotated ``PVector``."""
    out: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is None:
        return out
    for a in (list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)):
        ann = a.annotation
        annotated = (isinstance(ann, ast.Name) and ann.id == "PVector") or (
            isinstance(ann, ast.Attribute) and ann.attr == "PVector")
        if a.arg == "p" or annotated:
            out.add(a.arg)
    return out


@rule("key-visibility",
      "every PVector field must be cache-key-visible and documented; "
      "motif code may only read key-visible fields off p")
def run(ctx) -> List[Finding]:
    findings: List[Finding] = []
    base = ctx.get(BASE_REL)
    if base is None:
        return [Finding("key-visibility", BASE_REL, 1,
                        f"{BASE_REL} not found under the analysis root — "
                        "the P-vector contract cannot be checked", HINT)]
    contract = pvector_contract(base)
    if contract is None or not contract.fields:
        return [Finding("key-visibility", base.rel, 1,
                        "no `class PVector` dataclass found in base.py",
                        HINT)]

    # the doc side: the EVALUATOR.md P-field table
    doc = ctx.docs_dir / "EVALUATOR.md"
    try:
        roles = doc_tables.p_field_roles(doc)
    except (LookupError, OSError) as e:
        roles = None
        findings.append(Finding(
            "key-visibility", base.rel, contract.class_line,
            f"docs/EVALUATOR.md P-field table unavailable ({e})", HINT))

    visible = contract.visible
    for f, line in contract.fields.items():
        if f not in visible:
            findings.append(Finding(
                "key-visibility", base.rel, line,
                f"PVector field {f!r} is invisible to the cache key: it is "
                "in neither STRUCTURAL_FIELDS nor LIFTED_FIELDS and "
                "structural_key never reads it — candidates differing only "
                "here would silently alias one cache entry", HINT))
        if roles is not None and f not in roles:
            findings.append(Finding(
                "key-visibility", base.rel, line,
                f"PVector field {f!r} has no row in the docs/EVALUATOR.md "
                "P-field table", HINT))

    # stale declarations: list entries that are not fields
    for list_name, (vals, line) in contract.lists.items():
        for v in vals:
            if v not in contract.fields:
                findings.append(Finding(
                    "key-visibility", base.rel, line,
                    f"{list_name} names {v!r}, which is not a PVector "
                    "field — stale entry", "remove the stale entry"))

    # aliasing reads: p.<field> in motif execution code must be visible
    for sf in ctx.files:
        if not sf.rel_src.startswith(MOTIF_SCOPE):
            continue
        for qual, fn in walk_functions(sf.tree):
            pnames = _p_params(fn)
            if not pnames:
                continue
            for node in ast.walk(fn):
                if (isinstance(node, ast.Attribute)
                        and isinstance(node.value, ast.Name)
                        and node.value.id in pnames
                        and isinstance(node.ctx, ast.Load)
                        and node.attr in contract.fields
                        and node.attr not in visible):
                    findings.append(Finding(
                        "key-visibility", sf.rel, node.lineno,
                        f"{qual} reads PVector field {node.attr!r}, which "
                        "is not key-visible — the metric this code "
                        "produces would alias across candidates that "
                        "differ only in it", HINT))
    return findings
