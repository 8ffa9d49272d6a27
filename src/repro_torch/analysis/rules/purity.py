"""Rule ``trace-purity`` — no host-side nondeterminism in captured code
(port of ``repro/analysis/rules/purity.py``).

The whole Eq.-3 accuracy story assumes a candidate's metrics are a pure
function of its P vector.  The reference roots this rule at its
``jax.jit``/``pjit``/``vmap`` entry points; the port has no ``jit``, and
runs a function as one unit of work in two places instead:

* **the profiled dispatch run** (ROADMAP rule 5: "compile" in eager
  PyTorch is one profiled run).  The evaluator caches its signature and
  the store replays it across processes, so a clock or ``os.environ``
  read in it is a value that differs per process, and a host RNG draw
  makes two profiles of one candidate differ;
* **the captured CUDA graph** (ROADMAP rule 6: a function timed as a
  CUDA graph reads nothing back to the host).  A host read in it is
  frozen into the capture at its first value, and ``.item()`` cannot
  be captured at all, so the wall silently falls back to eager.

So the roots are the port's counterparts of a trace entry:

* the **first** argument of calls to ``vmap`` (``torch.func.vmap``,
  ``torch.vmap``), ``CapturedGraph``, ``graph_wall_time``, ``timed_wall``
  (``core/signature.py``'s capture and its timers), ``profile_call`` and
  ``signature_of_call`` (the profiled run);
* the **second** argument of ``define_op`` and ``define_vmap``
  (``kernels/_build.py``): an op's implementation and its batching rule,
  which replaced the reference's ``@jax.jit`` kernel wrappers.

A root argument resolves as follows:

* a ``Name`` or ``Attribute`` roots that name;
* a ``Call`` roots its callee (the reference's factory rule:
  ``timed_wall(chunk.runner(seed))`` runs ``runner``'s nested defs);
* a ``Lambda`` roots every name its body references
  (``timed_wall(lambda: fn(*args))``);
* a name bound from a call in the function that holds the root call, as
  in ``fn = pb.build_eval_fn(dev); profile_call(fn, ...)``, also roots
  that call's callee (a lambda's names resolve the same way).

A function that hands one of its own parameters straight to an entry is
an entry too, at that parameter: ``PopulationEntry.__init__`` vmaps its
``fn``, so ``PopulationEntry(m.build_lifted_fn(dev))`` roots
``build_lifted_fn`` (a constructor is called by its class's name, and a
method's ``self`` takes no position).

The rest is the reference's: a name-level call graph over ``core/`` and
``kernels/``, reached breadth first from the roots (any referenced name
that matches a known function marks it reachable — a false edge can only
add a finding, never hide one), and the same banned sites inside
reachable functions: ``time.*`` clock reads, stdlib ``random.*`` /
``np.random.*`` calls, ``os.environ`` reads, ``.item()`` calls, and
``for``-loops over set literals / ``set()``.

Draws threaded through a ``torch.Generator`` are the *sanctioned* RNG, as
``jax.random`` is in the reference: they are not in the catalogue and
never flag.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import rule
from repro_torch.analysis.walker import SourceFile, call_name, walk_functions

#: analysis-root subtrees whose functions participate in the call graph
SCOPES = ("core/", "kernels/")
#: entry name -> position of the argument it runs as a unit of work
ROOT_ARGS: Dict[str, int] = {
    **dict.fromkeys(("vmap", "CapturedGraph", "graph_wall_time",
                     "timed_wall", "profile_call", "signature_of_call"), 0),
    **dict.fromkeys(("define_op", "define_vmap"), 1),
}
#: banned host-clock attributes of the ``time`` module
CLOCK_ATTRS = frozenset({"time", "monotonic", "perf_counter", "time_ns",
                         "monotonic_ns", "process_time"})
#: module roots whose ``random`` submodule is banned (stdlib random is
#: banned as a bare name)
NP_ROOTS = frozenset({"np", "numpy"})

HINT = ("code run as a profiled run, a CUDA graph, under vmap or as a "
        "kernel op must be a pure function of its inputs: thread a "
        "torch.Generator for randomness, hoist host reads (clocks, "
        "os.environ) to the caller, keep results on device (no .item()), "
        "and iterate sorted()/tuples instead of sets")

FuncEntry = Tuple[SourceFile, ast.AST, str]


class _ScopeFile:
    """One file under :data:`SCOPES`, walked once: its functions'
    qualnames, every call with the function that holds it (the module for
    top-level code), and each function's names bound from a call."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.functions = list(walk_functions(sf.tree))
        self.quals = {id(fn): qual for qual, fn in self.functions}
        self.calls: List[Tuple[ast.Call, ast.AST]] = []
        #: id(function) -> {local name: callees of the calls bound to it}
        self.bindings: Dict[int, Dict[str, Set[str]]] = {}
        self._visit(sf.tree, sf.tree)

    def _visit(self, node: ast.AST, owner: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            inner = child if id(child) in self.quals else owner
            if isinstance(child, ast.Call):
                self.calls.append((child, inner))
            elif isinstance(child, (ast.Assign, ast.AnnAssign)):
                self._bind(child, inner)
            self._visit(child, inner)

    def _bind(self, node: ast.AST, owner: ast.AST) -> None:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target])
        if not isinstance(node.value, ast.Call):
            return
        callee = call_name(node.value.func)
        if callee is None:
            return
        names = self.bindings.setdefault(id(owner), {})
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                names.setdefault(tgt.id, set()).add(callee)


def _root_arg(call: ast.Call, entries: Dict[str, int]) -> Optional[ast.AST]:
    """The argument an entry call runs, or None for any other call."""
    pos = entries.get(call_name(call.func))
    if pos is None or len(call.args) <= pos:
        return None
    return call.args[pos]


def _root_names_from_call(call: ast.Call, bound: Dict[str, Set[str]],
                          entries: Dict[str, int]) -> Set[str]:
    """Function names rooted by one entry call; ``bound`` maps the local
    names of the function holding the call to their factories' names."""
    arg = _root_arg(call, entries)
    if arg is None:
        return set()
    if isinstance(arg, ast.Call):
        callee = call_name(arg.func)
        return {callee} if callee else set()
    if isinstance(arg, ast.Lambda):
        names = _referenced_names(arg.body)
    else:
        name = call_name(arg)
        names = {name} if name else set()
    out = set(names)
    for name in names:
        out |= bound.get(name, set())
    return out


def _referenced_names(fn: ast.AST) -> Set[str]:
    """Every simple name a function body could call or close over."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            out.add(node.id)
        elif isinstance(node, ast.Attribute):
            out.add(node.attr)
    return out


def _wrappers(files: List[_ScopeFile], entries: Dict[str, int]
              ) -> Dict[str, int]:
    """Functions that pass one of their parameters straight to an entry,
    by the name they are called with, with that parameter's position
    (``self``/``cls`` dropped)."""
    out: Dict[str, int] = {}
    for f in files:
        for call, fn in f.calls:
            arg = _root_arg(call, entries)
            if not (isinstance(arg, ast.Name) and id(fn) in f.quals):
                continue
            qual = f.quals[id(fn)]
            params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
            skip = int("." in qual and params[:1] in (["self"], ["cls"]))
            if arg.id in params[skip:]:
                called_as = (qual.rsplit(".", 2)[-2]
                             if fn.name == "__init__" and "." in qual
                             else fn.name)
                out.setdefault(called_as, params.index(arg.id) - skip)
    return out


def reachable(files: List[SourceFile]) -> List[FuncEntry]:
    """``(file, function node, qualname)`` of every function under
    :data:`SCOPES` that a root reaches."""
    scope = [_ScopeFile(sf) for sf in files
             if sf.rel_src.startswith(SCOPES)]
    # name -> [(sf, fn node, qualname)]
    index: Dict[str, List[FuncEntry]] = {}
    for f in scope:
        for qual, fn in f.functions:
            index.setdefault(fn.name, []).append((f.sf, fn, qual))

    # entries, grown by the functions that wrap one until none is new
    entries = dict(ROOT_ARGS)
    while True:
        new = {k: v for k, v in _wrappers(scope, entries).items()
               if k not in entries}
        if not new:
            break
        entries.update(new)

    roots: Set[str] = set()
    for f in scope:
        for call, fn in f.calls:
            roots |= _root_names_from_call(
                call, f.bindings.get(id(fn), {}), entries)

    # BFS over referenced names; nested defs of a reachable function are
    # reachable through the name reference their closure makes
    reached: Set[int] = set()
    work = [e for name in sorted(roots) for e in index.get(name, ())]
    out: List[FuncEntry] = []
    while work:
        sf, fn, qual = work.pop()
        if id(fn) in reached:
            continue
        reached.add(id(fn))
        out.append((sf, fn, qual))
        for name in _referenced_names(fn):
            for e in index.get(name, ()):
                if id(e[1]) not in reached:
                    work.append(e)
    return out


def _banned_sites(fn: ast.AST, fname: str,
                  sf: SourceFile) -> List[Tuple[int, str]]:
    """(line, message) for every nondeterminism site inside ``fn``; the
    messages are the reference's."""
    out: List[Tuple[int, str]] = []
    where = f"in {fname!r} ({sf.rel_src}), reachable from a jax trace entry"
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                    and f.value.id == "time" and f.attr in CLOCK_ATTRS):
                out.append((node.lineno,
                            f"host clock read time.{f.attr}() {where}"))
            elif (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "random"):
                out.append((node.lineno,
                            f"stdlib random.{f.attr}() {where} — host RNG "
                            "diverges across retraces"))
            elif (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Attribute)
                    and isinstance(f.value.value, ast.Name)
                    and f.value.value.id in NP_ROOTS
                    and f.value.attr == "random"):
                out.append((node.lineno,
                            f"np.random.{f.attr}() {where} — host RNG "
                            "diverges across retraces"))
            elif (isinstance(f, ast.Attribute) and f.attr == "item"
                    and not node.args and not node.keywords):
                out.append((node.lineno,
                            f".item() {where} — forces a host sync and "
                            "freezes a traced value"))
        elif (isinstance(node, ast.Attribute) and node.attr == "environ"
                and isinstance(node.value, ast.Name)
                and node.value.id == "os"
                and isinstance(node.ctx, ast.Load)):
            out.append((node.lineno, f"os.environ read {where} — traces "
                        "bake the first process's environment in"))
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            it = node.iter
            is_set = isinstance(it, ast.Set) or (
                isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id in ("set", "frozenset"))
            if is_set:
                out.append((node.lineno,
                            f"iteration over a set {where} — hash order "
                            "feeds whatever this loop constructs"))
    return out


@rule("trace-purity",
      "no host nondeterminism (clocks, host RNG, os.environ, .item(), "
      "set iteration) in code reachable from vmap, a CUDA-graph capture, "
      "a profiled run or a kernel op's definition")
def run(ctx) -> List[Finding]:
    findings: List[Finding] = []
    # one finding per site: a nested def's body is walked again through
    # its parent, so dedupe on location alone
    seen: Set[Tuple[str, int]] = set()
    for sf, fn, qual in reachable(ctx.files):
        for line, msg in _banned_sites(fn, qual, sf):
            key = (sf.rel, line)
            if key not in seen:
                seen.add(key)
                findings.append(Finding("trace-purity", sf.rel, line, msg,
                                        HINT))
    return findings
