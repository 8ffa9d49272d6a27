"""The reprolint rule registry (port of ``repro/analysis/rules``).

A rule is a callable ``fn(ctx) -> List[Finding]`` registered under a
stable id with the :func:`rule` decorator.  Registration order is the
canonical order: ``docs/ANALYSIS.md``'s rule table lists rules in the
same order (sync-enforced by ``tests/test_contract.py`` for the
reference and ``tests/test_torch_analysis.py`` for the port), and the
CLI runs and reports them in it.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, List, Tuple

from repro_torch.analysis.findings import Finding


@dataclass(frozen=True)
class Rule:
    id: str
    summary: str
    fn: Callable


RULES: "OrderedDict[str, Rule]" = OrderedDict()


def rule(rule_id: str, summary: str):
    """Decorator: register ``fn(ctx) -> List[Finding]`` under ``rule_id``."""

    def deco(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = Rule(rule_id, summary, fn)
        return fn

    return deco


def rule_ids() -> Tuple[str, ...]:
    return tuple(RULES)


def run_rule(rule_id: str, ctx) -> List[Finding]:
    return RULES[rule_id].fn(ctx)


# importing the rule modules registers them — order here IS the
# canonical rule order of docs/ANALYSIS.md
from repro_torch.analysis.rules import cache_key       # noqa: E402,F401
from repro_torch.analysis.rules import purity          # noqa: E402,F401
from repro_torch.analysis.rules import atomic_io       # noqa: E402,F401
from repro_torch.analysis.rules import excepts         # noqa: E402,F401
from repro_torch.analysis.rules import telemetry_names  # noqa: E402,F401
