"""Finding: one rule violation at one source location (port of
``repro/analysis/findings.py``).

A finding is the unit everything downstream consumes: the CLI prints
``file:line``-anchored lines, the JSON report serialises ``as_dict()``,
the baseline matches on ``(rule, file, line)``, and inline
``# reprolint: ignore[rule]`` comments suppress by the same key.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict


@dataclass(frozen=True)
class Finding:
    """One violation: rule id + repo-relative location + message."""

    rule: str
    file: str       # posix path relative to the repo root
    line: int       # 1-indexed
    message: str
    hint: str = ""  # how to fix / how to suppress

    @property
    def location(self) -> str:
        return f"{self.file}:{self.line}"

    def sort_key(self):
        return (self.file, self.line, self.rule, self.message)

    def as_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "file": self.file, "line": self.line,
                "message": self.message, "hint": self.hint}

    def render(self) -> str:
        out = f"{self.location}: [{self.rule}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out
