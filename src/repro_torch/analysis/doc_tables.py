"""Markdown contract-table parsing, shared by reprolint and the tests
(port of ``repro/analysis/doc_tables.py``; the port reads the same
``docs/`` tables).

The repo keeps its behavioural contracts in markdown tables
(``docs/EVALUATOR.md`` P-field roles, ``docs/OBSERVABILITY.md`` span /
event / metric names, ``docs/TUNER.md`` rule tables, ``docs/ANALYSIS.md``
lint rules).  ``tests/test_contract.py`` parses them to pin docs to
code *dynamically*; the reprolint rules parse the same tables to pin
code to docs *statically*.  One parser serves both so the two
enforcement layers can never disagree about what a table says.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Tuple

#: a contract-table row whose first cell is a backticked name, second
#: cell free text: "| `name` | anything | ... |"
ROW_RE = re.compile(r"^\|\s*`([\w.\-*]+)`\s*\|\s*([^|]*)")
#: the EVALUATOR.md P-field row: "| `field` | role | ... |"
P_ROW_RE = re.compile(r"^\|\s*`(\w+)`\s*\|\s*([\w-]+)\s*\|")

#: canonical headings, one place
P_TABLE_HEADING = "## The structural-vs-lifted P-field table"
SPAN_TABLE_HEADING = "## The span-kind table"
RUN_SPAN_TABLE_HEADING = "## The port's run-span table"
#: the port's own observability document, beside the reference's
PORT_OBS_DOC = "PORT_OBSERVABILITY.md"
EVENT_TABLE_HEADING = "## The instant-event table"
METRIC_NAME_HEADING = "## The metric-name table"
RULE_TABLE_HEADING = "## The rule table"


def doc_section(doc: Path, heading: str) -> str:
    """The text between ``heading`` and the next ``## `` heading.

    Raises ``LookupError`` when the heading is absent — a missing
    contract table is itself a contract violation.
    """
    text = Path(doc).read_text()
    if heading not in text:
        raise LookupError(f"{heading!r} heading missing from {doc}")
    body = text.split(heading, 1)[1]
    return body.split("\n## ", 1)[0]


def table_rows(section: str) -> List[Tuple[str, str]]:
    """``(first-cell name, second-cell text)`` for every table row whose
    first cell is a single backticked name."""
    rows = []
    for line in section.splitlines():
        m = ROW_RE.match(line.strip())
        if m:
            rows.append((m.group(1), m.group(2).strip()))
    return rows


def table_names(doc: Path, heading: str) -> Tuple[str, ...]:
    return tuple(name for name, _ in table_rows(doc_section(doc, heading)))


# -- docs/EVALUATOR.md -------------------------------------------------------


def p_field_roles(doc: Path) -> Dict[str, str]:
    """P-field name -> role (structural / lifted / repeats) from the
    EVALUATOR.md structural-vs-lifted table."""
    roles: Dict[str, str] = {}
    for line in doc_section(doc, P_TABLE_HEADING).splitlines():
        m = P_ROW_RE.match(line.strip())
        if m:
            roles[m.group(1)] = m.group(2)
    return roles


# -- docs/OBSERVABILITY.md ---------------------------------------------------

#: header-cell names that are not data rows in the observability tables
_OBS_HEADER_CELLS = frozenset({"span", "event", "metric", "name"})


def observability_names(doc: Path) -> Dict[str, Tuple[str, ...]]:
    """The telemetry-name contract: documented span kinds, instant-event
    kinds and registered metric names.  The metric-name table may be
    empty (no fixed metric names registered from ``src/`` yet) but the
    heading must exist — the table is where a new name gets declared.
    The port's run spans (:data:`RUN_SPAN_TABLE_HEADING` of
    :data:`PORT_OBS_DOC` beside ``doc``) are span names too, after the
    span kinds; a tree without that document has none."""
    out: Dict[str, Tuple[str, ...]] = {}
    for key, heading in (("span", SPAN_TABLE_HEADING),
                         ("event", EVENT_TABLE_HEADING),
                         ("metric", METRIC_NAME_HEADING)):
        names = tuple(n for n in table_names(doc, heading)
                      if n not in _OBS_HEADER_CELLS)
        out[key] = names
    port = doc.with_name(PORT_OBS_DOC)
    if port.is_file():
        out["span"] += tuple(n for n in table_names(port,
                                                    RUN_SPAN_TABLE_HEADING)
                             if n not in _OBS_HEADER_CELLS)
    return out


# -- docs/ANALYSIS.md --------------------------------------------------------


def analysis_rule_rows(doc: Path) -> List[Tuple[str, str]]:
    """``(rule id, rest-of-row)`` for every row of the ANALYSIS.md rule
    table, in document order."""
    section = doc_section(doc, RULE_TABLE_HEADING)
    rows = []
    for line in section.splitlines():
        line = line.strip()
        m = ROW_RE.match(line)
        if m and m.group(1) != "rule":
            rows.append((m.group(1), line))
    return rows
