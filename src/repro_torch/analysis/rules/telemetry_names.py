"""Rule ``telemetry-names`` — emitted names must be in the contract
(port of ``repro/analysis/rules/telemetry_names.py``).

``docs/OBSERVABILITY.md`` is the canonical statement of every span
kind, instant-event kind and registered metric name; downstream
consumers (``repro_torch.bench.trace_summary`` gates, dashboards, the
snapshot-supersets-stats checks) key on those exact strings.  An
undocumented name emitted from ``src/`` is invisible to all of them —
a span that no trace gate requires, a counter no summary aggregates.

The dynamic half of this contract already exists
(``tests/test_torch_telemetry.py`` checks ``SPAN_ATTRS``/``EVENT_ATTRS``
against the doc tables); this rule closes the static half: every
**string literal** passed to ``.span(`` / ``.add_span(`` / ``.event(``
/ ``.counter(`` / ``.gauge(`` / ``.histogram(`` anywhere under ``src/``
must appear in the matching contract table.  Dynamic names (variables)
are out of static reach and stay the dynamic tests' job.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from repro_torch.analysis import doc_tables
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import rule
from repro_torch.analysis.walker import str_const

#: emitter method name -> (contract-table key, table heading for the hint)
EMITTERS: Dict[str, Tuple[str, str]] = {
    "span": ("span", "span-kind"),
    "add_span": ("span", "span-kind"),
    "event": ("event", "instant-event"),
    "counter": ("metric", "metric-name"),
    "gauge": ("metric", "metric-name"),
    "histogram": ("metric", "metric-name"),
}

HINT = ("add the name to the matching docs/OBSERVABILITY.md contract "
        "table (and, for spans/events, to telemetry.SPAN_ATTRS/"
        "EVENT_ATTRS — tests/test_torch_telemetry.py keeps them in "
        "sync), or emit an existing documented name")


@rule("telemetry-names",
      "every literal span/event/metric name emitted under src/ must be "
      "in the docs/OBSERVABILITY.md contract tables")
def run(ctx) -> List[Finding]:
    doc = ctx.docs_dir / "OBSERVABILITY.md"
    try:
        names = doc_tables.observability_names(doc)
    except (LookupError, OSError) as e:
        return [Finding("telemetry-names", "docs/OBSERVABILITY.md", 1,
                        f"telemetry contract tables unavailable ({e})",
                        HINT)]
    findings: List[Finding] = []
    for sf in ctx.files:
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in EMITTERS):
                continue
            lit = str_const(node.args[0] if node.args else None)
            if lit is None:
                continue  # dynamic names are the dynamic tests' job
            table_key, table_name = EMITTERS[node.func.attr]
            if lit not in names[table_key]:
                findings.append(Finding(
                    "telemetry-names", sf.rel, node.lineno,
                    f".{node.func.attr}({lit!r}) emits a name missing "
                    f"from the docs/OBSERVABILITY.md {table_name} table "
                    "— no trace gate or summary will ever see it", HINT))
    return findings
