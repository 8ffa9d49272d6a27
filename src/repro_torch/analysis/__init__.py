"""repro_torch.analysis — "reprolint" for the port (port of
``repro/analysis``).

The port keeps the reference's contracts: cache-key completeness
(``docs/EVALUATOR.md``), purity of the code a profiled run, a CUDA-graph
capture, ``torch.func.vmap`` or a kernel op runs, atomic result/store IO
(``docs/SERVING.md``), typed failure paths (``docs/TUNER.md`` stress
gates) and telemetry-name discipline (``docs/OBSERVABILITY.md``).  This
package enforces them *statically*, over every file under
``src/repro_torch``, with the reference's five rules:

    python -m repro_torch.analysis.cli --check --out results/reprolint_torch.json

``docs/ANALYSIS.md`` is the canonical rule table; only ``trace-purity``'s
roots differ from the reference's (:mod:`repro_torch.analysis.rules.purity`).
Suppression is per-line (``# reprolint: ignore[rule-id]``) or via the
checked-in, strictly shrinking baseline
(``src/repro_torch/analysis/baseline.json``).  Nothing here imports
``jax`` or ``repro``.
"""
from repro_torch.analysis.engine import (  # noqa: F401
    AnalysisContext,
    Report,
    analyze,
    build_context,
    run_rules,
)
from repro_torch.analysis.findings import Finding  # noqa: F401
from repro_torch.analysis.rules import RULES, rule_ids  # noqa: F401
