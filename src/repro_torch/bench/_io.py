"""Shared output helper for the port's benchmark scripts (port of
``benchmarks/_io.py``)."""
from __future__ import annotations

import json
from typing import Any

from repro_torch.core.store import atomic_write_text


def write_json(path: str, doc: Any, indent: int = 1) -> None:
    """Write ``doc`` as JSON to ``path`` atomically (the store's
    write-then-rename helper), creating parent dirs: a killed bench never
    leaves a half-written file.  ``default=str`` serialises the odd
    non-JSON value (a device, a numpy scalar)."""
    atomic_write_text(path, json.dumps(doc, indent=indent, default=str))
