"""The benchmark's own tests, run from the repository's root with
``python -m pytest portbench``: the program under test is ``src/``."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
