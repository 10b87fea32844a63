"""The benchmark's CPU tests: ``python -m pytest rpqbench/tests``.  Tests
marked ``gpu`` decide inside the test whether there is a card."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
