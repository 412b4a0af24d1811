"""The harness's tests run on the CPU at tiny sizes: ``python -m pytest bench/tests``.
Tests that need the card are marked ``gpu`` and skip inside the test without one."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
