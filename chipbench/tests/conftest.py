"""The benchmark's tests run on the CPU from the root of a checkout:
``python -m pytest chipbench/tests``. Tests marked ``cuda`` need the card
and skip elsewhere."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
