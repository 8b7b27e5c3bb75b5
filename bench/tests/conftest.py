"""The benchmark's CPU tests: ``python -m pytest -q bench/tests`` from the
root of a checkout (``-m cuda`` for the tests that need the card)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

torch.set_num_threads(2)
