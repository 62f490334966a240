"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of the checkout (the repository's suite does not collect them).
Tests marked ``cuda`` need the card and skip without one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
