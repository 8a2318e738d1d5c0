"""The benchmark's own tests: ``python -m pytest -q bench/tests`` (CPU);
the card's with ``-m gpu`` on the chip. The repository's test run collects
``tests/`` only."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda():
    """Skips a card test where there is no card (decided when it runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return "cuda"
