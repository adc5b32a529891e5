"""The benchmark's tests: CPU tests at small sizes, and ``cuda``-marked
tests that run the cells' checks on an NVIDIA card (skipped elsewhere; the
skip is decided in the fixture)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell runs at its own size "
                    "there")
    return "cuda"
