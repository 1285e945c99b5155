"""Tests of the benchmark harness. They import nothing of JAX: the card's
tests (marker ``cuda``) run on the machine with the card, the rest on the
CPU at small sizes. Run from the root of the checkout:

    python -m pytest cellbench/tests -q            # on the CPU
    python -m pytest cellbench/tests -q -m cuda    # on the card
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The card, decided when a test asks for it; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda", 0)
