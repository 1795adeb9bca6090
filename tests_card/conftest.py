"""Tests of the port that need a CUDA card; they skip without one. Run on
the card from the checkout's root:

    python -m pytest tests_card -q

(The port's CPU tests are in tests/, whose conftest imports JAX, which the
card's machine does not have.) Whether a card is present is decided inside
the `card` fixture, never at import."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the test runs on the card")
    return torch.device("cuda")
