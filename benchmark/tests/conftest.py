"""Pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the ``gpu`` marker, and the repository root on
sys.path so the tests import ``benchmark`` and ``act3d_tpu_torch``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """Skips the test when no CUDA device is present (decided at run time)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card")
    return "cuda"
