"""The benchmark's own tests: ``python -m pytest -q servebench/tests``
(the repository's own test run collects ``tests/`` only). Tests that need
the card carry the ``card`` marker and skip without one (decided inside a
fixture); run them there with ``python -m pytest -q -m card
servebench/tests``."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
