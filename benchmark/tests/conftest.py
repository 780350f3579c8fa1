"""Run from the root of a checkout: ``python -m pytest benchmark/tests``.

Tests marked ``card`` need a CUDA card and skip without one; whether there
is one is decided in the ``cuda`` fixture, never when a module is
imported."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    return "cuda"
