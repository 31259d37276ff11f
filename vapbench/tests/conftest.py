"""Tests of the benchmark.  They run on the CPU at small sizes; tests
marked `chip` need the card and skip without it (decided in the `cuda`
fixture, never while a module is imported).  Run on the card with

    python3 -m pytest vapbench/tests -m chip -q
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs the CUDA card; skips without it")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card (run with -m chip on the card)")
    return "cuda"
