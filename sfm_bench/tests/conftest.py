"""Fixtures of the benchmark's own tests, which run on the CPU at tiny
sizes (`tiny.py`).

Tests that need a CUDA device carry the `card` marker and skip inside a
fixture where there is none; run them on the card with

    python3 -m pytest sfm_bench/tests -m card
"""

from __future__ import annotations

import pytest
import torch

from sfm_bench import run as harness


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def bench():
    return harness.manifest()
