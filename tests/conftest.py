import os
import sys

# Tests run single-device (the dry-run sets its own 512-device flag in a
# dedicated subprocess; see test_multidevice.py).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _clear_registry():
    from repro.core.smartconf import GLOBAL_REGISTRY
    yield
    GLOBAL_REGISTRY.clear()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (and nvcc to build the "
        "kernels); skipped where torch.cuda.is_available() is false")
