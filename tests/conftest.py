# NOTE: no XLA_FLAGS here on purpose — tests and benches see the real single
# CPU device; only launch/dryrun.py forces 512 placeholder devices.
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped without a card")
