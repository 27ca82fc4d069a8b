import os

# Keep the default device count at 1 for smoke tests/benches (the dry-run
# sets its own XLA_FLAGS in a fresh process — see launch/dryrun.py).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "0")

import numpy as np
import pytest


def pytest_configure(config):
    # Register the `timeout` mark so the suite runs warning-free without
    # pytest-timeout installed (the mark degrades to a no-op; with the
    # plugin installed its own registration takes over enforcement).
    config.addinivalue_line(
        "markers",
        "timeout(seconds): per-test time limit (no-op unless pytest-timeout "
        "is installed)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
