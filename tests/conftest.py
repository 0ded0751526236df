import os
import sys

# Tests run on the single real CPU device (the dry-run's 512 fake devices are
# only set inside repro.launch.dryrun subprocesses, never here).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # benchmarks/

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (exhaustive crash-torture sweeps)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: exhaustive sweep outside the tier-1 time budget "
        "(run with --runslow; CI covers a bounded subset)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device and skips without one "
        "(python -m pytest -m cuda on a machine with the card)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="slow sweep: needs --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
