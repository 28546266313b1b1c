"""Shared fixtures.  NOTE: XLA_FLAGS / device-count overrides are NOT set
here — smoke tests must see the real single CPU device; multi-device tests
spawn subprocesses with their own XLA_FLAGS."""

import os
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
if SRC not in sys.path:
    sys.path.insert(0, os.path.abspath(SRC))


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running chaos/storm tests")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels); skipped without one"
    )


@pytest.fixture
def tmp_sqlite(tmp_path):
    return f"sqlite:///{tmp_path}/study.db"


@pytest.fixture
def tmp_journal(tmp_path):
    return f"journal://{tmp_path}/study.journal"
