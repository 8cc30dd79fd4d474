"""pytest settings of the benchmark's own tests (portbench/tests/): the
marker of the tests that need a CUDA card, which skip elsewhere."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (an H100); skips without one")
