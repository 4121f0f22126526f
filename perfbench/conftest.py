"""pytest settings of the benchmark's own tests (``perfbench/tests``).

``chip``: a test that needs a CUDA card; it decides inside its fixture
whether there is one and skips without."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card (skips without one)")
