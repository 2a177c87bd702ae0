"""The benchmark's own CPU tests (`python -m pytest portbench/tests`); tests
that need a CUDA card carry the `cuda` marker and skip themselves without
one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skipped without one")
