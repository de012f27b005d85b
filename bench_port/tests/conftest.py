"""The benchmark's own tests, on the CPU at tiny sizes:

    python -m pytest bench_port/tests -q

Tests marked `card` need a CUDA device and skip without one."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
