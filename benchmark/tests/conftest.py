"""The benchmark's tests: ``python -m pytest benchmark/tests -q`` from the
checkout's root (the CPU ones; ``-m gpu`` the card's).  Nothing here
imports JAX."""
import os
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one)")
