"""The benchmark's own tests, run on the CPU with the program's plain
kernel versions (``python -m pytest benchmark/tests -q``); the cases marked
``gpu`` need a CUDA card and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a few lines of a BAL scene: small enough for a CPU run of every cell
TINY = {"num_cameras": 8, "num_points": 120, "num_observations": 400,
        "track_lengths": {"4": 40, "3": 80}}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skips without one)")
