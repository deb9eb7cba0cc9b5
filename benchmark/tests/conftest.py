"""Shared fixtures of the benchmark's tests: a tiny cell on the CPU."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the sweep cell cut to a size the CPU runs in seconds: 4 x 3 FoV, 128
# rays a cell, 64 bounces, 2 designs a request in chunks of one
TINY = {"workload": {"num_fov_x": 4, "num_fov_y": 3, "rays_per_fov": 128,
                     "slots": 128, "max_bounces": 64, "spawn_iters": 16},
        "traffic": {"designs_per_request": 2, "designs_per_batch": 1}}
SEED = 2**31 + 4099   # larger than 32 signed bits hold


@pytest.fixture
def tiny():
    return {k: dict(v) for k, v in TINY.items()}


@pytest.fixture
def seed():
    return SEED
