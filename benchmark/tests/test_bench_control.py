"""The control: the program with its float32 path switched on, held to
the float64 reference with each cell's limits, fails at least one of the
cell's numbers, while the program in float64 passes them all. On the card
the same readings at each cell's own size set the limits (PERF.md);
here at a tiny size on the CPU."""

import pytest

from benchmark import control
from benchmark.harness import load_cell
from benchmark.tests.conftest import TINY


@pytest.mark.parametrize("cell", ["venice1778.dense-schur", "ladybug49.device-loop",
                                  "venice1778.iterative-schur", "ladybug49.host-loop"])
@pytest.mark.parametrize("seed", [2, 3_000_000_019])
def test_control_fails_a_limit(cell, seed):
    r = control.readings(cell, seed, "cpu", config_overrides=TINY)
    checks = load_cell(cell)["checks"]
    assert all(r["program"][k] <= v for k, v in checks.items()), r
    assert any(r["control_fails"].values()), r
