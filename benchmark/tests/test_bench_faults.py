"""A run with the timed path broken underneath comes out not correct, for
each fault a solve can have: a solve that returns its start unchanged,
half of the observations left out and the rest weighed double (the mean
over the rest), and an answer altered where it is produced. The exchange
between chips has no counterpart: every cell runs on one card."""

import math

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import TINY

CELLS = ["venice1778.dense-schur", "ladybug49.device-loop", "venice1778.iterative-schur",
         "ladybug49.host-loop"]


def _unchanged(mp):
    from skeres_tpu_torch.core.device_loop import DeviceLoopMinimizer
    from skeres_tpu_torch.core.minimizer import TrustRegionMinimizer

    for cls in (TrustRegionMinimizer, DeviceLoopMinimizer):
        mp.setattr(cls, "minimize", lambda self, state: state)


def _half_batch(mp):
    from skeres_tpu_torch.core.evaluator import Evaluator

    def weights(n, like):
        w = torch.zeros(n, dtype=like.dtype, device=like.device)
        w[::2] = math.sqrt(2.0)
        return w

    residuals, full = Evaluator._rows_residuals, Evaluator._rows_residuals_and_jacobian

    def rows_residuals(self, *a):
        cost = residuals(self, *a)
        return cost * weights(cost.shape[0], cost) ** 2

    def rows_full(self, *a):
        cost, r, jac = full(self, *a)
        w = weights(cost.shape[0], cost)
        return cost * w * w, r * w[:, None], jac * w[:, None, None]

    mp.setattr(Evaluator, "_rows_residuals", rows_residuals)
    mp.setattr(Evaluator, "_rows_residuals_and_jacobian", rows_full)


def _altered_answer(mp):
    from skeres_tpu_torch.core.problem import Program

    write_back = Program.write_back

    def altered(self, state):
        write_back(self, state)
        self.groups[0].values[0, 0] += 1e-3  # one rotation component of camera 0

    mp.setattr(Program, "write_back", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_answer],
                         ids=["unchanged", "half-batch", "altered-answer"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = harness.run_cell(cell, 77, 0.0, False, device="cpu", config_overrides=TINY,
                         log=lambda msg: None)
    assert not r["correct"], r["checks"]
