#!/usr/bin/env python
"""Exponential curve fitting y = exp(m x + c), optionally robust.

Counterpart of ``examples/curve_fitting.py`` (reference lineage:
``examples/curve_fitting.cc`` and ``robust_curve_fitting.cc``, the
CauchyLoss variant): one batched residual array instead of 67 residual
blocks. Expected solution with the reference's data-generation parameters:
m ~ 0.29, c ~ 0.13 (true 0.3, 0.1).

    python -m examples_torch.curve_fitting [--robustify] [--device cpu]
"""

import argparse

import numpy as np
import torch

import skeres_tpu_torch as stt
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.types import LinearSolverType


def exponential_residual(params, data):
    (mc,) = params
    return data[1:2] - torch.exp(mc[0] * data[0] + mc[1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--robustify", action="store_true")
    ap.add_argument("--num_points", type=int, default=67)
    ap.add_argument("--outlier_every", type=int, default=9)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(1234)
    x = np.linspace(0.0, 5.0, args.num_points)
    y = np.exp(0.3 * x + 0.1) + rng.normal(0.0, 0.2, size=x.shape)
    if args.robustify:
        y[:: args.outlier_every] += 10.0

    problem = stt.Problem()
    mc = problem.add_parameter_block([0.0, 0.0])
    problem.add_residual_blocks(
        exponential_residual,
        stt.CauchyLoss(0.5) if args.robustify else None,
        [(mc.array, np.zeros(len(x), dtype=np.int32))],
        data=np.stack([x, y], axis=1),
        name="expfit",
    )

    options = SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_QR,
        max_num_iterations=100,
        minimizer_progress_to_stdout=True,
        device=args.device,
    )
    summary = stt.solve(options, problem)
    print(summary.brief_report())
    m, c = mc.value
    print(f"Final   m: {m:.6f} c: {c:.6f}  (true m: 0.3 c: 0.1)")
    return summary, (float(m), float(c))


if __name__ == "__main__":
    main()
