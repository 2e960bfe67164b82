#!/usr/bin/env python
"""Rosenbrock minimization with the GradientProblem solver.

Counterpart of ``examples/rosenbrock.py`` (reference lineage:
``examples/rosenbrock.cc``): the general unconstrained-minimization facade
(a cost with its gradient, no residual structure), solved with the
line-search minimizer; the gradient comes from torch autodiff.

    python -m examples_torch.rosenbrock [--x -1.2] [--y 1.0] [--device cpu]
"""

import argparse

import numpy as np

from skeres_tpu_torch.core.gradient_problem import GradientProblem, solve_gradient_problem
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.types import MinimizerType


def rosenbrock(p):
    x, y = p[0], p[1]
    return (1.0 - x) ** 2 + 100.0 * (y - x * x) ** 2


def main(x0=-1.2, y0=1.0, device="cuda"):
    problem = GradientProblem(rosenbrock, size=2)
    options = SolverOptions(
        minimizer_type=MinimizerType.LINE_SEARCH,
        max_num_iterations=200,
        device=device,
    )
    params = np.array([x0, y0])
    solution, summary = solve_gradient_problem(options, problem, params)
    print(summary.full_report())
    print(f"initial: x={x0} y={y0}")
    print(f"final:   x={solution[0]:.6f} y={solution[1]:.6f} "
          f"f={summary.final_cost:.3e}")
    return summary, solution


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--x", type=float, default=-1.2)
    ap.add_argument("--y", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.x, args.y, args.device)
