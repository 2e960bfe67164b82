"""General unconstrained minimization: the GradientProblem API.

PyTorch counterpart of ``skeres_tpu/core/gradient_problem.py`` (reference
lineage: ``include/ceres/gradient_problem.h``, ``gradient_problem_solver.h``,
``internal/ceres/gradient_problem_solver.cc``): minimize a smooth scalar
function f(x), not a sum of squares, with the line-search minimizer. f is
written in torch ops for one (n,) tensor and its gradient is
``torch.func.grad_and_value``; an optional manifold makes the search run
in the tangent space. The solve runs on ``SolverOptions.device`` (the card
unless the caller asks for the CPU) in ``SolverOptions.dtype``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from skeres_tpu_torch.core.line_search import LineSearchMinimizer
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.summary import Summary
from skeres_tpu_torch.core.types import MinimizerType
from skeres_tpu_torch.models.manifolds import EuclideanManifold, Manifold

__all__ = ["GradientProblem", "GradientProblemSolver", "solve_gradient_problem"]


class GradientProblem:
    """f: (n,) -> scalar, with an optional manifold on x."""

    def __init__(self, f: Callable, size: int, manifold: Optional[Manifold] = None):
        self.f = f
        self.size = int(size)
        self.manifold = manifold or EuclideanManifold(size)
        if self.manifold.ambient_size != self.size:
            raise ValueError("manifold ambient size != problem size")


class _GradientEvaluator:
    """The evaluator the line-search minimizer reads, over a
    GradientProblem: the tangent-space gradient is d f(plus(x, delta)) /
    d delta at 0, as the NLLS evaluator defines its Jacobians."""

    def __init__(self, problem: GradientProblem, device, dtype):
        self.p = problem
        self.device = device
        self.dtype = dtype
        self.num_tangent = problem.manifold.tangent_size

    def blocks(self, state):
        (x,) = state
        m = self.p.manifold
        zero = torch.zeros(self.num_tangent, dtype=self.dtype, device=self.device)
        g, cost = torch.func.grad_and_value(lambda d: self.p.f(m.plus(x, d)))(zero)
        return cost, g

    def gradient_and_diag(self, g):
        return g, torch.ones_like(g)

    def cost(self, state):
        (x,) = state
        return self.p.f(x)

    def plus(self, state, step):
        (x,) = state
        return (self.p.manifold.plus(x, step.to(x.dtype)),)

    def x_norm(self, state):
        (x,) = state
        return torch.sqrt(torch.sum(x.to(self.dtype) ** 2))


def solve_gradient_problem(options: SolverOptions, problem: GradientProblem, x0) -> tuple:
    """Returns (x_solution (np.ndarray, float64), Summary)."""
    device = torch.device(options.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"SolverOptions.device is {options.device!r} but no CUDA device is "
            "available; pass device='cpu' to solve on the CPU"
        )
    summary = Summary()
    summary.minimizer_type = MinimizerType.LINE_SEARCH
    start = time.time()

    ev = _GradientEvaluator(problem, device, options.dtype)
    minimizer = LineSearchMinimizer(ev, options, summary)
    state = (torch.tensor(np.asarray(x0, dtype=np.float64), dtype=options.dtype, device=device),)

    t0 = time.time()
    state = minimizer.minimize(state)
    summary.minimizer_time_in_seconds = time.time() - t0

    if summary.iterations:
        summary.final_cost = min(it.cost for it in summary.iterations)
    summary.total_time_in_seconds = time.time() - start
    return state[0].detach().to("cpu", torch.float64).numpy(), summary


class GradientProblemSolver:
    """Class-style entry point mirroring ``ceres::GradientProblemSolver``."""

    @staticmethod
    def solve(options: SolverOptions, problem: GradientProblem, x0):
        return solve_gradient_problem(options, problem, x0)
