"""The line-search minimizer: steepest descent, nonlinear CG, L-BFGS, BFGS.

PyTorch counterpart of ``skeres_tpu/core/line_search.py`` (reference
lineage: ``internal/ceres/line_search_minimizer.cc``, ``line_search.cc``,
``line_search_direction.cc``, ``low_rank_inverse_hessian.cc``). The step
searches (``armijo_line_search``, ``wolfe_line_search``) are scalar host
logic, as there. The vectors are not: the JAX form copies every gradient
to the host in float64 and runs the directions in numpy, which at
venice-1778 shape is a 24 MB copy an evaluation. Here the gradient, the
direction and the L-BFGS memory stay on the evaluator's device in float64
(the JAX form's host dtype), and the host reads scalars only: an
evaluation's cost and directional derivative in one fetch, an iteration's
norms and curvature pair in another.

Used for ``MinimizerType.LINE_SEARCH`` problems and by the
``GradientProblem`` solver (``core/gradient_problem.py``).
"""

from __future__ import annotations

import math
import time
from collections import deque

import torch

from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.summary import IterationSummary, Summary
from skeres_tpu_torch.core.types import (
    CallbackReturnType,
    LineSearchDirectionType,
    LineSearchType,
    TerminationType,
)

__all__ = ["LineSearchMinimizer", "wolfe_line_search", "armijo_line_search"]


def _interpolate_step(lo, f_lo, g_lo, hi, f_hi, trial_frac=0.5):
    """Minimize the quadratic through (lo, f_lo, g_lo) and (hi, f_hi) on
    [lo, hi] (reference: ``polynomial.cc`` MinimizeInterpolatingPolynomial),
    bisection-safeguarded."""
    d = hi - lo
    if d == 0.0:
        return lo
    denom = 2.0 * (f_hi - f_lo - g_lo * d)
    if denom != 0.0:
        cand = lo + (-g_lo * d * d / denom)
        lo_b, hi_b = (lo, hi) if lo < hi else (hi, lo)
        span = hi_b - lo_b
        # keep strictly inside the bracket
        if lo_b + 0.05 * span <= cand <= hi_b - 0.05 * span and math.isfinite(cand):
            return cand
    return lo + trial_frac * d


def armijo_line_search(phi, f0, g0, initial_step, sufficient_decrease, max_iterations, min_step):
    """Backtracking Armijo search with polynomial interpolation.

    Returns (step, f_step, num_evals) or (None, f0, num_evals) on failure.
    """
    s = initial_step
    prev_s = None
    for k in range(max_iterations):
        f = phi(s)
        if math.isfinite(f) and f <= f0 + sufficient_decrease * g0 * s:
            return s, f, k + 1
        if prev_s is not None and math.isfinite(f):
            s_new = _interpolate_step(0.0, f0, g0, s, f)
        else:
            s_new = 0.5 * s
        prev_s = s
        s = max(min(s_new, 0.9 * s), 0.1 * s)  # Ceres-style safeguard window
        if s < min_step:
            break
    return None, f0, max_iterations


def wolfe_line_search(phi_dphi, f0, g0, initial_step, sufficient_decrease, curvature,
                      max_iterations, min_step, step_expansion=10.0):
    """Strong-Wolfe search: a bracketing phase and a zoom phase (reference:
    ``line_search.cc`` WolfeLineSearch; Nocedal & Wright alg. 3.5/3.6).
    ``step_expansion`` bounds the bracketing phase's step growth
    (``max_line_search_step_expansion``).

    phi_dphi(s) -> (phi(s), phi'(s)). Returns (step, f, num_evals) or
    (None, f0, evals).
    """
    evals = 0
    s_prev, f_prev, g_prev = 0.0, f0, g0
    s = initial_step
    max_step = 1e16

    def zoom(lo, f_lo, g_lo, hi, f_hi):
        nonlocal evals
        for _ in range(max_iterations):
            sj = _interpolate_step(lo, f_lo, g_lo, hi, f_hi)
            if abs(hi - lo) < min_step:
                return (lo, f_lo) if f_lo < f0 else (None, f0)
            fj, gj = phi_dphi(sj)
            evals += 1
            if not math.isfinite(fj) or fj > f0 + sufficient_decrease * g0 * sj or fj >= f_lo:
                hi, f_hi = sj, fj
            else:
                if abs(gj) <= -curvature * g0:
                    return sj, fj
                if gj * (hi - lo) >= 0:
                    hi, f_hi = lo, f_lo
                lo, f_lo, g_lo = sj, fj, gj
        return (lo, f_lo) if f_lo < f0 else (None, f0)

    for i in range(max_iterations):
        f, g = phi_dphi(s)
        evals += 1
        if not math.isfinite(f) or f > f0 + sufficient_decrease * g0 * s or (i > 0 and f >= f_prev):
            out = zoom(s_prev, f_prev, g_prev, s, f)
            return out[0], out[1], evals
        if abs(g) <= -curvature * g0:
            return s, f, evals
        if g >= 0:
            out = zoom(s, f, g, s_prev, f_prev)
            return out[0], out[1], evals
        s_prev, f_prev, g_prev = s, f, g
        s = min(step_expansion * s, max_step)
    return None, f0, evals


class _LowRankInverseHessian:
    """L-BFGS memory and the two-loop recursion (reference:
    ``low_rank_inverse_hessian.cc``) on device vectors. ``update`` takes the
    pair's s.y and y.y read on the host with the iteration's other scalars;
    the recursion's own dot products stay on the device."""

    def __init__(self, max_rank: int, use_scaling: bool = True):
        self.use_scaling = use_scaling
        self.s = deque(maxlen=max_rank)
        self.y = deque(maxlen=max_rank)
        self.rho = deque(maxlen=max_rank)
        self.yy = deque(maxlen=max_rank)

    def update(self, delta_x, delta_g, sy: float, yy: float):
        if sy <= 1e-14:
            return False
        self.s.append(delta_x)
        self.y.append(delta_g)
        self.rho.append(1.0 / sy)
        self.yy.append(yy)
        return True

    def apply(self, g):
        q = g.clone()
        alphas = []
        for s_i, y_i, rho_i in zip(reversed(self.s), reversed(self.y), reversed(self.rho)):
            a = rho_i * torch.dot(s_i, q)
            alphas.append(a)
            q -= a * y_i
        if self.use_scaling and self.y:
            q *= 1.0 / (self.rho[-1] * self.yy[-1])
        for s_i, y_i, rho_i, a in zip(self.s, self.y, self.rho, reversed(alphas)):
            b = rho_i * torch.dot(y_i, q)
            q += (a - b) * s_i
        return q


class _DenseInverseHessian:
    """Full-rank BFGS inverse-Hessian approximation (reference:
    ``line_search_direction.cc``, BFGS), an (n, n) device matrix: the
    inverse update H <- (I - rho s y^T) H (I - rho y s^T) + rho s s^T, with
    H0 scaled by s.y / y.y at the first update (the reference's
    ``use_approximate_eigenvalue_bfgs_scaling``). For small problems only,
    as in the JAX package."""

    def __init__(self, n: int, like: torch.Tensor, use_scaling: bool = True):
        self.h = torch.eye(n, dtype=like.dtype, device=like.device)
        self.use_scaling = use_scaling
        self.initialized = False
        # non-empty once updated: the initial-step heuristic reads it
        self.s = []

    def update(self, delta_x, delta_g, sy: float, yy: float):
        if sy <= 1e-14:
            return False
        if not self.initialized and self.use_scaling and yy > 0.0:
            self.h *= sy / yy
        self.initialized = True
        self.s.append(None)
        rho = 1.0 / sy
        hy = self.h @ delta_g
        yhy = torch.dot(delta_g, hy)
        # the sandwich update expanded into one rank-2 correction
        self.h += (rho * rho * yhy + rho) * torch.outer(delta_x, delta_x)
        self.h -= rho * (torch.outer(delta_x, hy) + torch.outer(hy, delta_x))
        return True

    def apply(self, g):
        return self.h @ g


class LineSearchMinimizer:
    """The host loop of the line-search minimizer (reference:
    ``line_search_minimizer.cc``) over an evaluator's ``blocks``,
    ``gradient_and_diag``, ``plus`` and ``x_norm`` (the NLLS evaluator, or
    ``core/gradient_problem.py``'s)."""

    def __init__(self, evaluator, options: SolverOptions, summary: Summary):
        self.ev = evaluator
        self.options = options
        self.summary = summary

    def _cost_and_grad(self, state):
        """(cost, g): g in float64, the dtype of the search's vectors."""
        cost, blocks = self.ev.blocks(state)
        return cost, self.ev.gradient_and_diag(blocks)[0].to(torch.float64)

    def minimize(self, state):
        o = self.options
        s = self.summary
        start = time.time()
        ev = self.ev

        cost_d, g = self._cost_and_grad(state)
        cost, gmax, gnorm = torch.stack([
            cost_d.to(torch.float64), g.abs().max() if g.numel() else g.new_zeros(()),
            torch.linalg.vector_norm(g)]).tolist()
        s.num_jacobian_evaluations += 1
        if not math.isfinite(cost):
            s.termination_type = TerminationType.FAILURE
            s.message = "Initial cost evaluation produced non-finite values."
            return state
        s.initial_cost = cost + s.fixed_cost

        direction_type = o.line_search_direction_type

        def make_inverse_hessian():
            scaling = o.use_approximate_eigenvalue_bfgs_scaling
            if direction_type == LineSearchDirectionType.LBFGS:
                return _LowRankInverseHessian(o.max_lbfgs_rank, use_scaling=scaling)
            if direction_type == LineSearchDirectionType.BFGS:
                return _DenseInverseHessian(g.numel(), g, use_scaling=scaling)
            return None

        lbfgs = make_inverse_hessian()
        prev_g = None
        prev_direction = None
        restarts = 0

        it = IterationSummary(
            iteration=0,
            cost=cost + s.fixed_cost,
            gradient_max_norm=gmax,
            gradient_norm=gnorm,
            iteration_time_in_seconds=time.time() - start,
            cumulative_time_in_seconds=time.time() - start,
            step_is_valid=True,
            step_is_successful=True,
        )
        s.iterations.append(it)
        if it.gradient_max_norm <= o.gradient_tolerance:
            s.termination_type = TerminationType.CONVERGENCE
            s.message = "Gradient tolerance reached."
            return state

        for iteration in range(1, o.max_num_iterations + 1):
            iter_start = time.time()
            if time.time() - start > o.max_solver_time_in_seconds:
                s.termination_type = TerminationType.NO_CONVERGENCE
                s.message = "Maximum solver time reached."
                return state

            # -- direction ----------------------------------------------------
            if direction_type == LineSearchDirectionType.STEEPEST_DESCENT:
                direction = -g
            elif direction_type == LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT:
                if prev_g is None:
                    direction = -g
                else:
                    # Polak-Ribiere+ (the reference's default)
                    num, den = torch.stack([torch.dot(g, g - prev_g),
                                            torch.dot(prev_g, prev_g)]).tolist()
                    beta = max(0.0, num / max(den, 1e-300))
                    direction = -g + beta * prev_direction
            else:  # LBFGS (two-loop) or BFGS (dense inverse Hessian)
                direction = -lbfgs.apply(g)

            dg = float(torch.dot(direction, g))
            if not math.isfinite(dg) or dg >= 0.0:
                # not a descent direction: restart from steepest descent
                restarts += 1
                if restarts > o.max_num_line_search_direction_restarts:
                    s.termination_type = TerminationType.FAILURE
                    s.message = ("Line search direction failure: exceeded "
                                 "max_num_line_search_direction_restarts.")
                    return state
                if lbfgs is not None:
                    lbfgs = make_inverse_hessian()
                prev_g = None
                direction = -g
                dg = float(torch.dot(direction, g))

            # the trial states are the state's dtype, as the JAX form's
            direction_dev = direction.to(ev.dtype)

            # initial step: 1 for an updated quasi-Newton model, else scaled
            # by the gradient
            if lbfgs is not None and lbfgs.s:
                initial_step = 1.0
            else:
                initial_step = min(1.0, 1.0 / max(gmax, 1e-12))

            # -- line search --------------------------------------------------
            cached = {}

            def trial(step):
                new_state = ev.plus(state, direction_dev * step)
                c, gnew = self._cost_and_grad(new_state)
                cached[step] = (new_state, gnew)
                return c, gnew

            def phi_dphi(step):
                c, gnew = trial(step)
                return tuple(torch.stack([c.to(torch.float64),
                                          torch.dot(gnew, direction)]).tolist())

            def phi(step):
                return float(trial(step)[0])

            if o.line_search_type == LineSearchType.WOLFE:
                step, new_cost, evals = wolfe_line_search(
                    phi_dphi, cost, dg, initial_step,
                    o.line_search_sufficient_function_decrease,
                    o.line_search_sufficient_curvature_decrease,
                    o.max_num_line_search_step_size_iterations,
                    o.min_line_search_step_size,
                    o.max_line_search_step_expansion,
                )
            else:
                step, new_cost, evals = armijo_line_search(
                    phi, cost, dg, initial_step,
                    o.line_search_sufficient_function_decrease,
                    o.max_num_line_search_step_size_iterations,
                    o.min_line_search_step_size,
                )
            s.num_residual_evaluations += evals
            s.num_jacobian_evaluations += evals

            if step is None:
                s.termination_type = TerminationType.NO_CONVERGENCE
                s.message = f"Line search failed to find a valid step at iteration {iteration}."
                return state

            new_state, new_g = cached[step]
            cached.clear()
            step_vec = step * direction
            dgrad = new_g - g

            cost_change = cost - new_cost
            accepted = new_cost < cost
            if accepted:
                state = new_state
            # the iteration's scalars in one fetch
            new_gmax, new_gnorm, step_norm, sy, yy, x_norm = torch.stack([
                new_g.abs().max(), torch.linalg.vector_norm(new_g),
                torch.linalg.vector_norm(step_vec), torch.dot(step_vec, dgrad),
                torch.dot(dgrad, dgrad), ev.x_norm(state).to(torch.float64)]).tolist()
            if lbfgs is not None:
                lbfgs.update(step_vec, dgrad, sy, yy)
            prev_g, prev_direction = g, direction

            it = IterationSummary(
                iteration=iteration,
                cost=new_cost + s.fixed_cost,
                cost_change=cost_change,
                gradient_max_norm=new_gmax,
                gradient_norm=new_gnorm,
                step_norm=step_norm,
                step_is_valid=True,
                step_is_successful=accepted,
                line_search_function_evaluations=evals,
                iteration_time_in_seconds=time.time() - iter_start,
                cumulative_time_in_seconds=time.time() - start,
            )
            s.iterations.append(it)
            if accepted:
                s.num_successful_steps += 1
            else:
                s.num_unsuccessful_steps += 1

            for cb in o.callbacks:
                ret = cb(it)
                if ret == CallbackReturnType.SOLVER_ABORT:
                    s.termination_type = TerminationType.USER_FAILURE
                    s.message = "User callback returned SOLVER_ABORT."
                    return state
                if ret == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                    s.termination_type = TerminationType.USER_SUCCESS
                    s.message = "User callback terminated the solver."
                    return state

            # -- convergence --------------------------------------------------
            if it.gradient_max_norm <= o.gradient_tolerance:
                s.termination_type = TerminationType.CONVERGENCE
                s.message = "Gradient tolerance reached."
                return state
            if abs(cost_change) <= o.function_tolerance * abs(cost):
                s.termination_type = TerminationType.CONVERGENCE
                s.message = "Function tolerance reached."
                return state
            if step_norm <= o.parameter_tolerance * (x_norm + o.parameter_tolerance):
                s.termination_type = TerminationType.CONVERGENCE
                s.message = "Parameter tolerance reached."
                return state
            cost, g, gmax, gnorm = new_cost, new_g, new_gmax, new_gnorm

        s.termination_type = TerminationType.NO_CONVERGENCE
        s.message = "Maximum number of iterations reached."
        return state
