"""Trust-region minimizer: the outer Levenberg-Marquardt / dogleg loop.

PyTorch counterpart of the host loop of ``skeres_tpu/core/minimizer.py``
(reference lineage: ``internal/ceres/trust_region_minimizer.cc``,
``levenberg_marquardt_strategy.cc``, ``dogleg_strategy.cc``,
``trust_region_step_evaluator.cc``). Each iteration runs ``solve_step``
(the damped solve of the chosen linear solver, or a dogleg step, and the
candidate) and ``try_step`` (residual-only evaluation); ``linearize`` (the
full Jacobian pass, and for dogleg the Gauss-Newton point, solved once a
linearization and kept across rejected steps) runs only after accepted
steps, and returns what the device loop (``core/device_loop.py``) copies
into its carry. The device computes, and only scalars cross to the host:
one fetch per linearization and per step, plus the jitter ladder's
finiteness read.

The D clamping, the radius update, the non-monotonic step window and the
convergence tests are the reference's formulas, so iteration counts match
the JAX package step for step. The hooks sit where the JAX minimizer has
them: the evaluation callback before each evaluation, the iteration
callbacks and ``update_state_every_iteration`` after iteration 0 and each
valid step, a checkpoint after each accepted one, the trust-region dumps
after each damped solve, and a resumed solve's radius and iteration count
(``initial_radius_override``, ``initial_iteration``). The linear solvers
branch as in the JAX minimizer (``_solver_data``, ``_solve_damped``,
``_scale_data``, ``_jtj_dx``): the Schur solvers scale and prepare their
data once per linearization, the others scale at solve time.

Bounds: the candidate is projected onto the box and the model sees the
effective (projected) step; a step the projection clipped takes the
projected Armijo line search (its loop a :func:`while_loop`, its branch a
:func:`cond`); the gradient tolerance reads the projected gradient. Inner
iterations (``core/inner_iterations.py``) refine the candidate before its
cost is taken, as the reference orders them.
"""

from __future__ import annotations

import inspect
import logging
import math
import os
import time
from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from skeres_tpu_torch.core.evaluator import BatchBlocks, Evaluator
from skeres_tpu_torch.core.graph import cond, while_loop
from skeres_tpu_torch.core.linear_solvers import (
    cho_solve,
    cholesky_nan,
    solve_cgnr,
    solve_dense_normal_cholesky,
    solve_dense_qr,
)
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.schur import SchurSolver
from skeres_tpu_torch.core.summary import IterationSummary, Summary
from skeres_tpu_torch.core.types import (
    CallbackReturnType,
    DoglegType,
    DumpFormatType,
    LinearSolverType,
    LoggingType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
)
from skeres_tpu_torch.utils.checkpoint import save_checkpoint

__all__ = ["TrustRegionMinimizer", "TrustRegionStepEvaluator", "synchronize"]


def synchronize(device: torch.device) -> None:
    """Wait for the device, so that a host clock read next covers its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TrustRegionStepEvaluator:
    """Step-quality evaluation with the non-monotonic acceptance window
    (reference: ``internal/ceres/trust_region_step_evaluator.cc``)."""

    def __init__(self, initial_cost: float, max_consecutive_nonmonotonic_steps: int):
        self.max_consecutive_nonmonotonic_steps = max_consecutive_nonmonotonic_steps
        self.minimum_cost = initial_cost
        self.current_cost = initial_cost
        self.reference_cost = initial_cost
        self.candidate_cost = initial_cost
        self.accumulated_reference_model_cost_change = 0.0
        self.accumulated_candidate_model_cost_change = 0.0
        self.num_consecutive_nonmonotonic_steps = 0

    def step_quality(self, cost: float, model_cost_change: float) -> float:
        relative_decrease = (self.current_cost - cost) / model_cost_change
        historical_relative_decrease = (self.reference_cost - cost) / (
            self.accumulated_reference_model_cost_change + model_cost_change
        )
        return max(relative_decrease, historical_relative_decrease)

    def step_accepted(self, cost: float, model_cost_change: float) -> None:
        self.current_cost = cost
        self.accumulated_candidate_model_cost_change += model_cost_change
        self.accumulated_reference_model_cost_change += model_cost_change

        if self.current_cost < self.minimum_cost:
            self.minimum_cost = self.current_cost
            self.num_consecutive_nonmonotonic_steps = 0
            self.candidate_cost = self.current_cost
            self.accumulated_candidate_model_cost_change = 0.0
        else:
            self.num_consecutive_nonmonotonic_steps += 1
            if self.current_cost > self.candidate_cost:
                self.candidate_cost = self.current_cost
                self.accumulated_candidate_model_cost_change = 0.0

        if (
            self.num_consecutive_nonmonotonic_steps
            == self.max_consecutive_nonmonotonic_steps
        ):
            self.reference_cost = self.candidate_cost
            self.accumulated_reference_model_cost_change = (
                self.accumulated_candidate_model_cost_change
            )


_SCHUR_TYPES = (LinearSolverType.DENSE_SCHUR, LinearSolverType.ITERATIVE_SCHUR)


class TrustRegionMinimizer:
    """Trust-region host loop over the evaluator and the linear solver
    ``solver_type`` (with ``schur_solver`` for the two Schur types, and
    ``inner_refiner`` for inner iterations)."""

    def __init__(
        self,
        evaluator: Evaluator,
        options: SolverOptions,
        summary: Summary,
        solver_type: LinearSolverType,
        schur_solver: Optional[SchurSolver] = None,
        inner_refiner=None,
    ):
        self.ev = evaluator
        self.options = options
        self.summary = summary
        self.solver_type = solver_type
        self.schur_solver = schur_solver
        self.inner_refiner = inner_refiner
        self.dogleg = options.trust_region_strategy_type == TrustRegionStrategyType.DOGLEG
        # dogleg's counts on the device (Summary.dogleg_gauss_newton_iterations,
        # num_dogleg_cauchy_steps), read once when the loop ends
        self._gn_iters = []
        self._cauchy = []
        if (solver_type in _SCHUR_TYPES) != (schur_solver is not None):
            raise ValueError(f"{solver_type.value} with schur_solver={schur_solver!r}")
        # set by solve() when resuming from a checkpoint
        self.initial_radius_override = None
        self.initial_iteration = 0
        self._cb_arity_cache = {}  # id(callback) -> takes the state too
        self._dense_qr = solve_dense_qr  # DENSE_QR's step (the device loop's differs)
        self._subset_masks = self._build_subset_masks()

    def _build_subset_masks(self):
        """Per-batch row masks of the SUBSET preconditioner (reference:
        ``subset_preconditioner.cc`` over
        ``residual_blocks_for_subset_preconditioner``), planned on the
        host. None when the preconditioner is not chosen or has to
        downgrade (too many parameters for the dense factor, or no tagged
        row resolves): CGNR then takes JACOBI, which is logged and written
        to ``Summary.preconditioner_type_used``."""
        o = self.options
        if (
            o.preconditioner_type != PreconditionerType.SUBSET
            or self.solver_type != LinearSolverType.CGNR
            or not o.residual_blocks_for_subset_preconditioner
        ):
            return None
        log = logging.getLogger("skeres_tpu_torch")
        if self.ev.num_tangent > o.subset_preconditioner_max_parameters:
            log.warning(
                "SUBSET preconditioner downgraded to JACOBI: %d effective parameters "
                "exceed subset_preconditioner_max_parameters=%d (the dense subset "
                "factor would not fit)",
                self.ev.num_tangent, o.subset_preconditioner_max_parameters,
            )
            self.summary.preconditioner_type_used = PreconditionerType.JACOBI
            return None
        wanted = {getattr(rb, "_rid", rb) for rb in o.residual_blocks_for_subset_preconditioner}
        masks, any_hit = [], False
        for batch, (lo, hi) in zip(self.ev.program.batches, self.ev.row_range):
            m = torch.zeros(batch.num_blocks, dtype=self.ev.dtype)
            if batch.row_ids is not None:
                m = torch.tensor([1.0 if rid in wanted else 0.0 for rid in batch.row_ids],
                                 dtype=self.ev.dtype)
                any_hit = any_hit or bool(m.any())
            masks.append(m[lo:hi].to(self.ev.device))  # the rows the evaluator holds
        if not any_hit:
            log.warning("SUBSET preconditioner downgraded to JACOBI: none of the tagged "
                        "residual blocks resolve to solver rows")
            self.summary.preconditioner_type_used = PreconditionerType.JACOBI
            return None
        return masks

    # -- the linear solvers (skeres_tpu/core/minimizer.py:254-412, :861-877) -----

    def _solver_data(self, blocks):
        """What the damped solve needs, once per linearization."""
        st = self.solver_type
        if st == LinearSolverType.DENSE_NORMAL_CHOLESKY:
            return (self.ev.jtj_dense(blocks),)
        if st == LinearSolverType.DENSE_QR:
            return self.ev.jacobian_dense(blocks)
        if st == LinearSolverType.CGNR:
            # the corrected blocks stay resident; the product reads them
            return tuple((b.r, b.jac, b.idx) for b in blocks)
        if st in _SCHUR_TYPES:
            return self.schur_solver.solver_data(blocks)
        raise NotImplementedError(st)

    def _scale_data(self, data, scale):
        """Column scaling of the solver data, J -> J S."""
        st = self.solver_type
        if st == LinearSolverType.DENSE_NORMAL_CHOLESKY:
            (jtj,) = data
            return (jtj * scale[None, :] * scale[:, None],)
        if st == LinearSolverType.DENSE_QR:
            j_dense, r_dense = data
            return (j_dense * scale[None, :], r_dense)
        if st == LinearSolverType.CGNR:
            return tuple(
                (r, jac * self.ev.v_rows(bi, scale)[:, None, :], idx)
                for bi, (r, jac, idx) in enumerate(data)
            )
        if st in _SCHUR_TYPES:
            return self.schur_solver.scale_data(data, scale)
        raise NotImplementedError(st)

    def _prep_data(self, blocks, scale):
        """The Schur solvers scale and prepare once per linearization, and
        every re-solve after a rejected step reuses it; the others keep
        their data unscaled and scale at solve time (cheap for them)."""
        data = self._solver_data(blocks)
        if self.schur_solver is not None:
            return self.schur_solver.prepare(self._scale_data(data, scale))
        return data

    def _solve_damped(self, data, g, diag, radius, jitter):
        """Solve (J^T J + clamp(diag) / radius) y = -g in the scaled space
        (``data`` scaled already). Returns (y, iterations, jitter_used);
        ``jitter`` is the Schur factor's ratchet, which the other solvers
        pass through."""
        o = self.options
        st = self.solver_type
        mu = 1.0 / radius
        if st in _SCHUR_TYPES:
            return self.schur_solver.solve_damped(
                data, g, diag, mu, o.min_lm_diagonal, o.max_lm_diagonal, jitter)
        if st == LinearSolverType.DENSE_NORMAL_CHOLESKY:
            (jtj,) = data
            y, it = solve_dense_normal_cholesky(
                jtj, g, diag, mu, o.min_lm_diagonal, o.max_lm_diagonal,
                refinement_iterations=(o.max_num_refinement_iterations
                                       if o.use_mixed_precision_solves else 0),
            )
            return y, it, jitter
        if st == LinearSolverType.DENSE_QR:
            j_dense, r_dense = data
            y, it = self._dense_qr(j_dense, r_dense, diag, mu, o.min_lm_diagonal,
                                   o.max_lm_diagonal)
            return y, it, jitter
        if st == LinearSolverType.CGNR:
            blocks = [BatchBlocks(*b) for b in data]
            make_precond = None
            if self._subset_masks is not None:
                # SUBSET (reference: subset_preconditioner.cc):
                # M = J_sub^T J_sub + D over the tagged rows, factored densely
                # once a damped solve; each PCG step is two triangular solves
                def make_precond(d):
                    masked = [BatchBlocks(r * m[:, None], jac * m[:, None, None], idx)
                              for (r, jac, idx), m in zip(data, self._subset_masks)]
                    l_sub = cholesky_nan(self.ev.jtj_dense(masked) + torch.diag(d))
                    return lambda v: cho_solve(l_sub, v)

            y, it = solve_cgnr(
                lambda v: self.ev.jtj_matvec(blocks, v), g, diag, mu, o.min_lm_diagonal,
                o.max_lm_diagonal, o.max_linear_solver_iterations, o.eta,
                o.min_linear_solver_iterations, make_precond,
            )
            return y, it, jitter
        raise NotImplementedError(st)

    def _jtj_dx(self, data, dx):
        """(J^T J) dx from unscaled solver data."""
        st = self.solver_type
        if st == LinearSolverType.DENSE_NORMAL_CHOLESKY:
            (jtj,) = data
            return jtj @ dx
        if st == LinearSolverType.DENSE_QR:
            j_dense, _ = data
            return j_dense.T @ (j_dense @ dx)
        if st == LinearSolverType.CGNR:
            return self.ev.jtj_matvec([BatchBlocks(*b) for b in data], dx)
        if st in _SCHUR_TYPES:
            return self.schur_solver.jtj_matvec(data, dx)
        raise NotImplementedError(st)

    def _model_quadratic(self, data, dx, scale):
        """dx^T (J^T J) dx, all of J^T J that the model cost needs. The
        Schur solvers' prepared data is scaled: ||J_s (dx / scale)||^2 in one
        pass over the rows."""
        if self.schur_solver is not None:
            return self.schur_solver.jtj_quadratic(data, dx / scale)
        return torch.dot(dx, self._jtj_dx(data, dx))

    def _jtj_scaled(self, data, u, scale):
        """(J S)^T (J S) u in the scaled space."""
        if self.schur_solver is not None:
            return self.schur_solver.jtj_matvec(data, u)
        return scale * self._jtj_dx(data, scale * u)

    # -- the three per-iteration programs ----------------------------------------

    def gradient_max_norm(self, state, g):
        """max|g|, or where the problem is bounded the projected gradient's
        max|x - P(x - g)| (reference: trust_region_minimizer.cc): the raw
        |g| never vanishes at an active bound."""
        ev = self.ev
        if ev.program.has_bounds:
            g = ev.tangent_diff(ev.project_bounds(ev.plus(state, -g)), state)
        return torch.max(torch.abs(g))

    def linearize(self, state, scale_prev=None):
        """Full evaluation at ``state``: (cost, g, diag, prepared solver
        data, scale, max|g|, ||g||), and for dogleg the Gauss-Newton point
        in the scaled space after them. The Jacobi column scaling
        ``1 / (1 + sqrt(diag))`` is computed fresh unless ``scale_prev``
        pins it (refresh_jacobi_scaling=False)."""
        ev = self.ev
        cost, blocks = ev.blocks(state)
        g, diag = ev.gradient_and_diag(blocks)
        if not self.options.jacobi_scaling:
            scale = torch.ones_like(diag)
        elif scale_prev is None:
            scale = 1.0 / (1.0 + torch.sqrt(torch.clamp(diag, min=0.0)))
        else:
            scale = scale_prev
        data = self._prep_data(blocks, scale)
        out = (cost, g, diag, data, scale, self.gradient_max_norm(state, g),
               torch.sqrt(torch.sum(g * g)))
        if not self.dogleg:
            return out
        # the Gauss-Newton point: one (nearly) undamped solve a
        # linearization, reused across every radius change (reference:
        # dogleg_strategy.cc ComputeGaussNewtonStep); the JAX package's
        # _solve_scaled(..., jitter=None) starts the ladder at 0
        scaled = data if self.schur_solver is not None else self._scale_data(data, scale)
        y_gn, iters, _ = self._solve_damped(scaled, g * scale, diag * scale * scale, 1e32,
                                            torch.zeros((), dtype=g.dtype, device=g.device))
        self._gn_iters.append(iters)
        return out + (y_gn,)

    def solve_step(self, state, data, g, diag, scale, radius, jitter, y_gn=None, cost=None,
                   line_search=True):
        """The step in the scaled space J_s = J S and the candidate: the
        damped solve, or with dogleg the dogleg step from ``y_gn``.
        ``radius`` is a float or a device scalar, ``jitter`` a device
        scalar; ``cost`` (the current cost) feeds the projected line search
        of a bounded problem, which ``line_search=False`` leaves out (the
        device loop, as the JAX package's, only projects). Returns
        (new_state, model_cost_change, step_norm, linear solver
        iterations, jitter_used, dx), all on the device."""
        ev = self.ev
        gs = g * scale
        if self.dogleg:
            step = (self._subspace_dogleg_step if self.options.dogleg_type
                    == DoglegType.SUBSPACE_DOGLEG else self._dogleg_step)
            y, lin_iters, cauchy = step(data, scale, gs, y_gn, radius)
            self._cauchy.append(cauchy)
            jitter_used = jitter
        else:
            scaled = data if self.schur_solver is not None else self._scale_data(data, scale)
            y, lin_iters, jitter_used = self._solve_damped(
                scaled, gs, diag * scale * scale, radius, jitter)
        dx = y * scale
        new_state = ev.plus(state, dx)
        if ev.program.has_bounds:
            # reference bounds semantics: the candidate is the projection
            # onto the box, and the model sees the effective step
            projected = ev.project_bounds(new_state)
            if line_search and self.options.max_num_line_search_step_size_iterations > 0:
                new_state = self._projected_line_search(state, data, g, scale, dx, projected,
                                                        cost)
            else:
                new_state = projected
            dx = ev.tangent_diff(new_state, state)
            y = dx / scale
        dx_jtj_dx = self._model_quadratic(data, dx, scale)
        model_cost_change = -(torch.dot(g, dx) + 0.5 * dx_jtj_dx)
        step_norm = torch.sqrt(torch.sum(y * y))  # scaled-space norm
        if self.inner_refiner is not None:
            # reference order: inner iterations refine the candidate before
            # its cost decides the step
            new_state = self.inner_refiner.refine(new_state)
        return new_state, model_cost_change, step_norm, lin_iters, jitter_used, dx

    def _projected_line_search(self, state, data, g, scale, dx, projected, cost):
        """The projected Armijo line search on a step the projection clipped
        (``skeres_tpu/core/minimizer.py:525-611``). Its direction is the TR
        step, or where the projected step would ascend along the active
        face, the projected Cauchy direction ``-t_c g``; it takes the first
        alpha in 1, 1/2, ... (at most max_num_line_search_step_size_iterations
        + 1 tries) with f(P(x + alpha d)) <= f(x) + c1 g.(P(x + alpha d) - x),
        and where none holds, the plain projected step (the trust region
        then rejects and shrinks). Returns the candidate."""
        ev, o = self.ev, self.options
        dtype, device = g.dtype, g.device
        eff0 = ev.tangent_diff(projected, state)
        g2 = torch.sum(g * g)
        t_c = g2 / torch.clamp(self._model_quadratic(data, g, scale), min=torch.finfo(dtype).tiny)
        d_vec = torch.where(torch.dot(g, eff0) < 0.0, dx, -t_c * g)
        c1 = o.line_search_sufficient_function_decrease
        max_k = int(o.max_num_line_search_step_size_iterations)
        alpha = torch.ones((), dtype=dtype, device=device)
        k = torch.zeros((), dtype=torch.int64, device=device)
        ok = torch.zeros((), dtype=torch.bool, device=device)

        def body():
            cand = ev.project_bounds(ev.plus(state, alpha * d_vec))
            accept = ev.cost(cand) <= cost + c1 * torch.dot(g, ev.tangent_diff(cand, state))
            alpha.copy_(torch.where(accept, alpha, alpha * 0.5))
            k.add_(1)
            ok.copy_(accept)

        clipped = torch.any(torch.abs(eff0 - dx) > 0.0)
        cond(clipped, lambda: while_loop(lambda: (~ok) & (k <= max_k), body))
        step = torch.where(clipped & ok, alpha * d_vec, dx)
        return ev.project_bounds(ev.plus(state, step))

    def _dogleg_step(self, data, scale, gs, y_gn, radius):
        """Traditional dogleg in the Jacobi-scaled space (reference:
        ``dogleg_strategy.cc`` ComputeTraditionalDoglegStep): the Cauchy
        point, the Gauss-Newton point, or their segment's crossing of the
        trust-region boundary; vector operations only. Returns (y, 1, took
        the Cauchy point)."""
        g2 = torch.dot(gs, gs)
        g_b_g = torch.dot(gs, self._jtj_scaled(data, gs, scale))
        alpha = g2 / torch.where(g_b_g > 0.0, g_b_g, torch.ones_like(g_b_g))
        pc = -alpha * gs  # the Cauchy point
        pc_norm = torch.sqrt(torch.sum(pc * pc))
        gn_norm = torch.sqrt(torch.sum(y_gn * y_gn))
        gn_ok = torch.isfinite(gn_norm)

        # the segment pc -> gn: ||pc + beta d|| = radius
        d = torch.where(gn_ok, y_gn, pc) - pc
        dd = torch.dot(d, d)
        pd = torch.dot(pc, d)
        disc = torch.clamp(pd * pd + dd * (radius * radius - pc_norm * pc_norm), min=0.0)
        beta = (-pd + torch.sqrt(disc)) / torch.where(dd > 0.0, dd, torch.ones_like(dd))
        interp = pc + torch.clamp(beta, 0.0, 1.0) * d

        g_norm = torch.sqrt(g2)
        cauchy_capped = -(radius / torch.where(g_norm > 0.0, g_norm, torch.ones_like(g_norm))) * gs
        take_gn = gn_ok & (gn_norm <= radius)
        y = torch.where(take_gn, y_gn, torch.where(pc_norm >= radius, cauchy_capped, interp))
        cauchy = ~take_gn & ((pc_norm >= radius) | ~gn_ok)
        return y, torch.ones((), dtype=torch.int64, device=gs.device), cauchy

    def _subspace_dogleg_step(self, data, scale, gs, y_gn, radius):
        """2-D subspace dogleg (reference: ``dogleg_strategy.cc``
        ComputeSubspaceDoglegStep): the quadratic model minimized exactly
        on the trust-region disk within span{gradient, Gauss-Newton point}.
        As in the JAX package, the boundary is parametrized by angle and
        minimized by a 256-point grid and Newton polish from the best point
        and from the best one more than pi/2 away (m(t) has at most two
        local minima on the circle), in place of the reference's quartic.
        A degenerate subspace takes the traditional step. Returns (y, 1,
        took the Cauchy point)."""
        dtype, device = gs.dtype, gs.device
        one = torch.ones((), dtype=dtype, device=device)
        g_norm = torch.sqrt(torch.dot(gs, gs))
        b1 = gs / torch.where(g_norm > 0.0, g_norm, one)
        v = y_gn - torch.dot(y_gn, b1) * b1
        v_norm = torch.sqrt(torch.dot(v, v))
        gn_ok = torch.isfinite(torch.dot(y_gn, y_gn))
        ok = gn_ok & (v_norm > 1e-12 * torch.clamp(g_norm, min=1.0))
        b2 = v / torch.where(v_norm > 0.0, v_norm, one)

        bb1 = self._jtj_scaled(data, b1, scale)
        bb2 = self._jtj_scaled(data, b2, scale)
        b00, b01 = torch.dot(b1, bb1), torch.dot(b1, bb2)
        b10, b11 = torch.dot(b2, bb1), torch.dot(b2, bb2)
        g0, g1 = torch.dot(gs, b1), torch.dot(gs, b2)

        # the interior minimizer of the 2x2 model, if positive definite and
        # inside the disk
        det = b00 * b11 - b01 * b10
        inv_det = 1.0 / torch.where(det != 0.0, det, one)
        x_int = torch.stack([-(b11 * g0 - b01 * g1) * inv_det, -(-b10 * g0 + b00 * g1) * inv_det])
        interior_ok = (b00 > 0.0) & (det > 0.0) & (torch.dot(x_int, x_int) <= radius * radius)

        def model(t):  # the model on the boundary x = radius (cos t, sin t)
            x0, x1 = radius * torch.cos(t), radius * torch.sin(t)
            return 0.5 * (b00 * x0 * x0 + 2.0 * b01 * x0 * x1 + b11 * x1 * x1) + g0 * x0 + g1 * x1

        t = torch.arange(256, dtype=dtype, device=device) * (2.0 * math.pi / 256)
        vals = model(t)
        t0 = t[torch.argmin(vals)]
        t1 = t[torch.argmin(torch.where(torch.cos(t - t0) < 0.0, vals, torch.inf))]
        dm = torch.func.grad(model)
        d2m = torch.func.grad(dm)

        def newton(tt):
            for _ in range(4):
                h = d2m(tt)
                tt = tt - dm(tt) / torch.where(torch.abs(h) > 1e-30, h, one)
            return tt

        # Newton may walk to a maximum: the best of all four
        cands = torch.stack([newton(t0), newton(t1), t0, t1])
        t_star = cands[torch.argmin(model(cands))]
        x_bnd = radius * torch.stack([torch.cos(t_star), torch.sin(t_star)])
        x_sub = torch.where(interior_ok, x_int, x_bnd)
        y_sub = x_sub[0] * b1 + x_sub[1] * b2

        y_trad, iters, cauchy = self._dogleg_step(data, scale, gs, y_gn, radius)
        return torch.where(ok, y_sub, y_trad), iters, ~ok & cauchy

    def try_step(self, new_state):
        """Residual-only evaluation of the candidate: (cost, |x|)."""
        return self.ev.cost(new_state), self.ev.x_norm(new_state)

    # -- the outer loop ------------------------------------------------------------

    def minimize(self, state):
        """Run the trust-region loop; returns the best iterate seen, and sets
        ``Summary.final_cost`` to its cost (reference semantics)."""
        self._best_cost = float("inf")
        self._best_state = None
        self._current_cost = float("inf")
        out = self._minimize_loop(state)
        s = self.summary
        if self._gn_iters:  # one read of dogleg's counts
            gn = torch.stack(self._gn_iters).tolist()
            cauchy = torch.stack(self._cauchy).tolist() if self._cauchy else []
            s.dogleg_gauss_newton_iterations = [int(v) for v in gn]
            s.num_dogleg_cauchy_steps = int(sum(cauchy))
            self._gn_iters, self._cauchy = [], []
        if self._best_state is not None and self._best_cost < self._current_cost:
            out = self._best_state
            s.final_cost = self._best_cost
        elif self._current_cost < float("inf"):
            s.final_cost = self._current_cost
        return out

    def _track_iterate(self, state, cost: float):
        self._current_cost = cost
        if cost < self._best_cost:
            self._best_cost = cost
            self._best_state = state

    def _minimize_loop(self, state):
        o = self.options
        s = self.summary
        device = self.ev.device
        tiny = float(torch.finfo(self.ev.dtype).tiny)
        start = time.time()

        radius = float(
            self.initial_radius_override
            if self.initial_radius_override is not None
            else o.initial_trust_region_radius
        )
        decrease_factor = 2.0
        num_consecutive_invalid_steps = 0
        # factor-jitter ratchet of the Schur solver, kept on the device
        jitter = torch.zeros((), dtype=self.ev.dtype, device=device)

        t0 = time.time()
        self._prepare_for_evaluation(True, True)
        cost_d, g, diag, data, scale, g_max_d, g_norm_d, *gn = self.linearize(state)
        cost, g_max_norm, g_norm = torch.stack([cost_d, g_max_d, g_norm_d]).tolist()
        s.jacobian_evaluation_time_in_seconds += time.time() - t0
        s.num_jacobian_evaluations += 1
        if not math.isfinite(cost):
            s.termination_type = TerminationType.FAILURE
            s.message = "Initial cost evaluation produced non-finite values."
            return state
        s.initial_cost = cost
        self._track_iterate(state, cost)

        step_evaluator = TrustRegionStepEvaluator(
            cost,
            o.max_consecutive_nonmonotonic_steps if o.use_nonmonotonic_steps else 0,
        )
        it = IterationSummary(
            iteration=0,
            cost=cost,
            gradient_max_norm=g_max_norm,
            gradient_norm=g_norm,
            trust_region_radius=radius,
            step_is_valid=True,
            step_is_successful=True,
            iteration_time_in_seconds=time.time() - start,
            cumulative_time_in_seconds=time.time() - start,
        )
        s.iterations.append(it)
        self._log_iteration(it)
        if not o.run_full_iteration_budget and g_max_norm <= o.gradient_tolerance:
            s.termination_type = TerminationType.CONVERGENCE
            s.message = (
                f"Gradient tolerance reached. Gradient max norm: {g_max_norm:e}"
                f" <= {o.gradient_tolerance:e}"
            )
            return state
        if self._run_callbacks(it, state):
            return state

        iteration = 0
        while True:
            if iteration >= o.max_num_iterations:
                s.termination_type = TerminationType.NO_CONVERGENCE
                s.message = "Maximum number of iterations reached."
                return state
            if time.time() - start > o.max_solver_time_in_seconds:
                s.termination_type = TerminationType.NO_CONVERGENCE
                s.message = "Maximum solver time reached."
                return state
            iteration += 1
            iter_start = time.time()

            t0 = time.time()
            new_state, mcc_d, step_norm_d, lin_iters, jitter, dx = self.solve_step(
                state, data, g, diag, scale, radius, jitter, *gn, cost=cost
            )
            if o.detailed_step_timings:
                synchronize(device)
            step_solver_time = time.time() - t0
            s.linear_solver_time_in_seconds += step_solver_time
            s.num_linear_solves += 1
            self._maybe_dump(iteration, state, data, g, diag, radius, dx)

            t0 = time.time()
            self._prepare_for_evaluation(False, True)
            new_cost_d, x_norm_d = self.try_step(new_state)
            new_cost, model_cost_change, step_norm, x_norm, lin_iters = torch.stack(
                [new_cost_d, mcc_d, step_norm_d, x_norm_d, lin_iters.to(new_cost_d.dtype)]
            ).tolist()
            s.residual_evaluation_time_in_seconds += time.time() - t0
            s.num_residual_evaluations += 1

            step_is_valid = (
                math.isfinite(new_cost)
                and math.isfinite(model_cost_change)
                and math.isfinite(step_norm)
                and model_cost_change > 0.0
            )
            it = IterationSummary(
                iteration=iteration,
                cost=new_cost,
                step_norm=step_norm,
                trust_region_radius=radius,
                linear_solver_iterations=int(lin_iters),
                step_solver_time_in_seconds=step_solver_time,
                step_is_valid=step_is_valid,
            )

            if not step_is_valid:
                num_consecutive_invalid_steps += 1
                if (
                    not o.run_full_iteration_budget
                    and num_consecutive_invalid_steps >= o.max_num_consecutive_invalid_steps
                ):
                    s.termination_type = TerminationType.FAILURE
                    s.message = (
                        "Number of consecutive invalid steps more than "
                        f"{o.max_num_consecutive_invalid_steps}"
                    )
                    return state
                # reference semantics: an unsuccessful step, shrink the region
                radius = max(radius / decrease_factor, o.min_trust_region_radius)
                decrease_factor *= 2.0
                it.cost = step_evaluator.current_cost
                it.step_is_successful = False
                s.num_unsuccessful_steps += 1
                it.iteration_time_in_seconds = time.time() - iter_start
                it.cumulative_time_in_seconds = time.time() - start
                s.iterations.append(it)
                self._log_iteration(it)
                if o.run_full_iteration_budget:
                    radius = max(radius, tiny)
                elif radius <= o.min_trust_region_radius:
                    s.termination_type = TerminationType.CONVERGENCE
                    s.message = "Minimum trust region radius reached."
                    return state
                continue

            num_consecutive_invalid_steps = 0
            current_cost = step_evaluator.current_cost
            relative_decrease = step_evaluator.step_quality(new_cost, model_cost_change)
            it.relative_decrease = relative_decrease
            it.cost_change = current_cost - new_cost
            step_is_successful = relative_decrease > o.min_relative_decrease

            if step_is_successful:
                # radius /= max(1/3, 1 - (2q - 1)^3); decrease_factor = 2
                q = relative_decrease
                radius = radius / max(1.0 / 3.0, 1.0 - (2.0 * q - 1.0) ** 3)
                radius = min(radius, o.max_trust_region_radius)
                decrease_factor = 2.0
                step_evaluator.step_accepted(new_cost, model_cost_change)
                state = new_state
                s.num_successful_steps += 1

                t0 = time.time()
                self._prepare_for_evaluation(True, False)
                pinned = o.jacobi_scaling and not o.refresh_jacobi_scaling
                cost_d, g, diag, data, scale, g_max_d, g_norm_d, *gn = self.linearize(
                    state, scale if pinned else None
                )
                cost, gmax, gnorm = torch.stack([cost_d, g_max_d, g_norm_d]).tolist()
                s.jacobian_evaluation_time_in_seconds += time.time() - t0
                s.num_jacobian_evaluations += 1
                self._track_iterate(state, cost)
                it.gradient_max_norm = gmax
                it.gradient_norm = gnorm
                it.step_is_successful = True
            else:
                radius = radius / decrease_factor
                decrease_factor *= 2.0
                it.step_is_successful = False
                s.num_unsuccessful_steps += 1

            it.iteration_time_in_seconds = time.time() - iter_start
            it.cumulative_time_in_seconds = time.time() - start
            s.iterations.append(it)
            self._log_iteration(it)
            if step_is_successful:
                self._maybe_checkpoint(state, radius, self.initial_iteration + iteration, cost)
            if self._run_callbacks(it, state):
                return state

            # -- convergence tests (reference order and formulas) ------------
            if o.run_full_iteration_budget:
                # fixed budget: keep mu = 1/radius finite after convergence
                radius = max(radius, tiny)
                continue
            if step_is_successful:
                if it.gradient_max_norm <= o.gradient_tolerance:
                    s.termination_type = TerminationType.CONVERGENCE
                    s.message = (
                        f"Gradient tolerance reached. Gradient max norm: "
                        f"{it.gradient_max_norm:e} <= {o.gradient_tolerance:e}"
                    )
                    return state
                cost_change = abs(it.cost_change)
                if cost_change <= o.function_tolerance * abs(current_cost):
                    s.termination_type = TerminationType.CONVERGENCE
                    s.message = (
                        f"Function tolerance reached. |cost_change|/cost: "
                        f"{cost_change / max(abs(current_cost), 1e-300):e} <= "
                        f"{o.function_tolerance:e}"
                    )
                    return state
            if o.parameter_tolerance > 0 and step_norm <= o.parameter_tolerance * (
                x_norm + o.parameter_tolerance
            ):
                s.termination_type = TerminationType.CONVERGENCE
                s.message = (
                    f"Parameter tolerance reached. Relative step_norm: "
                    f"{step_norm / (x_norm + o.parameter_tolerance):e} <= "
                    f"{o.parameter_tolerance:e}"
                )
                return state
            if radius <= o.min_trust_region_radius:
                s.termination_type = TerminationType.CONVERGENCE
                s.message = "Minimum trust region radius reached."
                return state

    def _log_iteration(self, it: IterationSummary):
        if (
            self.options.logging_type == LoggingType.SILENT
            or not self.options.minimizer_progress_to_stdout
        ):
            return
        if it.iteration == 0:
            print(
                f"{'iter':>4} {'cost':>13} {'cost_change':>12} {'|gradient|':>11}"
                f" {'|step|':>10} {'tr_ratio':>9} {'tr_radius':>10} {'ls_iter':>8}"
                f" {'iter_time':>10} {'total_time':>11}"
            )
        print(
            f"{it.iteration:4d} {it.cost:13.6e} {it.cost_change:12.2e}"
            f" {it.gradient_max_norm:11.2e} {it.step_norm:10.2e}"
            f" {it.relative_decrease:9.2e} {it.trust_region_radius:10.2e}"
            f" {it.linear_solver_iterations:8d}"
            f" {it.iteration_time_in_seconds:10.2e}"
            f" {it.cumulative_time_in_seconds:11.2e}"
        )

    # -- hooks (skeres_tpu/core/minimizer.py:184-253, :1224-1279) ---------------

    def _maybe_dump(self, iteration: int, state, data, g, diag, radius, dx):
        """Trust-region linear-system dumps (reference:
        TrustRegionMinimizer::MaybeDumpLinearLeastSquaresProblem, ``solver.h``
        trust_region_problem_dump_*) at the iterations listed in
        ``trust_region_minimizer_iterations_to_dump``. TEXTFILE writes
        ``lm_iteration_NNN.npz`` into ``trust_region_problem_dump_directory``
        with ``gradient``, ``lm_diagonal``, ``trust_region_radius``, ``step``
        and ``state_<group>``, the same values as the JAX package's dump, and
        ``solver_data_<k>``, the leaves of the linear solver's data in
        ``torch.utils._pytree`` order. Those leaves follow the port's data,
        not the JAX package's: no pad rows, and for the Schur solvers the
        port's prepared dict (its keys sorted), not the JAX pytree, so their
        number, order and shapes differ. CONSOLE prints shapes and norms.
        Under a mesh only rank 0 dumps (its solver data: its own rows)."""
        o = self.options
        if iteration not in o.trust_region_minimizer_iterations_to_dump or self.ev.rank != 0:
            return
        host = lambda t: t.detach().to("cpu").numpy()  # noqa: E731
        leaves = [x for x in pytree.tree_leaves(data) if isinstance(x, torch.Tensor)]
        if o.trust_region_problem_dump_format_type == DumpFormatType.CONSOLE:
            lines = [f"LM iteration {iteration}: radius={float(radius):.6e} "
                     f"|g|={float(torch.linalg.norm(g)):.6e} "
                     f"|step|={float(torch.linalg.norm(dx)):.6e}"]
            lines += [f"  solver_data[{k}]: shape {tuple(leaf.shape)} dtype {leaf.dtype}"
                      for k, leaf in enumerate(leaves)]
            print("\n".join(lines), flush=True)
            return
        if not o.trust_region_problem_dump_directory:
            return
        os.makedirs(o.trust_region_problem_dump_directory, exist_ok=True)
        arrays = {"gradient": host(g), "lm_diagonal": host(diag),
                  "trust_region_radius": np.asarray(float(radius)), "step": host(dx)}
        arrays.update({f"state_{gi}": host(x) for gi, x in enumerate(state)})
        arrays.update({f"solver_data_{k}": host(leaf) for k, leaf in enumerate(leaves)})
        np.savez_compressed(os.path.join(o.trust_region_problem_dump_directory,
                                         f"lm_iteration_{iteration:03d}.npz"), **arrays)

    def _maybe_checkpoint(self, state, radius: float, iteration: int, cost: float):
        """Save a checkpoint every ``checkpoint_every_n_iterations``-th
        iteration (``utils/checkpoint.py``)."""
        o = self.options
        if o.checkpoint_path is None:
            return
        if iteration % max(o.checkpoint_every_n_iterations, 1) != 0:
            return
        save_checkpoint(
            o.checkpoint_path,
            [x.detach().to("cpu", torch.float64).numpy() for x in state],
            radius,
            iteration,
            cost,
        )

    def _prepare_for_evaluation(self, evaluate_jacobians: bool, new_point: bool):
        """Fire the user's EvaluationCallback before an evaluation
        (reference: ``include/ceres/evaluation_callback.h``)."""
        cb = self.options.evaluation_callback
        if cb is not None:
            cb.prepare_for_evaluation(evaluate_jacobians, new_point)

    def _callback_wants_state(self, cb) -> bool:
        """True if the callback takes a second REQUIRED positional parameter
        (the state); cached per callback."""
        cache = self._cb_arity_cache
        key = id(cb)
        if key not in cache:
            try:
                params = inspect.signature(cb).parameters.values()
            except (TypeError, ValueError):
                cache[key] = False
            else:
                required = [
                    p for p in params
                    if p.default is inspect.Parameter.empty
                    and p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                                   inspect.Parameter.POSITIONAL_OR_KEYWORD)
                ]
                cache[key] = len(required) >= 2
        return cache[key]

    def _run_callbacks(self, it: IterationSummary, state) -> bool:
        """Returns True if the solve should stop (sets the termination)."""
        if self.options.update_state_every_iteration:
            self.ev.program.write_back(state)
        for cb in self.options.callbacks:
            ret = cb(it, state) if self._callback_wants_state(cb) else cb(it)
            if ret == CallbackReturnType.SOLVER_ABORT:
                self.summary.termination_type = TerminationType.USER_FAILURE
                self.summary.message = "User callback returned SOLVER_ABORT."
                return True
            if ret == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                self.summary.termination_type = TerminationType.USER_SUCCESS
                self.summary.message = "User callback returned SOLVER_TERMINATE_SUCCESSFULLY."
                return True
        return False
