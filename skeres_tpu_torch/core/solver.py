"""``solve(options, problem)`` — the user-facing entry point.

PyTorch counterpart of ``skeres_tpu/core/solver.py`` (reference lineage:
``ceres::Solve``, ``trust_region_preprocessor.cc``): compile the Problem
into a Program, build the Evaluator and the linear solver on
``options.device`` (the card unless the caller asks for the CPU) in
``options.dtype``, run the minimizer (the host loop, or the device loop
of ``core/device_loop.py`` with ``use_device_loop``), write the solution
back. A checkpoint (``resume_from``) replaces the initial values, radius
and iteration count.

The port runs the Levenberg-Marquardt trust region with DENSE_SCHUR (the
bundle-adjustment path). Every option it does not run yet raises
``NotImplementedError`` naming what is missing; none falls back to
something else.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from skeres_tpu_torch.core.device_loop import DeviceLoopMinimizer
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.minimizer import TrustRegionMinimizer, synchronize
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.problem import Problem, Program
from skeres_tpu_torch.core.schur import SchurSolver
from skeres_tpu_torch.core.summary import Summary
from skeres_tpu_torch.core.types import LinearSolverType, TerminationType
from skeres_tpu_torch.utils.checkpoint import load_checkpoint

__all__ = ["TRACE_FILE", "solve"]

# written under SolverOptions.trace_dir: a torch.profiler (Chrome) trace of
# the minimizer, kernels on the card included
TRACE_FILE = "minimize_trace.json"

_DEFAULTS = SolverOptions()

# options that select code the port does not have yet: any value other
# than the default raises
_UNPORTED = {
    "minimizer_type": "the line-search minimizer (core/line_search.py)",
    "trust_region_strategy_type": "the dogleg strategy",
    "use_explicit_schur_complement": "the explicit Schur complement (core/explicit_schur.py)",
    "mesh": "multi-device sharding (parallel/mesh.py)",
    "use_mixed_precision_solves": "mixed-precision refinement",
    "use_inner_iterations": "inner iterations (core/inner_iterations.py)",
    "check_gradients": "the gradient checker (core/gradient_checker.py)",
    "trust_region_minimizer_iterations_to_dump": "trust-region problem dumps",
}


def _check_ported(options: SolverOptions) -> None:
    for name, what in _UNPORTED.items():
        if getattr(options, name) != getattr(_DEFAULTS, name):
            raise NotImplementedError(f"SolverOptions.{name}: {what} is not ported yet")


def _select_linear_solver(options: SolverOptions, program: Program) -> LinearSolverType:
    """The reference preprocessor's solver choice, as far as it is ported:
    SPARSE_SCHUR routes to DENSE_SCHUR (no general sparse factorization),
    and DENSE_SCHUR needs a declared elimination group."""
    given = options.linear_solver_type
    if given == LinearSolverType.SPARSE_SCHUR:
        given = LinearSolverType.DENSE_SCHUR
    if given != LinearSolverType.DENSE_SCHUR:
        raise NotImplementedError(
            f"linear solver {given.value}: only DENSE_SCHUR is ported yet"
        )
    if not any(g.schur_group == 0 for g in program.groups):
        raise NotImplementedError(
            "DENSE_SCHUR without a declared elimination group needs the "
            "automatic Schur ordering (core/ordering.py), which is not ported "
            "yet; declare one with set_schur_elimination_group(points, 0)"
        )
    return given


def solve(
    options: SolverOptions,
    problem: Problem,
    program: Optional[Program] = None,
) -> Summary:
    """Solve the problem; writes the solution back into the problem's
    parameter arrays and returns a Summary (reference: ``ceres::Solve``)."""
    summary = Summary()
    total_start = time.time()

    ok, msg = options.is_valid()
    if not ok:
        summary.termination_type = TerminationType.FAILURE
        summary.message = msg
        return summary
    _check_ported(options)
    device = torch.device(options.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"SolverOptions.device is {options.device!r} but no CUDA device is "
            "available; pass device='cpu' to solve on the CPU"
        )

    # -- preprocess -----------------------------------------------------------
    t0 = time.time()
    if program is None:
        program = problem.compile()
    summary.num_parameter_blocks = program.num_parameter_blocks
    summary.num_parameters = program.num_parameters
    summary.num_effective_parameters = program.num_effective_parameters
    summary.num_residual_blocks = program.num_residual_blocks
    summary.num_residuals = program.num_residuals
    summary.num_parameter_blocks_reduced = program.num_parameter_blocks
    summary.num_parameters_reduced = program.num_parameters
    summary.num_effective_parameters_reduced = program.num_effective_parameters
    summary.num_residual_blocks_reduced = program.num_residual_blocks
    summary.num_residuals_reduced = program.num_residuals
    summary.minimizer_type = options.minimizer_type
    summary.trust_region_strategy_type = options.trust_region_strategy_type
    summary.linear_solver_type_given = options.linear_solver_type
    summary.preconditioner_type_given = options.preconditioner_type
    summary.preconditioner_type_used = options.preconditioner_type
    summary.dtype = str(options.dtype).replace("torch.", "")

    if program.num_residual_blocks == 0 or program.num_tangent == 0:
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = "Problem is empty or all parameter blocks constant."
        cost = 0.0
        if program.num_residual_blocks:
            ev = Evaluator(program, device=device, dtype=options.dtype)
            cost = float(ev.cost(program.initial_state(device, options.dtype)))
        summary.initial_cost = summary.final_cost = cost
        return summary

    summary.linear_solver_type_used = _select_linear_solver(options, program)
    evaluator = Evaluator(
        program,
        device=device,
        dtype=options.dtype,
        chunk_size=options.evaluation_chunk_size,
        diff_mode=options.jacobian_diff_mode,
    )
    schur_solver = SchurSolver(
        evaluator,
        pad_waste=options.jacobian_pad_waste,
        explicit_s_limit_bytes=options.explicit_schur_limit_bytes,
        pair_cap=options.schur_pair_cap,
    )
    summary.schur_complement_path = schur_solver.schur_path
    if options.use_device_loop:
        minimizer = DeviceLoopMinimizer(
            evaluator, options, summary, schur_solver,
            chunk_iterations=min(options.device_loop_chunk_iterations, options.max_num_iterations),
        )
    else:
        minimizer = TrustRegionMinimizer(evaluator, options, summary, schur_solver)

    if options.resume_from:
        groups, radius, iteration, _cost = load_checkpoint(options.resume_from)
        if len(groups) != len(program.groups):
            summary.termination_type = TerminationType.FAILURE
            summary.message = (
                f"checkpoint has {len(groups)} parameter groups, problem has "
                f"{len(program.groups)}"
            )
            return summary
        for g, v in zip(program.groups, groups):
            if v.shape != g.values.shape:
                summary.termination_type = TerminationType.FAILURE
                summary.message = "checkpoint group shape mismatch"
                return summary
            g.values = v
        minimizer.initial_radius_override = radius
        minimizer.initial_iteration = iteration

    state = program.initial_state(device, options.dtype)
    # the device loop's first linearization and CUDA-graph capture count as
    # preprocessing, as the JAX package's compilation does
    if options.use_device_loop:
        minimizer.compile_programs(state)
        summary.device_loop_capture_time_in_seconds = minimizer.capture_seconds
    synchronize(device)
    summary.preprocessor_time_in_seconds = time.time() - t0

    # -- minimize ---------------------------------------------------------------
    t0 = time.time()
    if options.trace_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            state = minimizer.minimize(state)
            synchronize(device)
    else:
        state = minimizer.minimize(state)
        synchronize(device)
    summary.minimizer_time_in_seconds = time.time() - t0
    if options.trace_dir:
        os.makedirs(options.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(options.trace_dir, TRACE_FILE))

    # -- postprocess -------------------------------------------------------------
    t0 = time.time()
    program.write_back(state)
    if summary.final_cost < 0.0 and summary.iterations:
        summary.final_cost = min(it.cost for it in summary.iterations)
    summary.postprocessor_time_in_seconds = time.time() - t0
    summary.total_time_in_seconds = time.time() - total_start
    return summary
