"""``solve(options, problem)`` — the user-facing entry point.

PyTorch counterpart of ``skeres_tpu/core/solver.py`` (reference lineage:
``ceres::Solve``, ``trust_region_preprocessor.cc``): compile the Problem
into a Program, build the Evaluator and the linear solver on
``options.device`` (the card unless the caller asks for the CPU) in
``options.dtype``, run the minimizer (the host loop, or the device loop
of ``core/device_loop.py`` with ``use_device_loop``), write the solution
back. A checkpoint (``resume_from``) replaces the initial values, radius
and iteration count.

The port runs the trust region, Levenberg-Marquardt or dogleg
(traditional or subspace; the host loop, as in the JAX package), with
every linear solver of the JAX package: DENSE_QR, DENSE_NORMAL_CHOLESKY,
CGNR (JACOBI or SUBSET), DENSE_SCHUR and ITERATIVE_SCHUR (JACOBI,
SCHUR_JACOBI, POWER_SERIES_EXPANSION, CLUSTER_JACOBI, CLUSTER_TRIDIAGONAL;
the implicit or the explicit S), chosen as the reference's preprocessor
chooses (``_select_linear_solver``); the downgrades it makes are logged
and written to the Summary. Inner iterations (``use_inner_iterations``)
refine the independent group in both loops; the trust-region dumps write
or print the linear system. ``MinimizerType.LINE_SEARCH`` runs the
line-search minimizer (``core/line_search.py``; ``use_device_loop`` does
not apply to it, as in the JAX package), and ``check_gradients`` checks
every batch's Jacobian against numeric differences before the solve
(``core/gradient_checker.py``). With ``mesh`` (a 1-D ``DeviceMesh``
from ``parallel.make_obs_mesh``) every rank of the mesh calls ``solve``
on the same problem; the evaluator holds the rank's share of the rows and
reduces over the ranks (``parallel/mesh.py``), and every rank returns the
same Summary and solution. No option falls back to something else.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import torch

from skeres_tpu_torch.core.device_loop import DeviceLoopMinimizer
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.gradient_checker import check_program_gradients
from skeres_tpu_torch.core.inner_iterations import InnerIterationRefiner
from skeres_tpu_torch.core.line_search import LineSearchMinimizer
from skeres_tpu_torch.core.minimizer import TrustRegionMinimizer, synchronize
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.ordering import apply_schur_ordering
from skeres_tpu_torch.core.problem import Problem, Program
from skeres_tpu_torch.core.schur import SchurSolver
from skeres_tpu_torch.core.summary import Summary
from skeres_tpu_torch.core.types import (
    LinearSolverType,
    MinimizerType,
    PreconditionerType,
    TerminationType,
)
from skeres_tpu_torch.parallel.mesh import check_obs_mesh
from skeres_tpu_torch.utils.checkpoint import load_checkpoint
from skeres_tpu_torch.utils.trace import next_solve_number, span

__all__ = ["TRACE_FILE", "solve"]

# written under SolverOptions.trace_dir: a torch.profiler (Chrome) trace of
# the minimizer, kernels on the card included
TRACE_FILE = "minimize_trace.json"

def _select_linear_solver(options: SolverOptions, program: Program) -> LinearSolverType:
    """The reference preprocessor's solver choice. SPARSE_NORMAL_CHOLESKY
    and SPARSE_SCHUR have no general sparse factorization here and route to
    CGNR and DENSE_SCHUR. A Schur solver without a declared elimination
    group finds one (``core/ordering.py``, the reference's automatic Schur
    ordering) and, where there is none, becomes DENSE_NORMAL_CHOLESKY;
    SPARSE_SCHUR too, which the JAX package routes before it looks for a
    group, and so fails on an undeclared one."""
    given = options.linear_solver_type
    if given == LinearSolverType.SPARSE_NORMAL_CHOLESKY:
        return LinearSolverType.CGNR
    if given == LinearSolverType.SPARSE_SCHUR:
        given = LinearSolverType.DENSE_SCHUR
    if given in (LinearSolverType.DENSE_SCHUR, LinearSolverType.ITERATIVE_SCHUR):
        if not any(g.schur_group == 0 for g in program.groups):
            if apply_schur_ordering(program) is None:
                return LinearSolverType.DENSE_NORMAL_CHOLESKY
    return given


def solve(
    options: SolverOptions,
    problem: Problem,
    program: Optional[Program] = None,
) -> Summary:
    """Solve the problem; writes the solution back into the problem's
    parameter arrays and returns a Summary (reference: ``ceres::Solve``).
    Under a profiler the solve is the span ``skeres.solve``, with the
    process's solve number (``utils/trace.py``)."""
    with span("skeres.solve", solve=next_solve_number()):
        return _solve(options, problem, program)


def _solve(options: SolverOptions, problem: Problem, program: Optional[Program]) -> Summary:
    summary = Summary()
    total_start = time.time()

    ok, msg = options.is_valid()
    if not ok:
        summary.termination_type = TerminationType.FAILURE
        summary.message = msg
        return summary
    if options.mesh is not None:
        check_obs_mesh(options.mesh)
    device = torch.device(options.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"SolverOptions.device is {options.device!r} but no CUDA device is "
            "available; pass device='cpu' to solve on the CPU"
        )

    # -- preprocess -----------------------------------------------------------
    t0 = time.time()
    if program is None:
        with span("skeres.plan.compile"):
            program = problem.compile()
    summary.num_parameter_blocks = program.num_parameter_blocks
    summary.num_parameters = program.num_parameters
    summary.num_effective_parameters = program.num_effective_parameters
    summary.num_residual_blocks = program.num_residual_blocks
    summary.num_residuals = program.num_residuals
    summary.num_parameter_blocks_reduced = program.num_parameter_blocks_reduced
    summary.num_parameters_reduced = program.num_parameters_reduced
    summary.num_effective_parameters_reduced = program.num_effective_parameters_reduced
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

    solver_type = _select_linear_solver(options, program)
    summary.linear_solver_type_used = solver_type
    with span("skeres.plan.evaluator"):
        evaluator = Evaluator(
            program,
            device=device,
            dtype=options.dtype,
            chunk_size=options.evaluation_chunk_size,
            diff_mode=options.jacobian_diff_mode,
            mesh=options.mesh,
        )
    summary.num_devices = evaluator.n_shards
    schur_solver = None
    if (options.visibility_clustering_type is not None and options.use_device_loop
            and solver_type == LinearSolverType.ITERATIVE_SCHUR
            and options.minimizer_type == MinimizerType.TRUST_REGION
            and options.preconditioner_type in (PreconditionerType.CLUSTER_JACOBI,
                                                PreconditionerType.CLUSTER_TRIDIAGONAL)):
        raise NotImplementedError(
            "visibility_clustering_type under use_device_loop: the visibility clusters' factor "
            "reads on the host whether to halve the band, which a CUDA graph cannot capture; "
            "solve on the host loop (use_device_loop=False)")
    if solver_type in (LinearSolverType.DENSE_SCHUR, LinearSolverType.ITERATIVE_SCHUR):
        log = logging.getLogger("skeres_tpu_torch")
        with span("skeres.plan.schur"):
            schur_solver = SchurSolver(
                evaluator,
                iterative=solver_type == LinearSolverType.ITERATIVE_SCHUR,
                preconditioner=options.preconditioner_type,
                max_cg_iterations=options.max_linear_solver_iterations,
                eta=options.eta,
                refinement_iterations=(options.max_num_refinement_iterations
                                       if options.use_mixed_precision_solves else 0),
                max_power_series_terms=options.max_num_spse_iterations,
                spse_tolerance=options.spse_tolerance,
                sort_threshold=options.jacobian_sort_threshold,
                pad_waste=options.jacobian_pad_waste,
                use_explicit=options.use_explicit_schur_complement,
                explicit_s_limit_bytes=options.explicit_schur_limit_bytes,
                pair_cap=options.schur_pair_cap,
                cluster_size=options.cluster_jacobi_size,
                cluster_boost=options.cluster_jacobi_boost,
                visibility_clustering=options.visibility_clustering_type,
            )
        used = schur_solver.preconditioner_used
        if options.preconditioner_type == PreconditionerType.SUBSET:
            # reference semantics: SUBSET serves CGNR only
            log.warning("SUBSET preconditioner is CGNR-only (reference: "
                        "subset_preconditioner.cc); downgrading to JACOBI")
            summary.preconditioner_type_used = PreconditionerType.JACOBI
        elif schur_solver.iterative and used != options.preconditioner_type:
            log.warning("%s preconditioner: no cluster plan for this problem; downgrading "
                        "to %s", options.preconditioner_type.value, used.value)
            summary.preconditioner_type_used = used
        summary.schur_complement_path = schur_solver.schur_path
        summary.camera_padded_layout = schur_solver.camera_padded_layout
        if schur_solver.explicit_reject_reason is not None:
            # a wanted explicit-S plan was rejected: say what runs instead
            log.warning("explicit Schur complement plan rejected (%s); using %s",
                        schur_solver.explicit_reject_reason, summary.schur_complement_path)
    inner_refiner = None
    if options.use_inner_iterations:
        if any(g.schur_group == 0 for g in program.groups):
            inner_refiner = InnerIterationRefiner(
                evaluator, num_sweeps=5, tolerance=options.inner_iteration_tolerance)
        else:
            summary.message = (
                "use_inner_iterations ignored: no independent group declared "
                "(set_schur_elimination_group(arr, 0))"
            )
    if options.minimizer_type == MinimizerType.LINE_SEARCH:
        # before the device-loop branch: use_device_loop does not apply
        minimizer = LineSearchMinimizer(evaluator, options, summary)
    else:
        minimizer_cls, kw = TrustRegionMinimizer, {}
        if options.use_device_loop:
            minimizer_cls = DeviceLoopMinimizer
            kw["chunk_iterations"] = min(options.device_loop_chunk_iterations,
                                         options.max_num_iterations)
        minimizer = minimizer_cls(evaluator, options, summary, solver_type,
                                  schur_solver=schur_solver, inner_refiner=inner_refiner, **kw)

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
        if hasattr(minimizer, "initial_radius_override"):
            minimizer.initial_radius_override = radius
            minimizer.initial_iteration = iteration

    if options.check_gradients:
        # under a mesh every rank checks every row, so that all agree
        checker = evaluator if options.mesh is None else Evaluator(
            program, device=device, dtype=options.dtype,
            chunk_size=options.evaluation_chunk_size, diff_mode=options.jacobian_diff_mode)
        ok, msg = check_program_gradients(
            program, checker, relative_precision=options.gradient_check_relative_precision,
            step_size=options.gradient_check_numeric_derivative_relative_step_size)
        if not ok:
            summary.termination_type = TerminationType.FAILURE
            summary.message = f"Gradient check failed: {msg}"
            return summary

    state = program.initial_state(device, options.dtype)
    # the device loop's first linearization and CUDA-graph capture count as
    # preprocessing, as the JAX package's compilation does
    if isinstance(minimizer, DeviceLoopMinimizer):
        with span("skeres.device_loop.capture"):
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
        with profile(activities=activities) as prof, span("skeres.minimize"):
            state = minimizer.minimize(state)
            synchronize(device)
    else:
        with span("skeres.minimize"):
            state = minimizer.minimize(state)
            synchronize(device)
    summary.minimizer_time_in_seconds = time.time() - t0
    if options.trace_dir:
        os.makedirs(options.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(options.trace_dir, TRACE_FILE))

    # -- postprocess -------------------------------------------------------------
    t0 = time.time()
    with span("skeres.postprocess"):
        program.write_back(state)
    summary.num_evaluation_chunks = evaluator.num_evaluation_chunks
    if summary.final_cost < 0.0 and summary.iterations:
        summary.final_cost = min(it.cost for it in summary.iterations)
    summary.postprocessor_time_in_seconds = time.time() - t0
    summary.total_time_in_seconds = time.time() - total_start
    return summary
