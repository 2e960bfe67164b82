"""Solver options (reference lineage: ``include/ceres/solver.h`` —
``Solver::Options``). Same field names and defaults as
``skeres_tpu/core/options.py``, plus ``device``; ``dtype`` names a torch
dtype, and ``mesh`` a 1-D ``torch.distributed`` ``DeviceMesh``
(``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

from skeres_tpu_torch.core.types import (
    DoglegType,
    DumpFormatType,
    LinearSolverType,
    LineSearchDirectionType,
    LineSearchType,
    LoggingType,
    MinimizerType,
    PreconditionerType,
    TrustRegionStrategyType,
)

__all__ = ["SolverOptions"]


@dataclasses.dataclass
class SolverOptions:
    # -- top-level choices ---------------------------------------------------
    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION
    trust_region_strategy_type: TrustRegionStrategyType = (
        TrustRegionStrategyType.LEVENBERG_MARQUARDT
    )
    dogleg_type: DoglegType = DoglegType.TRADITIONAL_DOGLEG
    linear_solver_type: LinearSolverType = LinearSolverType.DENSE_QR
    preconditioner_type: PreconditionerType = PreconditionerType.JACOBI
    max_num_spse_iterations: int = 5
    spse_tolerance: float = 0.1
    use_explicit_schur_complement: bool = False

    # -- iteration/time limits ----------------------------------------------
    max_num_iterations: int = 50
    max_solver_time_in_seconds: float = 1e6

    # -- trust region --------------------------------------------------------
    initial_trust_region_radius: float = 1e4
    max_trust_region_radius: float = 1e16
    min_trust_region_radius: float = 1e-32
    min_relative_decrease: float = 1e-3
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    max_num_consecutive_invalid_steps: int = 5
    use_nonmonotonic_steps: bool = False
    max_consecutive_nonmonotonic_steps: int = 5
    jacobi_scaling: bool = True
    # True: recompute the Jacobi column scaling at every accepted step;
    # False: keep the iteration-zero scaling, as the reference does
    refresh_jacobi_scaling: bool = True

    # -- convergence tolerances ----------------------------------------------
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8

    # -- iterative linear solvers ---------------------------------------------
    min_linear_solver_iterations: int = 0
    max_linear_solver_iterations: int = 500
    eta: float = 1e-1

    # -- line search (LINE_SEARCH minimizer) ----------------------------------
    line_search_direction_type: LineSearchDirectionType = (
        LineSearchDirectionType.LBFGS
    )
    line_search_type: LineSearchType = LineSearchType.WOLFE
    max_lbfgs_rank: int = 20
    use_approximate_eigenvalue_bfgs_scaling: bool = True
    line_search_sufficient_function_decrease: float = 1e-4
    line_search_sufficient_curvature_decrease: float = 0.9
    max_num_line_search_step_size_iterations: int = 20
    max_num_line_search_direction_restarts: int = 5
    min_line_search_step_size: float = 1e-9
    max_line_search_step_expansion: float = 10.0

    # -- gradient checking -----------------------------------------------------
    check_gradients: bool = False
    gradient_check_relative_precision: float = 1e-8
    gradient_check_numeric_derivative_relative_step_size: float = 1e-6

    # -- mixed precision --------------------------------------------------------
    use_mixed_precision_solves: bool = False
    max_num_refinement_iterations: int = 0

    # -- inner iterations --------------------------------------------------------
    use_inner_iterations: bool = False
    inner_iteration_tolerance: float = 1e-3

    # -- logging / callbacks -------------------------------------------------
    logging_type: LoggingType = LoggingType.PER_MINIMIZER_ITERATION
    minimizer_progress_to_stdout: bool = False
    callbacks: Sequence[Callable] = dataclasses.field(default_factory=list)
    update_state_every_iteration: bool = False
    evaluation_callback: Optional[Any] = None

    # -- debug dumps -----------------------------------------------------------
    trust_region_problem_dump_directory: str = ""
    trust_region_minimizer_iterations_to_dump: Sequence[int] = ()
    trust_region_problem_dump_format_type: DumpFormatType = (
        DumpFormatType.TEXTFILE
    )

    # -- checkpoint/resume -----------------------------------------------------
    checkpoint_path: Optional[str] = None
    checkpoint_every_n_iterations: int = 10
    resume_from: Optional[str] = None

    # -- no reference counterpart ------------------------------------------------
    use_device_loop: bool = False
    device_loop_chunk_iterations: int = 25
    # dtype of the solver state and every device computation
    dtype: torch.dtype = torch.float64
    # device the solve runs on: "cuda[:k]" (the card), or "cpu" when asked for
    device: Any = "cuda"
    # shard the residual rows over this 1-D ("obs",) DeviceMesh
    # (parallel.make_obs_mesh); None = one device
    mesh: Any = None
    # rows per streamed evaluation chunk; None = one pass per batch
    evaluation_chunk_size: Optional[int] = None
    # "auto" | "forward" | "reverse": per-block Jacobians from T tangent
    # jvps or m cotangent vjps; auto picks reverse when 2*m < T
    jacobian_diff_mode: str = "auto"
    jacobian_sort_threshold: int = 100_000
    jacobian_pad_waste: float = 1.5
    explicit_schur_limit_bytes: int = 2 << 30
    schur_pair_cap: int = 32
    cluster_jacobi_size: int = 64
    cluster_jacobi_boost: float = 1e-3
    # True: synchronize the device after each damped solve so the Summary's
    # linear-solver and residual-evaluation times are exact
    detailed_step_timings: bool = True
    trace_dir: Optional[str] = None
    residual_blocks_for_subset_preconditioner: Any = None
    subset_preconditioner_max_parameters: int = 4096
    # never terminate before max_num_iterations: the convergence and
    # failure tests are skipped, so a benchmark gets a fixed step count
    run_full_iteration_budget: bool = False

    def is_valid(self) -> tuple[bool, str]:
        """Counterpart of Solver::Options::IsValid."""
        checks = [
            (self.max_num_iterations >= 0, "max_num_iterations >= 0"),
            (self.max_solver_time_in_seconds > 0, "max_solver_time_in_seconds > 0"),
            (self.function_tolerance >= 0, "function_tolerance >= 0"),
            (self.gradient_tolerance >= 0, "gradient_tolerance >= 0"),
            (self.parameter_tolerance >= 0, "parameter_tolerance >= 0"),
            (
                self.initial_trust_region_radius > 0,
                "initial_trust_region_radius > 0",
            ),
            (self.max_trust_region_radius > 0, "max_trust_region_radius > 0"),
            (
                self.min_trust_region_radius <= self.max_trust_region_radius,
                "min_trust_region_radius <= max_trust_region_radius",
            ),
            (self.min_relative_decrease >= 0, "min_relative_decrease >= 0"),
            (self.min_lm_diagonal > 0, "min_lm_diagonal > 0"),
            (self.max_lm_diagonal >= self.min_lm_diagonal,
             "max_lm_diagonal >= min_lm_diagonal"),
            (self.max_num_consecutive_invalid_steps >= 0,
             "max_num_consecutive_invalid_steps >= 0"),
            (self.eta > 0, "eta > 0"),
            (self.max_linear_solver_iterations >= 1,
             "max_linear_solver_iterations >= 1"),
            (self.min_linear_solver_iterations >= 0,
             "min_linear_solver_iterations >= 0"),
            (
                self.min_linear_solver_iterations
                <= self.max_linear_solver_iterations,
                "min_linear_solver_iterations <= max_linear_solver_iterations",
            ),
            (
                not (
                    self.preconditioner_type == PreconditionerType.SUBSET
                    and not self.residual_blocks_for_subset_preconditioner
                ),
                "residual_blocks_for_subset_preconditioner non-empty when "
                "preconditioner_type == SUBSET",
            ),
        ]
        for ok, msg in checks:
            if not ok:
                return False, f"invalid SolverOptions: expected {msg}"
        return True, ""
