"""Solver summary and per-iteration records (reference lineage:
``include/ceres/solver.h`` — ``Solver::Summary``, ``IterationSummary`` — and
``internal/ceres/solver.cc`` for the report formatting). Same fields and
report as ``skeres_tpu/core/summary.py``; every time field is read from the
host clock after the device has been synchronized."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from skeres_tpu_torch.core.types import (
    LinearSolverType,
    MinimizerType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
)

__all__ = ["IterationSummary", "Summary"]


@dataclasses.dataclass
class IterationSummary:
    iteration: int = 0
    step_is_valid: bool = False
    step_is_nonmonotonic: bool = False
    step_is_successful: bool = False
    cost: float = 0.0
    cost_change: float = 0.0
    gradient_max_norm: float = 0.0
    gradient_norm: float = 0.0
    step_norm: float = 0.0
    relative_decrease: float = 0.0
    trust_region_radius: float = 0.0
    eta: float = 0.0
    step_size: float = 0.0
    line_search_function_evaluations: int = 0
    line_search_gradient_evaluations: int = 0
    line_search_iterations: int = 0
    linear_solver_iterations: int = 0
    iteration_time_in_seconds: float = 0.0
    step_solver_time_in_seconds: float = 0.0
    cumulative_time_in_seconds: float = 0.0


@dataclasses.dataclass
class Summary:
    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION
    termination_type: TerminationType = TerminationType.FAILURE
    message: str = "solve was not called"

    initial_cost: float = -1.0
    final_cost: float = -1.0
    fixed_cost: float = 0.0

    iterations: List[IterationSummary] = dataclasses.field(default_factory=list)

    num_successful_steps: int = 0
    num_unsuccessful_steps: int = 0
    num_inner_iteration_steps: int = 0
    num_line_search_steps: int = 0

    preprocessor_time_in_seconds: float = 0.0
    # of which the device loop's warm-up and CUDA-graph capture
    device_loop_capture_time_in_seconds: float = 0.0
    minimizer_time_in_seconds: float = 0.0
    postprocessor_time_in_seconds: float = 0.0
    total_time_in_seconds: float = 0.0
    linear_solver_time_in_seconds: float = 0.0
    residual_evaluation_time_in_seconds: float = 0.0
    jacobian_evaluation_time_in_seconds: float = 0.0
    num_linear_solves: int = 0
    # dogleg (host loop): the linear solver iterations of each Gauss-Newton
    # solve (one a linearization; a Schur solve counts 1 + its jitter rungs),
    # and the steps that took the Cauchy point (the GN point not finite, or
    # the Cauchy point on or past the trust-region boundary)
    dogleg_gauss_newton_iterations: List[int] = dataclasses.field(default_factory=list)
    num_dogleg_cauchy_steps: int = 0
    num_residual_evaluations: int = 0
    num_jacobian_evaluations: int = 0

    num_parameter_blocks: int = 0
    num_parameters: int = 0
    num_effective_parameters: int = 0
    num_residual_blocks: int = 0
    num_residuals: int = 0
    num_parameter_blocks_reduced: int = 0
    num_parameters_reduced: int = 0
    num_effective_parameters_reduced: int = 0
    num_residual_blocks_reduced: int = 0
    num_residuals_reduced: int = 0

    trust_region_strategy_type: TrustRegionStrategyType = (
        TrustRegionStrategyType.LEVENBERG_MARQUARDT
    )
    linear_solver_type_given: LinearSolverType = LinearSolverType.DENSE_QR
    linear_solver_type_used: LinearSolverType = LinearSolverType.DENSE_QR
    preconditioner_type_given: PreconditionerType = PreconditionerType.JACOBI
    preconditioner_type_used: PreconditionerType = PreconditionerType.JACOBI

    num_devices: int = 1
    dtype: str = ""
    # S-assembly path the Schur solver took ("dense-W" in the port)
    schur_complement_path: str = ""

    @property
    def is_solution_usable(self) -> bool:
        return self.termination_type in (
            TerminationType.CONVERGENCE,
            TerminationType.NO_CONVERGENCE,
            TerminationType.USER_SUCCESS,
        )

    def brief_report(self) -> str:
        return (
            f"skeres-tpu-torch Solver Report: Iterations: {len(self.iterations)}, "
            f"Initial cost: {self.initial_cost:e}, "
            f"Final cost: {self.final_cost:e}, "
            f"Termination: {self.termination_type.value}"
        )

    def full_report(self) -> str:
        lines = []
        a = lines.append
        a("")
        a("Solver Summary (v skeres-tpu-torch)")
        a("")
        a(f"{'':40}{'Original':>12}{'Reduced':>12}")
        a(
            f"{'Parameter blocks':40}{self.num_parameter_blocks:>12}"
            f"{self.num_parameter_blocks_reduced:>12}"
        )
        a(
            f"{'Parameters':40}{self.num_parameters:>12}"
            f"{self.num_parameters_reduced:>12}"
        )
        if self.num_effective_parameters != self.num_parameters:
            a(
                f"{'Effective parameters':40}{self.num_effective_parameters:>12}"
                f"{self.num_effective_parameters_reduced:>12}"
            )
        a(
            f"{'Residual blocks':40}{self.num_residual_blocks:>12}"
            f"{self.num_residual_blocks_reduced:>12}"
        )
        a(
            f"{'Residuals':40}{self.num_residuals:>12}"
            f"{self.num_residuals_reduced:>12}"
        )
        a("")
        a(f"{'Minimizer':40}{self.minimizer_type.value:>24}")
        if self.minimizer_type == MinimizerType.TRUST_REGION:
            a(
                f"{'Trust region strategy':40}"
                f"{self.trust_region_strategy_type.value:>24}"
            )
            a(f"{'':40}{'Given':>12}{'Used':>12}")
            a(
                f"{'Linear solver':40}{self.linear_solver_type_given.value:>12}"
                f"{self.linear_solver_type_used.value:>12}"
            )
            if self.linear_solver_type_used in (
                LinearSolverType.CGNR,
                LinearSolverType.ITERATIVE_SCHUR,
            ):
                a(
                    f"{'Preconditioner':40}"
                    f"{self.preconditioner_type_given.value:>12}"
                    f"{self.preconditioner_type_used.value:>12}"
                )
            if self.schur_complement_path:
                a(f"{'Schur complement':40}{self.schur_complement_path:>24}")
        a(f"{'Devices':40}{self.num_devices:>24}")
        a(f"{'Device dtype':40}{self.dtype:>24}")
        a("")
        a("Cost:")
        a(f"Initial        {self.initial_cost:30.6e}")
        if self.is_solution_usable:
            a(f"Final          {self.final_cost:30.6e}")
            a(f"Change         {self.initial_cost - self.final_cost:30.6e}")
        a("")
        a(
            f"Minimizer iterations           {len(self.iterations):16}"
        )
        a(f"Successful steps               {self.num_successful_steps:16}")
        a(f"Unsuccessful steps             {self.num_unsuccessful_steps:16}")
        a("")
        a("Time (in seconds):")
        a(f"Preprocessor    {self.preprocessor_time_in_seconds:24.6f}")
        if self.device_loop_capture_time_in_seconds:
            a(f"  Graph capture {self.device_loop_capture_time_in_seconds:26.6f}")
        a("")
        a(
            f"  Residual only evaluation {self.residual_evaluation_time_in_seconds:15.6f}"
            f" ({self.num_residual_evaluations})"
        )
        a(
            f"  Jacobian & residual evaluation {self.jacobian_evaluation_time_in_seconds:9.6f}"
            f" ({self.num_jacobian_evaluations})"
        )
        a(
            f"  Linear solver       {self.linear_solver_time_in_seconds:20.6f}"
            f" ({self.num_linear_solves})"
        )
        a(f"Minimizer       {self.minimizer_time_in_seconds:24.6f}")
        a("")
        a(f"Postprocessor   {self.postprocessor_time_in_seconds:24.6f}")
        a(f"Total           {self.total_time_in_seconds:24.6f}")
        a("")
        a(
            f"Termination:    {self.termination_type.value} ({self.message})"
        )
        a("")
        return "\n".join(lines)
