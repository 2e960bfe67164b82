"""Built-in iteration callbacks.

PyTorch counterpart of ``skeres_tpu/core/callbacks.py`` (reference
lineage: ``internal/ceres/callbacks.cc``, ``include/ceres/iteration_callback.h``):
callbacks are plain callables ``cb(IterationSummary) -> CallbackReturnType
| None``, or ``cb(IterationSummary, state)`` when they take two required
parameters, called by the host loop after iteration 0 and after every
valid step. The device loop calls none, as in the JAX package.
"""

from __future__ import annotations

from skeres_tpu_torch.core.summary import IterationSummary
from skeres_tpu_torch.core.types import CallbackReturnType

__all__ = [
    "LoggingCallback",
    "AbortAtIterationCallback",
    "HistoryCallback",
    "StateUpdatingCallback",
    "EvaluationCallback",
]


class LoggingCallback:
    """Prints the canonical per-iteration line (reference: LoggingCallback)."""

    def __init__(self, log_to_stdout: bool = True):
        self.log_to_stdout = log_to_stdout

    def __call__(self, it: IterationSummary):
        msg = (
            f"{it.iteration:4d}: f:{it.cost: .6e} d:{it.cost_change: .2e} "
            f"g:{it.gradient_max_norm: .2e} h:{it.step_norm: .2e} "
            f"rho:{it.relative_decrease: .2e} mu:{it.trust_region_radius: .2e} "
            f"li:{it.linear_solver_iterations:3d} "
            f"it:{it.iteration_time_in_seconds: .2e} "
            f"tt:{it.cumulative_time_in_seconds: .2e}"
        )
        if self.log_to_stdout:
            print(msg)
        return CallbackReturnType.SOLVER_CONTINUE


class AbortAtIterationCallback:
    """Terminates the solve at a given iteration (testing, budget caps)."""

    def __init__(self, max_iteration: int, successfully: bool = True):
        self.max_iteration = max_iteration
        self.successfully = successfully

    def __call__(self, it: IterationSummary):
        if it.iteration >= self.max_iteration:
            return (
                CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY
                if self.successfully
                else CallbackReturnType.SOLVER_ABORT
            )
        return CallbackReturnType.SOLVER_CONTINUE


class HistoryCallback:
    """Records every IterationSummary (a hook point for external metrics)."""

    def __init__(self):
        self.history: list[IterationSummary] = []

    def __call__(self, it: IterationSummary):
        self.history.append(it)
        return CallbackReturnType.SOLVER_CONTINUE


class StateUpdatingCallback:
    """Writes the current iterate back into the problem's parameter arrays
    every iteration (reference: StateUpdatingCallback in
    ``internal/ceres/callbacks.cc``); the same as setting
    ``SolverOptions.update_state_every_iteration``, which needs no handle.

    Takes a ``Problem`` (compiled on first use) or a ``Program``."""

    def __init__(self, problem_or_program):
        self._target = problem_or_program
        self._program = None

    def __call__(self, it: IterationSummary, state):
        if self._program is None:
            t = self._target
            self._program = t if hasattr(t, "write_back") else t.compile()
        self._program.write_back(state)
        return CallbackReturnType.SOLVER_CONTINUE


class EvaluationCallback:
    """Pre-evaluation hook protocol (reference:
    ``include/ceres/evaluation_callback.h``). Set an instance on
    ``SolverOptions.evaluation_callback``; the host loop calls
    ``prepare_for_evaluation`` before every evaluation of residuals or
    Jacobians. Unlike the reference, the hook receives no state: the
    iterate lives on the device and is not written back before it fires.
    Data a residual function reads is fixed when ``solve()`` uploads the
    problem; a change to it needs a fresh ``solve()``."""

    def prepare_for_evaluation(self, evaluate_jacobians: bool, new_evaluation_point: bool) -> None:
        raise NotImplementedError
