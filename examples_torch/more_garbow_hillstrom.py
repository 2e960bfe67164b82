#!/usr/bin/env python
"""More-Garbow-Hillstrom test-set scoreboard.

Counterpart of ``examples/more_garbow_hillstrom.py`` (reference lineage:
``examples/more_garbow_hillstrom.cc``): solves every function of the MGH
(TOMS 1981) test set from the paper's standard starting point and prints
the reached against the certified minimum (sum-of-squares F convention).
Documented local minima reachable from the standard start count as
certified, as in the reference's expected-value tables.

    python -m examples_torch.more_garbow_hillstrom           # all 35
    python -m examples_torch.more_garbow_hillstrom --problem 14 --device cpu
"""

import argparse

import numpy as np

import skeres_tpu_torch as stt
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.types import LinearSolverType
from skeres_tpu_torch.models.mgh import PROBLEMS


def solve(prob, device="cuda"):
    problem = stt.Problem()
    x = problem.add_parameter_block(np.asarray(prob.x0, dtype=np.float64))

    def fn(params, data):
        (p,) = params
        return prob.residual(p)

    problem.add_residual_block(fn, None, [x])
    options = SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_QR,
        max_num_iterations=prob.max_iterations,
        use_nonmonotonic_steps=True,
        function_tolerance=1e-16,
        gradient_tolerance=1e-16,
        parameter_tolerance=1e-16,
        device=device,
    )
    summary = stt.solve(options, problem)
    return 2.0 * summary.final_cost


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", type=int, default=None,
                    help="registry key (1-35 + size variants); default all")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    keys = [args.problem] if args.problem else sorted(PROBLEMS)
    ok = 0
    print(f"{'#':>4} {'name':<28}{'reached F':>14}{'certified F*':>16}  status")
    for k in keys:
        prob = PROBLEMS[k]
        f = solve(prob, args.device)
        good = prob.certified(f)
        ok += good
        cert = ", ".join(f"{v:.6g}" for v in prob.fstars)
        print(f"{k:>4} {prob.name:<28}{f:>14.6e}{cert:>16}  {'ok' if good else 'FAILED'}")
    print(f"\n{ok}/{len(keys)} certified")
    return ok, len(keys)


if __name__ == "__main__":
    main()
