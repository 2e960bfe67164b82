#!/usr/bin/env python
"""NIST StRD nonlinear-regression scoreboard.

Counterpart of ``examples/nist.py`` (reference lineage: ``examples/nist.cc``):
fits every available StRD problem from both certified starting points and
prints a per-(problem, start) scoreboard of LRE digits, the number of
matching leading digits between the reached and the certified residual sum
of squares, with the success count at the chosen digit threshold.

Problems whose large datasets are not staged under ``data/nist/`` are
reported as SKIPPED.

    python -m examples_torch.nist [--min_digits 4] [--difficulty higher] [--device cpu]
"""

import argparse
import math

import numpy as np

import skeres_tpu_torch as stt
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.types import LinearSolverType
from skeres_tpu_torch.io.nist_strd import PROBLEMS


def fit(prob, b0, max_iterations=1500, device="cuda"):
    y, x_mat = prob.data()
    if prob.log_response:
        y = np.log(y)
    problem = stt.Problem()
    b = problem.add_parameter_block(np.asarray(b0, dtype=np.float64))

    def resid(params, data):
        (p,) = params
        return data[0:1] - prob.model(p, data[None, 1:])

    problem.add_residual_blocks(
        resid,
        None,
        [(b.array, np.zeros(len(y), dtype=np.int32))],
        data=np.concatenate([y.reshape(-1, 1), x_mat], axis=1),
    )
    options = SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_QR,
        max_num_iterations=max_iterations,
        use_nonmonotonic_steps=True,
        function_tolerance=1e-16,
        gradient_tolerance=1e-16,
        parameter_tolerance=1e-16,
        device=device,
    )
    summary = stt.solve(options, problem)
    return 2.0 * summary.final_cost


def lre(value, certified):
    """Log relative error: matching leading digits against the certified
    value (capped at 11, the precision of the published certificates)."""
    if certified == 0.0:
        return 11.0 if value == 0.0 else -math.log10(abs(value))
    if value == certified:
        return 11.0
    return min(11.0, -math.log10(abs(value - certified) / abs(certified)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--min_digits", type=float, default=4.0,
                    help="LRE digits counted as success (nist.cc uses 4)")
    ap.add_argument("--difficulty", default=None, choices=["lower", "average", "higher"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    total = successes = skipped = 0
    print(f"{'problem':<12}{'diff':<9}{'start':>6}{'SSR LRE':>9}  status")
    for name, prob in PROBLEMS.items():
        if args.difficulty and prob.difficulty != args.difficulty:
            continue
        if prob.data() is None:
            print(f"{name:<12}{prob.difficulty:<9}{'-':>6}{'-':>9}  "
                  f"SKIPPED (stage data/nist/{prob.data_file})")
            skipped += len(prob.starts)
            continue
        for si in range(len(prob.starts)):
            total += 1
            try:
                ssr = fit(prob, prob.starts[si], device=args.device)
                digits = lre(ssr, prob.certified_ssr)
            except Exception as exc:  # keep the scoreboard running
                print(f"{name:<12}{prob.difficulty:<9}{si + 1:>6}{'-':>9}  "
                      f"ERROR {type(exc).__name__}")
                continue
            ok = digits >= args.min_digits
            successes += ok
            print(f"{name:<12}{prob.difficulty:<9}{si + 1:>6}{digits:>9.1f}  "
                  f"{'ok' if ok else 'FAILED'}")
    print(f"\n{successes}/{total} (problem, start) pairs certified to "
          f">={args.min_digits} digits; {skipped} skipped awaiting data")
    return successes, total


if __name__ == "__main__":
    main()
