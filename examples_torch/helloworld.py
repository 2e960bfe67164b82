#!/usr/bin/env python
"""Hello world: minimize 0.5 (10 - x)^2.

Counterpart of ``examples/helloworld.py`` (reference lineage:
``examples/helloworld.cc``): the residual is a torch function of one
block, its Jacobian comes from autodiff.

    python -m examples_torch.helloworld [--device cpu]
"""

import argparse

import skeres_tpu_torch as stt
from skeres_tpu_torch.core.options import SolverOptions


def main(device="cuda"):
    problem = stt.Problem()
    x = problem.add_parameter_block([0.5])

    def f(params, data):
        (xv,) = params
        return 10.0 - xv

    problem.add_residual_block(f, None, [x])

    options = SolverOptions(minimizer_progress_to_stdout=True, device=device)
    summary = stt.solve(options, problem)
    print(summary.brief_report())
    print(f"x : 0.5 -> {float(x.value[0]):.6f}")
    return summary, float(x.value[0])


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
