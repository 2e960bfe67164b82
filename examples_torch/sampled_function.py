#!/usr/bin/env python
"""Minimize an interpolated sampled function (counterpart of
``examples/sampled_function.py``; reference lineage:
``examples/sampled_function/sampled_function.cc``): the cost is known only
at integer samples of f(x) = (x - 4.5)^2; a differentiable Catmull-Rom
interpolant (``ops/interpolation.py`` CubicInterpolator) makes it usable as
a residual, and the solver finds the minimum between samples.

    python -m examples_torch.sampled_function [--device cpu]
"""

import argparse

import numpy as np

import skeres_tpu_torch as stt
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.ops.interpolation import CubicInterpolator


def main(device="cuda"):
    values = np.array([(i - 4.5) ** 2 for i in range(10)])
    interpolator = CubicInterpolator(values)

    problem = stt.Problem()
    x = problem.add_parameter_block([1.0])

    def resid(params, data):
        (xv,) = params
        return interpolator.evaluate(xv[0]).reshape(1)

    problem.add_residual_block(resid, None, [x])
    summary = stt.solve(
        SolverOptions(max_num_iterations=100, minimizer_progress_to_stdout=True, device=device),
        problem,
    )
    print(summary.brief_report())
    print(f"expected x: 4.5, actual x: {float(np.asarray(x.value)[0]):.6f}")
    return float(np.asarray(x.value)[0])


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
