#!/usr/bin/env python
"""Image denoising with a Fields-of-Experts-style smoothness prior
(counterpart of ``examples/denoising.py``; reference lineage:
``examples/denoising.cc``, which optimizes a data term plus learned FoE
clique potentials over the image).

As in the JAX example, analytic cliques take the place of trained FoE
filters: a quadratic data term per pixel and robust (Cauchy-penalized)
horizontal and vertical gradient cliques, one residual batch per clique
direction. Every pixel is a parameter block; cliques couple neighbours;
CGNR solves it.

    python -m examples_torch.denoising [--side 64] [--sigma 0.1] [--device cpu]
"""

import argparse

import numpy as np

import skeres_tpu_torch as stt
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.types import LinearSolverType


def make_image(side: int) -> np.ndarray:
    """Piecewise-constant test image (sharp edges: what the robust prior
    must preserve while removing noise)."""
    img = np.zeros((side, side))
    img[side // 4 : 3 * side // 4, side // 4 : 3 * side // 4] = 1.0
    img[side // 2 :, : side // 4] = 0.5
    return img


def denoise(noisy: np.ndarray, sigma: float, max_iterations: int = 50, device="cuda"):
    side = noisy.shape[0]
    problem = stt.Problem()
    # one 1-vector parameter block per pixel, as a single typed group
    pixels = problem.add_parameter_block_array(noisy.reshape(-1, 1), name="pixels")

    n = side * side
    idx = np.arange(n).reshape(side, side)

    def data_resid(params, data):
        (x,) = params
        return (x - data) / sigma

    problem.add_residual_blocks(
        data_resid, None, [(pixels, np.arange(n))], data=noisy.reshape(-1, 1), name="data",
    )

    # clique scale: noise-level gradients (~sigma*sqrt(2)) land in the
    # quadratic region of the Cauchy loss and get smoothed; true edges
    # (0.5..1.0 jumps) land deep in the robust tail and are preserved
    grad_scale = 1.5 * sigma

    def grad_resid(params, data):
        a, b = params
        return (a - b) / grad_scale

    loss = stt.CauchyLoss(2.0)
    h_a, h_b = idx[:, :-1].reshape(-1), idx[:, 1:].reshape(-1)
    v_a, v_b = idx[:-1, :].reshape(-1), idx[1:, :].reshape(-1)
    problem.add_residual_blocks(grad_resid, loss, [(pixels, h_a), (pixels, h_b)],
                                name="h_cliques")
    problem.add_residual_blocks(grad_resid, loss, [(pixels, v_a), (pixels, v_b)],
                                name="v_cliques")

    summary = stt.solve(
        SolverOptions(linear_solver_type=LinearSolverType.CGNR,
                      max_num_iterations=max_iterations, device=device),
        problem,
    )
    return np.asarray(pixels.values).reshape(side, side), summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=64)
    ap.add_argument("--sigma", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    clean = make_image(args.side)
    rng = np.random.default_rng(args.seed)
    noisy = clean + rng.normal(0.0, args.sigma, clean.shape)

    restored, summary = denoise(noisy, args.sigma, device=args.device)
    print(summary.brief_report())
    err_noisy = float(np.sqrt(np.mean((noisy - clean) ** 2)))
    err_restored = float(np.sqrt(np.mean((restored - clean) ** 2)))
    print(f"rmse noisy:    {err_noisy:.4f}")
    print(f"rmse restored: {err_restored:.4f}")
    return err_noisy, err_restored


if __name__ == "__main__":
    main()
