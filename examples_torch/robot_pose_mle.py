#!/usr/bin/env python
"""1-D robot localization by maximum likelihood (counterpart of
``examples/robot_pose_mle.py``; reference lineage:
``examples/robot_pose_mle.cc``): a robot moves down a corridor taking
noisy unit steps and noisy range readings to the far wall. The MLE
couples every pose through two residual families:

- odometry: (x_t - x_{t-1} - odom_t) / odom_stddev, one per step;
- range:    (wall - x_t - range_t) / range_stddev, one per reading.

    python -m examples_torch.robot_pose_mle [--steps 100] [--device cpu]
"""

import argparse

import numpy as np

import skeres_tpu_torch as stt
from skeres_tpu_torch.core.options import SolverOptions

CORRIDOR_LENGTH = 30.0
STEP = 1.0
ODOM_STDDEV = 0.1
RANGE_STDDEV = 0.01


def simulate(num_steps: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    true_pos = np.cumsum(np.full(num_steps, STEP))
    odometry = STEP + rng.normal(0, ODOM_STDDEV, num_steps)
    ranges = CORRIDOR_LENGTH - true_pos + rng.normal(0, RANGE_STDDEV, num_steps)
    return true_pos, odometry, ranges


def solve_mle(odometry: np.ndarray, ranges: np.ndarray, device="cuda"):
    n = len(odometry)
    problem = stt.Problem()
    # initial guess: dead reckoning from odometry alone
    guess = np.cumsum(odometry).reshape(-1, 1)
    poses = problem.add_parameter_block_array(guess, name="poses")

    def odom_resid(params, data):
        xt, xp = params
        return (xt - xp - data) / ODOM_STDDEV

    # steps 1..n-1 couple consecutive poses; step 0 is from the origin
    problem.add_residual_blocks(
        odom_resid,
        None,
        [(poses, np.arange(1, n)), (poses, np.arange(0, n - 1))],
        data=odometry[1:].reshape(-1, 1),
        name="odometry",
    )

    def first_odom(params, data):
        (x0,) = params
        return (x0 - data) / ODOM_STDDEV

    problem.add_residual_blocks(
        first_odom, None, [(poses, np.array([0]))],
        data=odometry[:1].reshape(-1, 1), name="odometry0",
    )

    def range_resid(params, data):
        (xt,) = params
        return (CORRIDOR_LENGTH - xt - data) / RANGE_STDDEV

    problem.add_residual_blocks(
        range_resid, None, [(poses, np.arange(n))],
        data=ranges.reshape(-1, 1), name="ranges",
    )

    summary = stt.solve(SolverOptions(max_num_iterations=100, device=device), problem)
    return np.asarray(poses.values).reshape(-1), summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    true_pos, odometry, ranges = simulate(args.steps, args.seed)
    est, summary = solve_mle(odometry, ranges, args.device)
    print(summary.brief_report())
    rmse_dead = float(np.sqrt(np.mean((np.cumsum(odometry) - true_pos) ** 2)))
    rmse_mle = float(np.sqrt(np.mean((est - true_pos) ** 2)))
    print(f"rmse dead-reckoning: {rmse_dead:.4f}")
    print(f"rmse MLE:            {rmse_mle:.4f}")
    return rmse_dead, rmse_mle


if __name__ == "__main__":
    main()
