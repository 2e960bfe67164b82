#!/usr/bin/env python3
"""Multi-signature Schur benchmark: the cost of the bundle-adjustment
variants that leave the single-signature camera-padded path, on one card.

PyTorch counterpart of ``tools/bench_two_signature.py``, with its flags,
defaults, options and JSON keys (plus ``extra.device``: the card's name and
power limit, or ``"cpu"``). Three problems at the same observation count,
ITERATIVE_SCHUR with SCHUR_JACOBI, a fixed 6 steps each:

  plain       one signature (camera, point): past 100,000 rows it takes
              the camera-padded layout
  prior       plain + a per-camera prior batch (a second signature; the
              observation batch keeps its padded layout, the priors take
              the generic gather path)
  split       pose (6) and intrinsics (3) as separate blocks: the
              observation batch has two retained slots, so the Schur
              solver takes the general structure

Each variant prints its result line and its ``Summary.camera_padded_layout``.
The JAX script has no warm-up solve: the kernels are built, and each
variant is solved once on a small scene (8 cameras, 200 points), before
the timed solves, so that neither ``nvcc`` nor the process's one-time
set-up lands in their seconds. No kernel runs on these paths.

    python3 tools_torch/bench_two_signature.py --num_points 200000
    python3 tools_torch/bench_two_signature.py --num_cameras 1778 \
        --num_points 1000000   # venice scale
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools_torch import bench_common as common  # noqa: E402
from skeres_tpu_torch.ops import rotation as rot  # noqa: E402

TAG = "bench_two_signature"


def camera_prior(params, data):
    (cam,) = params
    return 0.1 * (cam - data)


def split_reproj(params, observation):
    """The Snavely residual of (pose (6), intrinsics (f, k1, k2), point)."""
    pose, k, point = params
    p = rot.angle_axis_rotate_point(pose[0:3], point) + pose[3:6]
    xp = -p[0] / p[2]
    yp = -p[1] / p[2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (k[1] + k[2] * r2)
    return torch.stack([
        k[0] * distortion * xp - observation[0],
        k[0] * distortion * yp - observation[1],
    ])


def make_plain(bal):
    from skeres_tpu_torch.io.bal import build_bal_problem

    problem, _, _ = build_bal_problem(bal)
    return problem


def make_prior(bal):
    from skeres_tpu_torch.io.bal import build_bal_problem

    problem, cameras, _ = build_bal_problem(bal)
    problem.add_residual_blocks(
        camera_prior,
        None,
        [(cameras, np.arange(bal.num_cameras, dtype=np.int32))],
        data=bal.cameras.copy(),
        name="camera_prior",
    )
    return problem


def make_split(bal):
    """Pose (angle-axis + translation) and intrinsics (f, k1, k2) as
    separate parameter blocks: two retained slots a row."""
    from skeres_tpu_torch.core.problem import Problem

    problem = Problem()
    poses = problem.add_parameter_block_array(bal.cameras[:, :6].copy(), name="poses")
    intr = problem.add_parameter_block_array(bal.cameras[:, 6:].copy(), name="intrinsics")
    points = problem.add_parameter_block_array(bal.points, name="points")
    problem.set_schur_elimination_group(points, 0)
    problem.set_schur_elimination_group(poses, 1)
    problem.set_schur_elimination_group(intr, 1)
    problem.add_residual_blocks(
        split_reproj,
        None,
        [
            (poses, bal.camera_index),
            (intr, bal.camera_index),
            (points, bal.point_index),
        ],
        data=bal.observations,
        name="split_snavely",
    )
    return problem


MAKERS = {"plain": make_plain, "prior": make_prior, "split": make_split}


def solver_options(args, device, dtype):
    """``tools/bench_two_signature.py``'s options, field by field."""
    from skeres_tpu_torch.core.options import SolverOptions
    from skeres_tpu_torch.core.types import LinearSolverType, PreconditionerType

    return SolverOptions(
        linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=PreconditionerType.SCHUR_JACOBI,
        max_num_iterations=args.iters,
        evaluation_chunk_size=args.chunk,
        function_tolerance=0.0,
        gradient_tolerance=0.0,
        parameter_tolerance=0.0,
        dtype=dtype,
        device=device,
    )


def run(args) -> dict:
    from skeres_tpu_torch.io.bal import synthetic_bal

    device, dtype = common.resolve_device(args)
    info = common.device_info(device)
    print(f"device: {json.dumps(info)}", flush=True)
    common.build_kernels(device, TAG)
    bal = synthetic_bal(
        num_cameras=args.num_cameras,
        num_points=args.num_points,
        observations_per_point=args.obs_per_point,
    )
    print(f"{bal.num_cameras} cams / {bal.num_points} pts / "
          f"{bal.num_observations} obs", flush=True)

    small = synthetic_bal(num_cameras=8, num_points=200,
                          observations_per_point=args.obs_per_point)
    for name in args.variants:
        common.warm_up(TAG, solver_options(args, device, dtype), MAKERS[name](small))
    results = {}
    for name in args.variants:
        t0 = time.time()
        problem = MAKERS[name](bal)
        summary = common.timed_solve(TAG, name, solver_options(args, device, dtype), problem)
        steps = summary.num_successful_steps + summary.num_unsuccessful_steps
        secs = summary.minimizer_time_in_seconds
        results[name] = {
            "sec_per_step": round(secs / max(steps, 1), 4),
            "linear_solver_sec": round(
                summary.linear_solver_time_in_seconds / max(steps, 1), 4
            ),
            "final_cost": float(summary.final_cost),
            "wall_incl_compile": round(time.time() - t0, 1),
        }
        print(f"[{TAG}] {name} camera_padded_layout: {summary.camera_padded_layout}", flush=True)
        print(json.dumps({name: results[name]}), flush=True)

    base = results.get("plain", {}).get("sec_per_step")
    return {
        "metric": "two_signature_step_time",
        "value": results.get("split", {}).get("sec_per_step"),
        "unit": "sec/step (split-intrinsics generic fallback)",
        "extra": {"results": results, "vs_plain": (
            round(results["split"]["sec_per_step"] / base, 2)
            if base and "split" in results else None
        ), "device": info},
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_cameras", type=int, default=49)
    ap.add_argument("--num_points", type=int, default=200_000)
    ap.add_argument("--obs_per_point", type=int, default=5)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--chunk", type=int, default=262_144)
    ap.add_argument("--variants", nargs="+",
                    default=["plain", "prior", "split"])
    common.add_device_flags(ap)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
