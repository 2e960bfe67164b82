#!/usr/bin/env python
"""Bundle adjustment on BAL problems — the flagship CLI.

Counterpart of ``skeres_tpu/cli/bundle_adjuster.py`` (reference lineage:
``examples/bundle_adjuster.cc``): loads a BAL file (or generates a
synthetic scene), optionally normalizes and perturbs it, builds the
Snavely reprojection problem with declared camera/point Schur structure,
solves it with the selected linear solver on ``--device`` (the card by
default), prints the full report, and can export a PLY point cloud.

    python -m skeres_tpu_torch.cli.bundle_adjuster --input data/problem-49-7776-pre.txt \
        --linear_solver DENSE_SCHUR --robustify
"""

import argparse

import torch

import skeres_tpu_torch as stt
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.types import LinearSolverType, PreconditionerType
from skeres_tpu_torch.io.bal import build_bal_problem, load_bal, synthetic_bal
from skeres_tpu_torch.ops import rotation as rot


def write_ply(path, bal):
    """Reference: BALProblem::WriteToPLYFile — cameras green, points white.
    The camera centres are ``-R^T t``, computed in float64 on the CPU."""
    aa = torch.as_tensor(bal.cameras[:, 0:3], dtype=torch.float64)
    t = torch.as_tensor(bal.cameras[:, 3:6], dtype=torch.float64)
    centers = (-rot.angle_axis_rotate_point(-aa, t)).numpy()
    n = len(centers) + len(bal.points)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\nelement vertex {}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n".format(n)
        )
        for c in centers:
            f.write(f"{c[0]} {c[1]} {c[2]} 0 255 0\n")
        for p in bal.points:
            f.write(f"{p[0]} {p[1]} {p[2]} 255 255 255\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default=None, help="BAL .txt(.bz2/.gz) file")
    ap.add_argument("--linear_solver", default="DENSE_SCHUR")
    ap.add_argument("--preconditioner", default="SCHUR_JACOBI")
    ap.add_argument("--max_iterations", type=int, default=50)
    ap.add_argument("--robustify", action="store_true", help="Huber(1.0) loss")
    ap.add_argument("--normalize", action="store_true")
    ap.add_argument("--rotation_sigma", type=float, default=0.0)
    ap.add_argument("--translation_sigma", type=float, default=0.0)
    ap.add_argument("--point_sigma", type=float, default=0.0)
    ap.add_argument("--num_cameras", type=int, default=16)
    ap.add_argument("--num_points", type=int, default=2000)
    ap.add_argument("--initial_ply", default=None)
    ap.add_argument("--final_ply", default=None)
    ap.add_argument("--device", default="cuda", help="torch device to solve on")
    args = ap.parse_args(argv)

    if args.input:
        bal = load_bal(args.input)
    else:
        print("no --input given; generating a synthetic BAL scene")
        bal = synthetic_bal(num_cameras=args.num_cameras, num_points=args.num_points)
    if args.normalize:
        bal.normalize()
    if args.rotation_sigma or args.translation_sigma or args.point_sigma:
        bal.perturb(
            rotation_sigma=args.rotation_sigma,
            translation_sigma=args.translation_sigma,
            point_sigma=args.point_sigma,
        )
    print(
        f"BAL problem: {bal.num_cameras} cameras, {bal.num_points} points, "
        f"{bal.num_observations} observations"
    )
    if args.initial_ply:
        write_ply(args.initial_ply, bal)

    loss = stt.HuberLoss(1.0) if args.robustify else None
    problem, cameras, points = build_bal_problem(bal, loss=loss)
    options = SolverOptions(
        linear_solver_type=LinearSolverType[args.linear_solver],
        preconditioner_type=PreconditionerType[args.preconditioner],
        max_num_iterations=args.max_iterations,
        minimizer_progress_to_stdout=True,
        device=args.device,
    )
    summary = stt.solve(options, problem)
    print(summary.full_report())

    if args.final_ply:
        bal.cameras = cameras.values
        bal.points = points.values
        write_ply(args.final_ply, bal)
    return summary


if __name__ == "__main__":
    main()
