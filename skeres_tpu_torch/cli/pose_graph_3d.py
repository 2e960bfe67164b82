#!/usr/bin/env python
"""3D pose-graph SLAM (reference: ``examples/slam/pose_graph_3d``).

Counterpart of ``skeres_tpu/cli/pose_graph_3d.py``: reads a g2o file
(``--input``) or generates a synthetic sphere graph (the stand-in for
sphere2500), solves it with quaternion manifolds on ``--device`` (the card
by default), and reports the initial and final chi^2.
"""

import argparse

import numpy as np

import skeres_tpu_torch as stt
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.types import LinearSolverType
from skeres_tpu_torch.io.g2o import build_pose_graph_problem, load_g2o, synthetic_sphere


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default=None, help="g2o file (3D)")
    ap.add_argument("--num_poses", type=int, default=2500)
    ap.add_argument("--linear_solver", default="CGNR")
    ap.add_argument("--max_iterations", type=int, default=100)
    ap.add_argument("--output", default=None, help="write optimized poses")
    ap.add_argument("--device", default="cuda", help="torch device to solve on")
    args = ap.parse_args(argv)

    graph = load_g2o(args.input) if args.input else synthetic_sphere(num_poses=args.num_poses)
    print(f"pose graph: {len(graph.poses)} poses, {len(graph.edges)} constraints")
    problem, poses = build_pose_graph_problem(graph)
    options = SolverOptions(
        linear_solver_type=LinearSolverType[args.linear_solver],
        max_num_iterations=args.max_iterations,
        minimizer_progress_to_stdout=True,
        device=args.device,
    )
    summary = stt.solve(options, problem)
    print(summary.full_report())
    if args.output:
        np.savetxt(args.output, poses.values)
        print(f"wrote {args.output}")
    return summary


if __name__ == "__main__":
    main()
