#!/usr/bin/env python3
"""sphere2500-class pose-graph benchmark (BASELINE.md config 3) on one card.

PyTorch counterpart of ``tools/bench_sphere.py``, with its flags, defaults,
options and JSON keys (plus ``extra.device``: the card's name and power
limit, or ``"cpu"``). Solves the synthetic sphere (2500 SE(3) poses,
odometry + loop closures, structurally the reference's sphere2500) with
CGNR and all tolerances 0, after a warm-up solve of the same length, and
records LM steps/s and the final chi^2 (twice the cost). No kernel runs
on this path.

    python3 tools_torch/bench_sphere.py [--num_poses 2500] [--iters 30]
    python3 tools_torch/bench_sphere.py --device cpu --dtype float64 --num_poses 50
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools_torch import bench_common as common  # noqa: E402

TAG = "bench_sphere"


def solver_options(n_iters, device, dtype):
    """``tools/bench_sphere.py``'s options, field by field."""
    from skeres_tpu_torch.core.options import SolverOptions
    from skeres_tpu_torch.core.types import LinearSolverType

    return SolverOptions(
        linear_solver_type=LinearSolverType.CGNR,
        max_num_iterations=n_iters,
        function_tolerance=0.0,
        gradient_tolerance=0.0,
        parameter_tolerance=0.0,
        dtype=dtype,
        device=device,
    )


def run(args) -> dict:
    from skeres_tpu_torch.io.g2o import build_pose_graph_problem, synthetic_sphere

    device, dtype = common.resolve_device(args)
    info = common.device_info(device)
    print(f"device: {json.dumps(info)}", flush=True)
    common.build_kernels(device, TAG)
    graph = synthetic_sphere(num_poses=args.num_poses)

    def solve(label):
        problem, _ = build_pose_graph_problem(graph)
        return common.timed_solve(TAG, label, solver_options(args.iters, device, dtype), problem)

    solve("warm-up")
    summary = solve("run")
    steps = summary.num_successful_steps + summary.num_unsuccessful_steps
    secs = summary.minimizer_time_in_seconds
    return {
        "metric": "sphere_pose_graph_lm_steps_per_sec",
        "value": round(steps / secs, 3) if secs else None,
        "unit": "iter/s",
        "extra": {
            "poses": args.num_poses,
            "edges": len(graph.edges),
            "steps": int(steps),
            "minimizer_seconds": round(secs, 2),
            "initial_chi2": float(2 * summary.initial_cost),
            "final_chi2": float(2 * summary.final_cost),
            "termination": str(summary.termination_type),
            "device": info,
        },
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_poses", type=int, default=2500)
    ap.add_argument("--iters", type=int, default=30)
    common.add_device_flags(ap)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
