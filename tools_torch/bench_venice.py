#!/usr/bin/env python3
"""Venice-scale bundle adjustment on one card (BASELINE.md config 5).

PyTorch counterpart of ``tools/bench_venice.py``, with its flags, defaults,
options and JSON keys (``extra.backend`` becomes ``extra.device``; the
memory is ``torch.cuda.max_memory_allocated`` and the card's total):

    python3 tools_torch/bench_venice.py                    # full venice scale, on the card
    python3 tools_torch/bench_venice.py --num_cameras 200 --num_points 100000
    python3 tools_torch/bench_venice.py --linear_solver DENSE_SCHUR --iters 5
    python3 tools_torch/bench_venice.py --device cpu --dtype float64 --num_cameras 8 \
        --num_points 200

Synthetic BAL at venice-1778 scale (1778 cameras, 1M points, 5M
observations, the Snavely camera model), solved with ITERATIVE_SCHUR +
SCHUR_JACOBI and streamed (chunked) evaluation for a fixed 10 steps;
records LM steps/s and peak device memory. The JAX script has no warm-up
solve: the kernels are built, and a small scene (8 cameras, 200 points) is
solved with the same options, before the timed solve, so that neither
``nvcc`` nor the process's one-time set-up lands in its seconds. The default
implicit path launches no kernel; ``--explicit_schur`` launches K3 once a
damped solve; ``--linear_solver DENSE_SCHUR`` launches K3 once and K2 (K1
panels and trailing updates) once a damped solve and a jitter rung.

``vs_baseline``: the measured scipy stand-in at a third of venice
(``BASELINE_MEASURED_VENICE_THIRD.json``, read, never written),
extrapolated O(obs) to this run's scale. The solve's report comes before
the JSON result, which is the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools_torch import bench_common as common  # noqa: E402

TAG = "bench_venice"
BASELINE = os.path.join(common.ROOT, "BASELINE_MEASURED_VENICE_THIRD.json")


def solver_options(args, device, dtype):
    """``tools/bench_venice.py``'s options, field by field."""
    from skeres_tpu_torch.core.options import SolverOptions
    from skeres_tpu_torch.core.types import LinearSolverType, PreconditionerType

    return SolverOptions(
        linear_solver_type=LinearSolverType[args.linear_solver],
        preconditioner_type=PreconditionerType[args.preconditioner],
        max_num_iterations=args.iters,
        evaluation_chunk_size=args.chunk,
        max_linear_solver_iterations=args.max_cg_iterations,
        use_device_loop=args.device_loop,
        device_loop_chunk_iterations=args.iters,
        function_tolerance=args.function_tolerance,
        gradient_tolerance=0.0,
        parameter_tolerance=0.0,
        # with ftol zeroed this is a throughput run: every termination test
        # off, so that the denominator is the full budget
        run_full_iteration_budget=(args.function_tolerance == 0.0),
        use_explicit_schur_complement=args.explicit_schur,
        minimizer_progress_to_stdout=not args.device_loop,
        detailed_step_timings=False,
        dtype=dtype,
        device=device,
    )


def run(args) -> dict:
    import torch

    from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal

    device, dtype = common.resolve_device(args)
    info = common.device_info(device)
    print(f"device: {json.dumps(info)}", flush=True)
    common.build_kernels(device, TAG)
    t0 = time.time()
    bal = synthetic_bal(
        num_cameras=args.num_cameras,
        num_points=args.num_points,
        observations_per_point=args.obs_per_point,
    )
    print(
        f"generated {bal.num_cameras} cams / {bal.num_points} pts / "
        f"{bal.num_observations} obs in {time.time()-t0:.1f}s",
        flush=True,
    )

    options = solver_options(args, device, dtype)
    common.warm_up(TAG, options, build_bal_problem(synthetic_bal(
        num_cameras=8, num_points=200, observations_per_point=args.obs_per_point))[0])
    t0 = time.time()
    problem, _, _ = build_bal_problem(bal)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    summary = common.timed_solve(TAG, args.linear_solver, options, problem)
    total = time.time() - t0
    steps = summary.num_successful_steps + summary.num_unsuccessful_steps
    secs = summary.minimizer_time_in_seconds

    mem = {}
    if device.type == "cuda":
        mem = {
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
            "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
        }

    out = {
        "metric": "venice_lm_steps_per_sec",
        "value": round(steps / secs, 4) if secs else None,
        "unit": "iter/s",
        "extra": {
            "cams": bal.num_cameras,
            "points": bal.num_points,
            "obs": bal.num_observations,
            "steps": int(steps),
            "minimizer_seconds": round(secs, 2),
            "wall_seconds_incl_compile": round(total, 2),
            "initial_cost": float(summary.initial_cost),
            "final_cost": float(summary.final_cost),
            "termination": str(summary.termination_type),
            "memory": mem,
            "device": info,
        },
    }
    # config-5 denominator: the measured scipy stand-in at 1/3 venice,
    # extrapolated O(obs) to this run's scale (weak, clearly labeled)
    if os.path.exists(BASELINE) and out["value"]:
        with open(BASELINE) as f:
            base = json.load(f)
        base_sps = base["steps_per_sec"] * (
            base["scale_vs_venice"] * 5_000_000.0 / max(bal.num_observations, 1)
        )
        out["vs_baseline"] = round(out["value"] / base_sps, 1)
        out["extra"]["baseline"] = {
            "solver": base["solver"] + " [extrapolated O(obs) from 1/3 scale]",
            "steps_per_sec": base_sps,
        }
    print(summary.full_report(), flush=True)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_cameras", type=int, default=1778)
    ap.add_argument("--num_points", type=int, default=1_000_000)
    ap.add_argument("--obs_per_point", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=262_144)
    ap.add_argument("--max_cg_iterations", type=int, default=100)
    ap.add_argument("--device_loop", action="store_true")
    ap.add_argument("--linear_solver", default="ITERATIVE_SCHUR")
    ap.add_argument("--preconditioner", default="SCHUR_JACOBI")
    ap.add_argument("--explicit_schur", action="store_true",
                    help="use_explicit_schur_complement (ITERATIVE_SCHUR)")
    ap.add_argument("--function_tolerance", type=float, default=0.0,
                    help="nonzero: run to convergence instead of the fixed "
                         "step budget")
    common.add_device_flags(ap)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
