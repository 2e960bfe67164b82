#!/usr/bin/env python3
"""Sharding-overhead harness: LM-step time on a FIXED problem at 1/2/4/8
shards of the ``obs`` mesh.

PyTorch counterpart of ``tools/bench_scaling.py``, with its flags,
defaults, options and JSON keys (``extra.backend`` becomes
``extra.device``: the card's name and power limit, or ``"cpu"``).
ITERATIVE_SCHUR on the host loop, 6 steps, all tolerances 0; a warm-up
solve before each measured one.

One shard is a solve in this process without a mesh, as the JAX script's.
``n`` shards are ``n`` processes of this script on gloo
(``skeres_tpu_torch/parallel/dryrun.py:run_ranks``, a file store;
``parallel/mesh.py:initialize_distributed`` and ``make_obs_mesh``), each
building the whole problem and holding its rows, all on the one device:
on the card the ranks share it (gloo through the host; NCCL wants a card a
rank, and the device loop refuses gloo on the card), so the rows measure
the sharded program's overhead, not a multi-GPU rate. ``--device cpu``
runs the ranks on the CPU, one torch thread each, as the JAX script's
virtual CPU devices. Each rank reports its Summary; rank 0's numbers are
printed, and every rank's final cost must equal rank 0's. A spawn that
fails or outlasts its timeout raises: no partial table is returned.

With the total problem fixed, the ideal trace is flat step time. The
second line (the weak-scaling proxy) is one device solving a 1/n-size
problem against n shards solving the full problem, equal load a shard.

    python3 tools_torch/bench_scaling.py --points 16000
    python3 tools_torch/bench_scaling.py --device cpu --dtype float64 --points 400 \
        --cameras 8 --shards 1 2
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools_torch import bench_common as common  # noqa: E402

TAG = "bench_scaling"
RANK_TIMEOUT = 600.0  # seconds the ranks of one shard count may take


def solver_options(args, device, dtype, mesh=None):
    """``tools/bench_scaling.py``'s options, field by field."""
    from skeres_tpu_torch.core.options import SolverOptions
    from skeres_tpu_torch.core.types import LinearSolverType

    return SolverOptions(
        linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
        max_num_iterations=args.iters,
        mesh=mesh,
        function_tolerance=0.0,
        gradient_tolerance=0.0,
        parameter_tolerance=0.0,
        dtype=dtype,
        device=device,
    )


def measure(args, bal, device, dtype, shards, mesh=None, label=None) -> dict:
    """A warm-up solve, then the measured one: its row of the table."""
    from skeres_tpu_torch.io.bal import build_bal_problem

    options = solver_options(args, device, dtype, mesh)
    label = label or f"shards {shards}"
    common.timed_solve(TAG, f"{label}, warm-up", options, build_bal_problem(bal)[0])
    summary = common.timed_solve(TAG, label, options, build_bal_problem(bal)[0])
    steps = summary.num_successful_steps + summary.num_unsuccessful_steps
    secs = summary.minimizer_time_in_seconds
    return {
        "shards": shards,
        "steps": int(steps),
        "sec_per_step": round(secs / max(steps, 1), 4),
        "final_cost": float(summary.final_cost),
    }


def scene(args, num_points=None):
    from skeres_tpu_torch.io.bal import synthetic_bal

    return synthetic_bal(
        num_cameras=args.cameras,
        num_points=args.points if num_points is None else num_points,
        observations_per_point=args.obs_per_point,
    )


def rank_main(args) -> dict:
    """One rank of ``args.world``: the row of the sharded solve."""
    import torch

    from skeres_tpu_torch.parallel.mesh import initialize_distributed, make_obs_mesh

    if args.device == "cpu":
        torch.set_num_threads(1)
    device, dtype = common.resolve_device(args)
    initialize_distributed(f"file://{args.store}", args.world, args.rank, backend="gloo",
                           device_type=device.type)
    mesh = make_obs_mesh(device_type=device.type)
    return measure(args, scene(args), device, dtype, args.world, mesh)


def sharded_row(args, n: int) -> dict:
    """``n`` ranks of this script; rank 0's row, every rank's final cost
    equal to rank 0's."""
    from skeres_tpu_torch.parallel.dryrun import run_ranks

    flags = ["--points", str(args.points), "--cameras", str(args.cameras),
             "--obs_per_point", str(args.obs_per_point), "--iters", str(args.iters),
             "--device", args.device, "--dtype", args.dtype]
    env = dict(os.environ)
    env["PYTHONPATH"] = common.ROOT + os.pathsep + env.get("PYTHONPATH", "")
    outs = run_ranks(lambda store, r: [
        sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world", str(n),
        "--store", store, *flags], n, RANK_TIMEOUT, env=env, cwd=common.ROOT)
    rows = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    costs = [row["final_cost"] for row in rows]
    if any(c != costs[0] for c in costs):
        raise RuntimeError(f"{n} shards: the ranks' final costs differ: {costs}")
    for line in outs[0].splitlines()[:-1]:  # rank 0's solve lines
        print(line, flush=True)
    return rows[0]


def run(args) -> dict:
    """The strong-scaling rows and line, then the weak-scaling proxy:
    ``{"strong": ..., "weak": ...}``, the two JSON lines."""
    device, dtype = common.resolve_device(args)
    info = common.device_info(device)
    print(f"device: {json.dumps(info)}", flush=True)
    common.build_kernels(device, TAG)
    bal = scene(args)

    results = []
    for n in args.shards:
        results.append(measure(args, bal, device, dtype, 1) if n == 1 else sharded_row(args, n))
        print(json.dumps(results[-1]), flush=True)

    base = results[0]["sec_per_step"]
    strong = {
        "metric": "strong_scaling_step_time_ratio",
        "value": round(results[-1]["sec_per_step"] / base, 3),
        "unit": "x (8-shard/1-shard, fixed problem; 1.0 = no sharding overhead)",
        "extra": {
            "rows": results,
            "obs": bal.num_observations,
            "device": info,
            "physical_cpus": os.cpu_count(),
        },
    }
    print(json.dumps(strong), flush=True)

    # weak-scaling proxy: one device solving a 1/ns-size problem against
    # ns shards solving the full problem, equal load a shard
    ns = args.shards[-1]
    small = scene(args, args.points // ns)
    small_row = measure(args, small, device, dtype, 1, label=f"1/{ns} problem")
    small_per_step = small_row["sec_per_step"]
    weak = {
        "metric": "weak_scaling_step_time_ratio",
        "value": round(results[-1]["sec_per_step"] / small_per_step, 3),
        "unit": (
            f"x ({ns}-shard full problem / 1-device 1/{ns} problem; equal "
            "per-shard load; 1.0 = free sharding)"
        ),
        "extra": {
            "small_sec_per_step": small_per_step,
            "sharded_sec_per_step": results[-1]["sec_per_step"],
            "small_obs": small.num_observations,
            "device": info,
        },
    }
    return {"strong": strong, "weak": weak}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=16000)
    ap.add_argument("--cameras", type=int, default=64)
    ap.add_argument("--obs_per_point", type=int, default=4)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    common.add_device_flags(ap)
    # a rank of a sharded row (started by sharded_row)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.rank is not None:
        print(json.dumps(rank_main(args)), flush=True)
        import torch.distributed as dist

        dist.destroy_process_group()
        return 0
    out = run(args)
    print(json.dumps(out["weak"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
