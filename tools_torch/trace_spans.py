#!/usr/bin/env python3
"""Where one BA solve spends its time, by the port's own spans.

    python3 tools_torch/trace_spans.py                     # venice-1778 shape, DENSE_SCHUR, float64
    python3 tools_torch/trace_spans.py --linear_solver ITERATIVE_SCHUR
    python3 tools_torch/trace_spans.py --num_cameras 49 --num_points 7776 --obs_per_point 4 \
        --device_loop
    python3 tools_torch/trace_spans.py --device cpu --num_cameras 8 --num_points 200

Builds a synthetic BAL scene (``io/bal.py:synthetic_bal``), solves a small
scene of its kind once (kernels built, the process's one-time set-up
paid), then runs one whole solve, from ``Problem`` to the written-back
parameters, under ``torch.profiler`` (CPU and, on a card, CUDA activity).
A solve runs to Ceres's default tolerances, capped at ``--iters`` LM
steps. ``SolverOptions.trace_dir`` traces ``minimize()`` alone; this
traces the plans and the capture too.

For each ``skeres.*`` span (``skeres_tpu_torch/utils/trace.py``) it prints
one ``[trace_spans] span {...}`` line, in the order the spans first
opened: ``count``, ``host_s`` (the summed length on the host's clock) and
``device_s``, the device time of the kernels, copies and sets launched
while the span was open on its thread, matched by the profiler's
correlation ids. A span holds its children's time. The kernels of a
CUDA graph's replay carry no launch the trace can match, so the device
loop's ``skeres.device_loop.chunk`` holds its fetch alone: the device
loop's stamps time the replays (``Summary``). The last line is JSON:
``spans``, the solve's Summary figures and the card.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools_torch import bench_common as common  # noqa: E402

TAG = "trace_spans"
PREFIX = "skeres."


def _ns(ev, name: str) -> int:
    """``start`` or ``duration`` of a kineto event in ns, on torch versions
    that give microseconds only too."""
    if hasattr(ev, f"{name}_ns"):
        return getattr(ev, f"{name}_ns")()
    return int(getattr(ev, f"{name}_us")() * 1000)


def _is_launch(name: str) -> bool:
    """A CUDA runtime or driver call, which launches or copies."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def span_table(events) -> dict:
    """``{name: {"count", "host_s", "device_s"}}`` for every ``skeres.*``
    span among ``events`` (``prof.profiler.kineto_results.events()``),
    in the order the spans first opened. A device event named like a span
    (a range's copy on the device's timeline) counts as no device time."""
    spans = collections.defaultdict(list)  # name -> [(start, end, thread)]
    launches = {}  # correlation id -> (host time, thread)
    device = []  # (correlation id, ns)
    for ev in events:
        name, start = ev.name(), _ns(ev, "start")
        if ev.device_type().name == "CUDA":
            if not name.startswith(PREFIX):
                device.append((ev.correlation_id(), _ns(ev, "duration")))
        elif name.startswith(PREFIX):
            spans[name].append((start, start + _ns(ev, "duration"), ev.start_thread_id()))
        elif _is_launch(name):
            launches[ev.correlation_id()] = (start, ev.start_thread_id())
    device_ns = collections.defaultdict(int)
    for name, ranges in spans.items():
        by_thread = collections.defaultdict(list)
        for lo, hi, thread in sorted(ranges):
            by_thread[thread].append((lo, hi))
        starts = {t: [lo for lo, _ in r] for t, r in by_thread.items()}
        for corr, ns in device:
            at = launches.get(corr)
            if at is None or at[1] not in by_thread:
                continue
            k = bisect.bisect_right(starts[at[1]], at[0]) - 1
            if k >= 0 and at[0] <= by_thread[at[1]][k][1]:
                device_ns[name] += ns
    order = sorted(spans, key=lambda name: min(lo for lo, _, _ in spans[name]))
    return {name: {"count": len(spans[name]),
                   "host_s": sum(hi - lo for lo, hi, _ in spans[name]) * 1e-9,
                   "device_s": device_ns[name] * 1e-9} for name in order}


def solver_options(args, device, dtype):
    from skeres_tpu_torch.core.options import SolverOptions
    from skeres_tpu_torch.core.types import LinearSolverType, PreconditionerType

    return SolverOptions(
        linear_solver_type=LinearSolverType[args.linear_solver],
        preconditioner_type=PreconditionerType[args.preconditioner],
        max_num_iterations=args.iters,
        evaluation_chunk_size=args.chunk,
        use_device_loop=args.device_loop,
        device_loop_chunk_iterations=args.device_loop_chunk,
        dtype=dtype,
        device=device,
    )


def run(args) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal

    device, dtype = common.resolve_device(args)
    info = common.device_info(device)
    print(f"device: {json.dumps(info)}", flush=True)
    common.build_kernels(device, TAG)
    options = solver_options(args, device, dtype)
    common.warm_up(TAG, options, build_bal_problem(synthetic_bal(
        num_cameras=8, num_points=200, observations_per_point=args.obs_per_point))[0])
    bal = synthetic_bal(num_cameras=args.num_cameras, num_points=args.num_points,
                        observations_per_point=args.obs_per_point)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        problem, _, _ = build_bal_problem(bal)
        summary = common.timed_solve(TAG, args.linear_solver, options, problem)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    spans = span_table(prof.profiler.kineto_results.events())
    for name, row in spans.items():
        print(f"[{TAG}] span {json.dumps({'name': name, **row})}", flush=True)
    return {
        "spans": spans,
        "solve": {
            "steps": summary.num_successful_steps + summary.num_unsuccessful_steps,
            "linear_solves": summary.num_linear_solves,
            "device_loop_replays": summary.num_device_loop_replays,
            "preprocessor_s": summary.preprocessor_time_in_seconds,
            "minimizer_s": summary.minimizer_time_in_seconds,
            "total_s": summary.total_time_in_seconds,
            "linear_solver_s": summary.linear_solver_time_in_seconds,
            "residual_evaluation_s": summary.residual_evaluation_time_in_seconds,
            "jacobian_evaluation_s": summary.jacobian_evaluation_time_in_seconds,
            "path": summary.schur_complement_path,
            "final_cost": summary.final_cost,
        },
        "device": info,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_cameras", type=int, default=1778)
    ap.add_argument("--num_points", type=int, default=1_000_000)
    ap.add_argument("--obs_per_point", type=int, default=5)
    ap.add_argument("--iters", type=int, default=50, help="max_num_iterations")
    ap.add_argument("--chunk", type=int, default=262_144, help="evaluation_chunk_size")
    ap.add_argument("--linear_solver", default="DENSE_SCHUR")
    ap.add_argument("--preconditioner", default="SCHUR_JACOBI")
    ap.add_argument("--device_loop", action="store_true")
    ap.add_argument("--device_loop_chunk", type=int, default=25,
                    help="device_loop_chunk_iterations")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="float64", choices=("float32", "float64"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
