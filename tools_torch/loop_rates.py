#!/usr/bin/env python3
"""LM steps/s of the port's LM loops on one CUDA card (or the CPU), for one checkout.

    python3 tools_torch/loop_rates.py --root DIR [--loops host,device] [--runs 5] [--venice]
                                      [--device cpu] [--linear-solver ITERATIVE_SCHUR]
                                      [--preconditioner SCHUR_JACOBI]

Imports ``skeres_tpu_torch`` from the checkout at DIR (this one, or an
earlier commit unpacked with ``git archive``), then solves synthetic BAL-49
in float32 (30 LM steps, the full iteration budget; the device loop in one
chunk of 30, as ``bench.py``) ``--runs`` times with each loop of
``--loops``, the loops in turns; with ``--venice`` also the venice-1778
shape scene (5 steps, evaluation chunks of 262,144 rows) once with each
loop. ``--linear-solver`` and ``--preconditioner`` (the enums' names;
DENSE_SCHUR and JACOBI unless given) choose the damped solve, so that an
iterative solve can be held against an earlier commit too; the record then
carries the summed linear-solver (PCG) iterations of each run. Prints the
card's name and power limit, then one JSON line: LM
steps/s, the preprocessor's seconds and the Summary's evaluation and
linear-solver seconds of every run, by scene and loop.
``--device cpu`` runs the same on the CPU (plain kernel versions), where
the host's own work per step can be compared without the card.

To compare two checkouts, run it for each in turns (A, B, B, A), each a
process of its own: both packages have one name.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout to import skeres_tpu_torch from")
    ap.add_argument("--loops", default="host", help="comma-separated: host, device")
    ap.add_argument("--runs", type=int, default=5, help="BAL-49 runs of each loop")
    ap.add_argument("--venice", action="store_true", help="also one venice-shape run a loop")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--linear-solver", default="DENSE_SCHUR", help="a LinearSolverType name")
    ap.add_argument("--preconditioner", default="JACOBI", help="a PreconditionerType name")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("loop_rates: no CUDA device", file=sys.stderr)
        return 1
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.types import LinearSolverType, PreconditionerType
    from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal

    check = os.path.join(root, "skeres_tpu_torch")
    if not os.path.dirname(stt.__file__).startswith(check):
        print(f"loop_rates: imported {stt.__file__}, not from {root}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = "cpu" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[loop_rates] {smi}; torch {torch.__version__}; root {root}", flush=True)

    loops = args.loops.split(",")
    loop_options = {"host": {}, "device": {"use_device_loop": True}}

    def options(loop, steps, **kw):
        extra = dict(loop_options[loop])
        if extra:
            extra["device_loop_chunk_iterations"] = steps
        return stt.SolverOptions(
            linear_solver_type=LinearSolverType[args.linear_solver],
            preconditioner_type=PreconditionerType[args.preconditioner], max_num_iterations=steps,
            run_full_iteration_budget=True, dtype=torch.float32, device=args.device, **extra, **kw)

    def record(out, loop, s):
        steps = s.num_successful_steps + s.num_unsuccessful_steps
        out[loop]["lm_steps_per_s"].append(steps / s.minimizer_time_in_seconds)
        out[loop]["preprocessor_s"].append(s.preprocessor_time_in_seconds)
        out[loop]["final_cost"].append(s.final_cost)
        out[loop]["linear_solver_iterations"].append(
            sum(it.linear_solver_iterations for it in s.iterations))
        for key in ("jacobian_evaluation", "linear_solver", "residual_evaluation"):
            out[loop][key + "_s"].append(getattr(s, key + "_time_in_seconds"))

    def empty():
        keys = ("lm_steps_per_s", "preprocessor_s", "final_cost", "linear_solver_iterations",
                "jacobian_evaluation_s",
                "linear_solver_s", "residual_evaluation_s")
        return {loop: {key: [] for key in keys} for loop in loops}

    result = {"root": root, "device": smi, "linear_solver": args.linear_solver,
              "preconditioner": args.preconditioner, "bal49": empty()}
    bal = synthetic_bal(49, 7776, 4)
    for loop in loops:  # warm-up: first-call set-up and the kernels' build
        stt.solve(options(loop, 2), build_bal_problem(bal)[0])
    for _ in range(args.runs):
        for loop in loops:
            record(result["bal49"], loop, stt.solve(options(loop, 30), build_bal_problem(bal)[0]))
    if args.venice:
        result["venice"] = empty()
        problem = build_bal_problem(synthetic_bal(1778, 1_000_000, 5))[0]
        program = problem.compile()
        initial = [g.values.copy() for g in program.groups]
        for loop in loops:
            for g, v in zip(program.groups, initial):  # each solve writes its solution back
                g.values = v.copy()
            record(result["venice"], loop,
                   stt.solve(options(loop, 5, evaluation_chunk_size=262_144), problem, program))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
