"""Readings that set a cell's limits: the program in the cell's own dtype
(the lower readings) and the control, the program with its float32 path
switched on (the upper readings), each held to the float64 reference on
the same scene, at the cell's own size, one solve a seed, all seeds in one
process.

    python benchmark/control.py --workload <cell> --seeds 1 2 3 [--device cuda]

Each seed prints one JSON line: the compared numbers of both runs, and
whether each of the control's numbers passes the cell's limit (none
should: a control that passes every limit is a check that cannot tell
float32 from float64). The benchmark's own runs do not run this.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.pycache_prefix = os.path.join(ROOT, "build", "benchmark", "pycache")
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from benchmark import harness  # noqa: E402

LOWER_DTYPE = {"float64": "float32"}


def readings(cell_name: str, seed: int, device, config_overrides=None) -> dict:
    """One seed: the program at the cell's dtype and at the control's, one
    solve each, and the reference; the compared numbers of both."""
    cell = harness.load_cell(cell_name)
    config = {**cell["config_data"], **(config_overrides or {})}
    scene_mod = harness.load_module("scenes", config["generator"])
    scene = scene_mod.generate(config, seed, device)
    null = lambda name: contextlib.nullcontext()  # noqa: E731
    runs = {}
    for label, dtype in (("program", cell["dtype"]), ("control", LOWER_DTYPE[cell["dtype"]])):
        t0 = time.perf_counter()
        solve = harness.timed_solve(scene_mod, scene, harness.solver_options(cell, device, dtype),
                                    null)
        runs[label] = (solve, time.perf_counter() - t0)
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    reference = scene_mod.make_reference(scene, device)
    path_steps = cell.get("path_accepted_steps")
    ref_out = reference.solve(scene.cameras, scene.points, cell["options"], max_accepted=path_steps)
    out = {"seed": seed, "reference_steps": ref_out["iterations"],
           "reference_accepted": len(ref_out["accepted_costs"]) - 1,
           "reference_linear_iterations": ref_out["linear_iterations"]}
    for label, (solve, seconds) in runs.items():
        numbers = harness.compare([solve], ref_out, reference, cell["checks"], path_steps)
        out[label] = dict(numbers, steps=solve["steps"], accepted=len(solve["accepted_costs"]) - 1,
                          termination=solve["termination"], seconds=seconds,
                          final_cost=solve["final_cost"],
                          lockstep=harness.lockstep(solve["accepted_costs"],
                                                    ref_out["accepted_costs"]),
                          linear_iterations=solve["linear_iterations"])
    out["control_fails"] = {k: out["control"][k] > v for k, v in cell["checks"].items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            print("[control] no CUDA card", file=sys.stderr)
            return 3
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from skeres_tpu_torch.ops.build import build_all

        build_all()
        print(f"[control] card: {torch.cuda.get_device_name(0)}", flush=True)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
