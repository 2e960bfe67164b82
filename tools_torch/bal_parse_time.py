#!/usr/bin/env python3
"""The port's two BAL text parsers against one solve of the parsed scene.

    python3 tools_torch/bal_parse_time.py [--num-cameras 356] [--num-points 226730]
                                          [--observations-per-point 5] [--runs 3]
                                          [--max-iterations 50] [--device cuda]

Writes ``synthetic_bal(...)`` (by default the camera, point and observation
counts of BAL problem-356-226730, 1,133,650 observations) as a BAL ``.txt``
under ``build/``, then times, ``--runs`` times each and in turns, the
Python parser (``io/bal.py:parse_bal_text``) and the native one
(``load_bal``, which reads a ``.txt`` through ``native/bal_native.py``;
its first call, with the g++ build, is timed apart) and checks that both give
the scene written bit for bit. Then it runs the bundle adjuster CLI on the
file (``cli/bundle_adjuster.py``: ``load_bal``, DENSE_SCHUR, float64,
``--max-iterations`` LM iterations) twice and times each whole call (the
first also builds the kernels, unless ``build/`` holds them). Prints the
card's name and power limit, then one JSON line of seconds.
``--device cpu`` solves on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-cameras", type=int, default=356)
    ap.add_argument("--num-points", type=int, default=226_730)
    ap.add_argument("--observations-per-point", type=int, default=5)
    ap.add_argument("--runs", type=int, default=3, help="timed parses of each parser")
    ap.add_argument("--max-iterations", type=int, default=50, help="the CLI's LM iterations")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("bal_parse_time: no CUDA device", file=sys.stderr)
        return 1
    from skeres_tpu_torch.cli import bundle_adjuster
    from skeres_tpu_torch.io.bal import load_bal, parse_bal_text, synthetic_bal, write_bal

    smi = "cpu" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[bal_parse_time] {smi}; {os.cpu_count()} host cores; torch {torch.__version__}",
          flush=True)
    bal = synthetic_bal(args.num_cameras, args.num_points, args.observations_per_point)
    fields = ("cameras", "points", "camera_index", "point_index", "observations")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        t0 = time.perf_counter()
        path = write_bal(os.path.join(tmp, "scene.txt"), bal)
        result = {"device": smi, "observations": bal.num_observations,
                  "file_bytes": os.path.getsize(path), "write_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        load_bal(path)
        result["native_first_call_s"] = time.perf_counter() - t0  # the g++ build included
        result["python_parse_s"], result["native_parse_s"] = [], []
        for _ in range(args.runs):
            for key, parse in (("python_parse_s", parse_bal_text), ("native_parse_s", load_bal)):
                t0 = time.perf_counter()
                got = parse(path)
                result[key].append(time.perf_counter() - t0)
                for name in fields:
                    if not np.array_equal(getattr(got, name), getattr(bal, name)):
                        print(f"bal_parse_time: {key}: {name} differs", file=sys.stderr)
                        return 1
        result["cli_s"] = []
        for _ in range(2):  # the first call also builds the kernels at first use
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                summary = bundle_adjuster.main(["--input", path, "--device", args.device,
                                                "--max_iterations", str(args.max_iterations)])
            result["cli_s"].append(time.perf_counter() - t0)
    result["cli_iterations"] = len(summary.iterations) - 1
    result["cli_schur_path"] = summary.schur_complement_path
    result["cli_final_cost"] = summary.final_cost
    for key in ("preprocessor", "minimizer", "total"):
        result[f"cli_{key}_s"] = getattr(summary, f"{key}_time_in_seconds")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
