#!/usr/bin/env python3
"""Headline benchmark of the port: LM-iteration throughput on BAL bundle adjustment.

PyTorch counterpart of the JAX package's ``bench.py``, with its flags,
defaults, options and JSON keys (``extra.backend`` becomes
``extra.device``: the card's name and power limit, or ``"cpu"``):

    python3 tools_torch/bench.py [--num_cameras N] [--num_points N] [--iters 30]
                                 [--skip_baseline] [--device cuda] [--dtype float32]

Workload: BAL ladybug/problem-49 if a ``*problem-49*`` file is staged under
``data/``, else a synthetic BAL scene at the same scale (49 cameras, 7776
points, 31,104 observations) with the identical Snavely camera model.
DENSE_SCHUR on the device loop, one chunk of ``--iters`` steps and the full
iteration budget, in float32 on the card unless asked otherwise.

Metric: LM steps (accepted + rejected) per second of minimizer time
(``Summary.minimizer_time_in_seconds``; the device loop's capture counts as
preprocessing). A warm-up solve of the same length first, then the median
of 3 solves, their min/max in ``extra.rate_spread``.

Baseline: scipy ``least_squares`` (TRF + sparse LSMR) on the same problem
on the CPU, a weak stand-in for a Ceres CPU solve. It is read from
``BASELINE_MEASURED.json`` when that file's workload label is this run's;
otherwise it is measured in this process. The file is never written.
``--skip_baseline`` leaves it out.

Earlier lines give the kernels' build seconds and each timed solve's set-up
seconds, costs and kernel launches (``tools_torch/bench_common.py``). The
last line is the JSON result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools_torch import bench_common as common  # noqa: E402

TAG = "bench"
CACHE = os.path.join(common.ROOT, "BASELINE_MEASURED.json")

NUM_CAMERAS = 49
NUM_POINTS = 7776
OBS_PER_POINT = 4
BENCH_ITERS = 30
REPEATS = 3  # measured solves; the reported rate is their median


def _find_bal_file():
    data = os.path.join(common.ROOT, "data")
    if not os.path.isdir(data):
        return None
    for name in sorted(os.listdir(data)):
        if "problem-49" in name and (
            name.endswith(".txt") or name.endswith(".bz2") or name.endswith(".gz")
        ):
            return os.path.join(data, name)
    return None


def load_workload(num_cameras=NUM_CAMERAS, num_points=NUM_POINTS):
    """The staged problem-49 file, normalized, or the synthetic scene;
    returns ``(bal, label)``."""
    from skeres_tpu_torch.io.bal import load_bal, synthetic_bal

    path = _find_bal_file()
    if path is not None:
        bal = load_bal(path)
        bal.normalize()
        bal.perturb(rotation_sigma=0.0, translation_sigma=0.0, point_sigma=0.0)
        label = os.path.basename(path)
    else:
        bal = synthetic_bal(
            num_cameras=num_cameras,
            num_points=num_points,
            observations_per_point=OBS_PER_POINT,
        )
        label = f"synthetic-bal-{num_cameras}-{num_points}"
    return bal, label


# -- the port's solver -----------------------------------------------------------


def run_solver(bal, device, dtype, max_iters=BENCH_ITERS):
    """The JAX script's ``run_tpu_solver`` on the port: DENSE_SCHUR on the
    device loop, one chunk of ``max_iters`` steps, the full budget; a
    warm-up solve, then ``REPEATS`` measured ones."""
    from skeres_tpu_torch.core.options import SolverOptions
    from skeres_tpu_torch.core.types import LinearSolverType
    from skeres_tpu_torch.io.bal import build_bal_problem

    def solve(n_iters, label):
        problem, _, _ = build_bal_problem(bal)
        options = SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_SCHUR,
            max_num_iterations=n_iters,
            use_device_loop=True,
            device_loop_chunk_iterations=n_iters,
            # exactly n_iters LM steps: a fixed, reproducible denominator
            run_full_iteration_budget=True,
            dtype=dtype,
            device=device,
        )
        return common.timed_solve(TAG, label, options, problem)

    solve(max_iters, "warm-up")
    runs = [solve(max_iters, f"run {i + 1}") for i in range(REPEATS)]
    rates = []
    for summary in runs:
        steps = summary.num_successful_steps + summary.num_unsuccessful_steps
        rates.append(float(steps / summary.minimizer_time_in_seconds))
    order = int(np.argsort(rates)[len(rates) // 2])
    summary = runs[order]
    steps = summary.num_successful_steps + summary.num_unsuccessful_steps
    return {
        "steps": int(steps),
        "seconds": float(summary.minimizer_time_in_seconds),
        "steps_per_sec": float(rates[order]),
        "rate_spread": [round(min(rates), 3), round(max(rates), 3)],
        "initial_cost": float(summary.initial_cost),
        "final_cost": float(summary.final_cost),
    }


# -- scipy CPU baseline (weak stand-in for a reference CPU solve) ------------------


def _np_rotate(aa, pts):
    """Vectorized Rodrigues rotation: aa (n,3) angle-axis, pts (n,3)."""
    theta2 = np.sum(aa * aa, axis=1, keepdims=True)
    theta = np.sqrt(np.maximum(theta2, 1e-32))
    small = theta2 < 1e-16
    k = aa / np.where(small, 1.0, theta)
    ct = np.cos(theta)
    st = np.sin(theta)
    kxp = np.cross(k, pts)
    kdp = np.sum(k * pts, axis=1, keepdims=True)
    rotated = pts * ct + kxp * st + k * kdp * (1.0 - ct)
    return np.where(small, pts + np.cross(aa, pts), rotated)


def _np_residuals(x, bal):
    nc = bal.num_cameras
    cams = x[: 9 * nc].reshape(nc, 9)
    pts = x[9 * nc :].reshape(-1, 3)
    c = cams[bal.camera_index]
    p = pts[bal.point_index]
    pc = _np_rotate(c[:, 0:3], p) + c[:, 3:6]
    xp = -pc[:, 0] / pc[:, 2]
    yp = -pc[:, 1] / pc[:, 2]
    r2 = xp * xp + yp * yp
    dist = 1.0 + r2 * (c[:, 7] + c[:, 8] * r2)
    f = c[:, 6]
    res = np.stack(
        [f * dist * xp - bal.observations[:, 0], f * dist * yp - bal.observations[:, 1]],
        axis=1,
    )
    return res.ravel()


def _jac_sparsity(bal):
    from scipy.sparse import coo_matrix

    nobs = bal.num_observations
    nc = bal.num_cameras
    cam_cols = 9 * bal.camera_index[:, None] + np.arange(9)[None, :]
    pt_cols = 9 * nc + 3 * bal.point_index[:, None] + np.arange(3)[None, :]
    block_cols = np.concatenate([cam_cols, pt_cols], axis=1)  # (nobs, 12)
    # each of the 2 residual rows of an observation touches all 12 cols
    rows = np.repeat(np.arange(2 * nobs).reshape(nobs, 2), 12, axis=1).reshape(-1)
    cols = np.tile(block_cols[:, None, :], (1, 2, 1)).reshape(-1)
    data = np.ones_like(rows, dtype=np.int8)
    n = 9 * nc + 3 * bal.num_points
    return coo_matrix((data, (rows, cols)), shape=(2 * nobs, n)).tocsr()


def measure_scipy_baseline(bal):
    """LM-ish iterations/sec of scipy TRF on the CPU."""
    from scipy.optimize import least_squares

    x0 = np.concatenate([bal.cameras.ravel(), bal.points.ravel()])
    sp = _jac_sparsity(bal)

    t0 = time.time()
    result = least_squares(
        _np_residuals,
        x0,
        jac_sparsity=sp,
        method="trf",
        tr_solver="lsmr",
        max_nfev=60,
        verbose=0,
        args=(bal,),
    )
    secs = time.time() - t0
    # scipy TRF: one Jacobian (njev) per outer iteration
    iters = max(int(result.njev), 1)
    return {
        "solver": "scipy.least_squares(trf,lsmr) [weak CPU stand-in]",
        "iterations": iters,
        "seconds": float(secs),
        "steps_per_sec": float(iters / secs),
        "final_cost": float(result.cost),
    }


def get_baseline(bal, label):
    """The cached measurement when its workload is ``label``, else one
    measured now (and not written back)."""
    if os.path.exists(CACHE):
        with open(CACHE) as f:
            cached = json.load(f)
        if cached.get("workload") == label:
            return cached
    base = measure_scipy_baseline(bal)
    base["workload"] = label
    return base


def run(args) -> dict:
    device, dtype = common.resolve_device(args)
    info = common.device_info(device)
    print(f"[{TAG}] device {json.dumps(info)}", flush=True)
    common.build_kernels(device, TAG)
    bal, label = load_workload(args.num_cameras or NUM_CAMERAS, args.num_points or NUM_POINTS)

    ours = run_solver(bal, device, dtype, max_iters=args.iters)
    if args.skip_baseline:
        baseline, vs = None, float("nan")
    else:
        baseline = get_baseline(bal, label)
        vs = ours["steps_per_sec"] / baseline["steps_per_sec"]

    return {
        "metric": f"lm_steps_per_sec[{label}]",
        "value": round(ours["steps_per_sec"], 3),
        "unit": "iter/s",
        "vs_baseline": round(vs, 3) if np.isfinite(vs) else None,
        "extra": {
            "device": info,
            "initial_cost": ours["initial_cost"],
            "final_cost": ours["final_cost"],
            "steps": ours["steps"],
            "rate_spread": ours["rate_spread"],
            "baseline": None
            if baseline is None
            else {
                "solver": baseline["solver"],
                "steps_per_sec": baseline["steps_per_sec"],
            },
        },
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num_cameras", type=int, default=None)
    ap.add_argument("--num_points", type=int, default=None)
    ap.add_argument("--iters", type=int, default=BENCH_ITERS)
    ap.add_argument("--skip_baseline", action="store_true")
    common.add_device_flags(ap)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
