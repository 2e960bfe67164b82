#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (skeres_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises, the script exits
non-zero and prints no result line):

  1. device  — a CUDA card is present; print its name and power limit;
               TF32 off for matmuls and cuDNN.
  2. build   — compile K1 and K2's trailing update (csrc/cholesky.cu), K3
               (csrc/pair_product.cu) and K1 with its clock64 phase counters
               (-DSKERES_K1_CLOCKS), one nvcc each, started together; print
               the seconds and the compiler's resource report.
  3. K1      — the kernel against its plain PyTorch version on the card,
               n in {1, 5, 37, 128, 300, 441, 1024}, float32 and float64,
               plus the equilibrated S of the BAL-49 problem; a matrix that
               is not positive definite must give all-NaN outputs; n = 1025
               must raise.
  4. K2      — the blocked factor (K1 panels, the trailing-update kernel)
               against cuSOLVER's, n in {1025, 2048, 3000}, float32 and
               float64, panels 1024, 256 and ``PANEL``: L and a solve within a bound of
               max|reference|, and the backward errors; a non-PD input gives
               non-finite outputs.
  5. K3      — the pair-product kernel against its plain version on a random
               non-uniform problem (f = 5, e = 3, 1-6 observations per
               point), float32 and float64, judged on the reduced unique-pair
               table.
  6. solve   — the first main path: synthetic BAL-49 (49 cameras, 7776
               points, 31104 observations), DENSE_SCHUR LM, 30 steps, float32
               on the card (dense W, K1); the costs must be finite and fall
               below 1e-2 of the initial cost, and K1 must launch on every
               damped solve.
  7. card vs CPU — synthetic_bal(16, 500, 4), 10 steps in float64, on the
               card and on the CPU (plain versions): the same accept/reject
               sequence, costs equal to rtol 1e-8.
  8. explicit vs dense W — synthetic_bal(120, 2000, 4), float64 on the card:
               the explicit S (K3) equals the dense-W S to rtol 1e-10.
  9. card vs CPU, explicit — the same scene, 10 steps in float64 with the
               dense-W gate at 0: S (1080 rows) is explicit and factored by
               K2 (K1 panels and updates on every damped solve); the same
               accept/reject sequence and costs to rtol 1e-8.
 10. venice  — synthetic_bal(1778, 1_000_000, 5) (venice-1778 shape), float32,
               evaluation chunks of 262,144 rows: the plan's unique pairs and
               levels; K3 at full shape against its plain version; K2 on the
               equilibrated S of the first damped solve, held to backward
               errors; a torch.profiler breakdown of one damped solve (and
               its K1 and update launches); K3 timed against its plain
               version; the trailing update alone at the first panel's shape
               (m = 15,746, w = 256, and at ``PANEL``) against ``addmm_``,
               with its TFLOP/s; K2
               (n = 16,002) at panels 256 and 512 against cuSOLVER and
               ``torch.linalg.cholesky_ex``; and
               ``blocked_chol_solve`` at n = 16,002 apart from the factor.
 11. venice solve — the second main path: the same scene through
               ``stt.solve``, 5 LM steps (explicit S, K3, K2); every cost
               finite, a step accepted, the final cost below the initial,
               K3, K1 and the update launched on every damped solve (the
               update once a panel but the last); peak device memory.
 12. timing  — K1 and its plain version at n in {256, 441, 1024}, float32,
               median of 20 runs (10 back-to-back calls each) timed with
               CUDA events after warm-up; and K1's clock64 breakdown by
               phase at those n (thread 0's cycles over 20 launches).
 13. device loop, card vs CPU — synthetic_bal(16, 500, 4), 10 steps in
               float64 with ``use_device_loop`` in chunks of 4 (on the card
               each LM step is one replayed CUDA graph with conditional IF
               nodes): the same accept/reject sequence as on the CPU, costs
               to rtol 1e-8.
 14. device loop, explicit — the same on the scene of phase 9 with the
               dense-W gate at 0 (K3, and K2 over K1 panels, in the graph).
 15. device loop, BAL-49 — ``bench.py``'s options (30 steps, one chunk of
               30, the full iteration budget), float32, its minimizer traced
               (``trace_dir``) in a child process (``chip_smoke.py
               --traced-bal49``; see the note above ``trace_launches``):
               costs finite and below 1e-2 of the initial cost, K1 in the
               replays once a damped solve and once a jitter rung; then LM
               steps/s of the device loop and the host loop, median and spread
               of 5 runs each, in turns; the capture time.
 16. device loop, venice — run right after phase 11, as the first CUDA graph
               of the process: the same scene through ``stt.solve`` with
               ``use_device_loop``, 5 steps in one chunk, traced: the checks of
               phase 11, with K3, K1 panels and updates counted in the replays
               from the trace; the capture time and the peak device memory;
               then one untraced run, for LM steps/s beside phase 11's.

 17. solvers, card vs CPU — synthetic_bal(16, 500, 4), float64, 10 steps
               at initial radius 1 on the card and on the CPU, the host loop:
               DENSE_NORMAL_CHOLESKY (and with 2 refinements), DENSE_QR, CGNR
               (JACOBI; SUBSET on an odometry chain), ITERATIVE_SCHUR with
               JACOBI, SCHUR_JACOBI, POWER_SERIES_EXPANSION, CLUSTER_JACOBI
               and CLUSTER_TRIDIAGONAL (clusters of 4), ITERATIVE_SCHUR with
               the explicit S, DENSE_SCHUR with mixed-precision refinement:
               the same accept/reject sequence, costs to rtol 1e-8 (CGNR 1e-3:
               its PCG runs on the whole problem's normal equations), K3 once
               a damped solve with the explicit S or a cluster plan and never
               otherwise, K1 once a solve under refinement. Then
               ITERATIVE_SCHUR (SCHUR_JACOBI) and CGNR under the device loop
               (each PCG a conditional WHILE node of the step's graph).
 18. venice, iterative — the venice scene, float32, 5 LM steps each:
               ITERATIVE_SCHUR implicit with SCHUR_JACOBI, with the explicit
               S, and with CLUSTER_JACOBI (64 cameras a cluster): LM steps/s,
               PCG steps a damped solve, the S path, the final cost beside
               DENSE_SCHUR's, peak memory, K3's launches against the expected
               count; one implicit S product timed, and the row products as
               ``einsum`` against multiply-and-sum. (Phase 10 also holds K3
               against its plain version on the cluster plan's masks.)
 19. past the explicit-S gate — synthetic_bal(4000, 1_000_000, 5), float32,
               ITERATIVE_SCHUR, 3 LM steps each with SCHUR_JACOBI,
               CLUSTER_JACOBI and CLUSTER_TRIDIAGONAL (64 cameras a cluster):
               the path must read ``implicit (gate: S too large ...)``;
               steps/s, the cost after each step, seconds a damped solve.

The line before the last is a JSON object describing each kernel (its
time, its launches on the main path, its bound: the larger of the bytes it
must move over 3.35 TB/s and its operations over the peak for their type,
float32 on the tensor cores as 3xTF32 at 495 / 3 = 165 TFLOP/s; and the
time of one PyTorch call computing the same function, where one exists);
the last is ``{"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}``. The run prints its wall time before them.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

NS = (1, 5, 37, 128, 300, 441, 1024)
# max-abs error bound relative to max|reference|, per dtype
K1_RTOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# bound on the backward errors ||L L^T - A|| / ||A|| and
# ||L L^-1 - I|| / (||L|| ||L^-1||) (Frobenius), a few hundred ulps at n <= 1024
K1_BACKWARD = {torch.float32: 1e-5, torch.float64: 1e-12}
K2_NS = (1025, 2048, 3000)
K2_PANELS = (1024, 256)
# K2 at n <= 3000: the same bounds as K1 (sums of n terms in float32)
K2_RTOL = K1_RTOL
K2_BACKWARD = K1_BACKWARD
# K2 on the venice S (n = 16,002 float32): sums 16x longer than K1's
K2_VENICE_BACKWARD = 1e-4
# K3: max-abs error of the reduced unique-pair table / max|reference|;
# each row is a 3-term sum, the table sums a few thousand rows
K3_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
VENICE = dict(num_cameras=1778, num_points=1_000_000, observations_per_point=5)
VENICE_CHUNK = 262_144  # evaluation_chunk_size, as tools/bench_venice.py
VENICE_STEPS = 5
CLUSTER_SIZE = 64  # cameras a cluster at venice shape and beyond (cluster_jacobi_size)
PAST_CAP = dict(num_cameras=4000, num_points=1_000_000, observations_per_point=5)
PAST_CAP_STEPS = 3
ROOT = os.path.dirname(os.path.abspath(__file__))
K1_TIMED_NS = (256, 441, 1024)
K2_TIMED_PANELS = (128, 256, 512)  # 512 is PANEL
K1_CLOCK_PHASES = ("set-up", "diagonal", "multiply", "exchange", "update", "barrier", "NaN fill")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_3XTF32_FLOPS = 495e12 / 3  # float32 as 3xTF32 on the tensor cores
# kernel names in a profiler trace: K1 (f32 and f64), K2's update (both),
# K3, and the one-thread kernel that sets an IF node's condition
TRACE_KERNELS = {"K1": "chol_inv_kernel", "update": "syrk_lower", "K3": "pair_kernel",
                 "IF": "set_conditional_kernel"}
TIMED_RUNS = 5  # device loop and host loop, in turns


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def spd(n: int, dtype, device) -> torch.Tensor:
    """A = M M^T + n I from a numpy seed (as tests/test_kernels.py)."""
    rng = np.random.default_rng(n)
    m = rng.standard_normal((n, n))
    return torch.as_tensor(m @ m.T + n * np.eye(n), dtype=dtype, device=device)


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max-abs error, max-abs error / max|ref|)."""
    err = float((x.double() - ref.double()).abs().max())
    return err, err / float(ref.double().abs().max())


def phase_device():
    check(torch.cuda.is_available(), "no CUDA device: this smoke test needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"cards {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from skeres_tpu_torch.ops import cholesky, pair_product
    from skeres_tpu_torch.ops.build import build_all, load_library

    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        clocks = pool.submit(load_library, "cholesky", ("SKERES_K1_CLOCKS",))
        logs = build_all()
        clocks.result()
    print(f"[build] {', '.join(logs)} and cholesky -DSKERES_K1_CLOCKS built in parallel "
          f"in {time.time() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "bytes stack" in line or "Compiling" in line:
                print(f"[build] {name}: {line.strip()}")
    cholesky.build_kernels()
    pair_product.build_kernels()


def backward_errors(a, l, linv) -> tuple[float, float]:
    """The factor's and the inverse's normwise backward errors, in float64."""
    a, l, linv = a.double(), l.double(), linv.double()
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    fac = torch.linalg.norm(l @ l.T - a) / torch.linalg.norm(a)
    inv = torch.linalg.norm(l @ linv - eye) / (torch.linalg.norm(l) * torch.linalg.norm(linv))
    return float(fac), float(inv)


def k1_case(a: torch.Tensor, rtol, label: str) -> float:
    """Kernel vs plain version on ``a``: the kernel's backward errors
    within ``K1_BACKWARD``, and, unless ``rtol`` is None, its outputs within
    ``rtol`` of the plain version's. Returns the max-abs error of L^-1."""
    from skeres_tpu_torch.ops.cholesky import (
        chol_solve,
        cholesky_both,
        cholesky_both_reference,
    )

    l, linv = cholesky_both(a)
    l_ref, linv_ref = cholesky_both_reference(a)
    b = torch.as_tensor(
        np.random.default_rng(a.shape[0] + 1).standard_normal(a.shape[0]),
        dtype=a.dtype, device=a.device,
    )
    x = chol_solve(linv, b)
    x_ref = chol_solve(linv_ref, b)
    torch.cuda.synchronize()
    errs = {"L": rel_err(l, l_ref), "Linv": rel_err(linv, linv_ref),
            "solve": rel_err(x, x_ref)}
    fac, inv = backward_errors(a, l, linv)
    print(f"[K1] {label}: " + ", ".join(
        f"{k} max|err| {e:.3e} (rel {r:.3e})" for k, (e, r) in errs.items())
        + f"; backward errors {fac:.3e} (L L^T), {inv:.3e} (L L^-1)")
    bound = K1_BACKWARD[a.dtype]
    check(fac <= bound and inv <= bound,
          f"K1 {label}: backward errors {fac:.3e}, {inv:.3e} > {bound:.0e}")
    if rtol is not None:
        for k, (_, r) in errs.items():
            check(r <= rtol, f"K1 {label}: {k} rel error {r:.3e} > {rtol:.0e}")
    return errs["Linv"][0]


def linearize(program, device, dtype, chunk=None, **schur_kw):
    """The minimizer's first linearization, by hand: (schur solver,
    prepared Jacobi-scaled data, scaled g, scaled diag)."""
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.schur import SchurSolver

    ev = Evaluator(program, device=device, dtype=dtype, chunk_size=chunk)
    schur = SchurSolver(ev, **schur_kw)
    _, blocks = ev.blocks(program.initial_state(device, dtype))
    g, diag = ev.gradient_and_diag(blocks)
    scale = 1.0 / (1.0 + torch.sqrt(diag))
    data = schur.prepare(schur.scale_data(schur.solver_data(blocks), scale))
    return schur, data, g * scale, diag * scale * scale


def first_assembly(schur, data, g, diag):
    """The elimination state of the first damped solve (radius 1e4)."""
    from skeres_tpu_torch.core.linear_solvers import lm_diagonal

    return schur._assemble(data, g, lm_diagonal(diag, 1e-4, 1e-6, 1e32))


def equilibrated(s):
    d_eq = torch.sqrt(torch.diagonal(s))
    return (s / d_eq[:, None] / d_eq[None, :]).contiguous()


def bal49_equilibrated_s(device):
    """The equilibrated reduced camera system of the main path's first
    damped solve (radius 1e4) at BAL-49 size, float32."""
    from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal

    program = build_bal_problem(synthetic_bal(49, 7776, 4))[0].compile()
    schur, data, g, diag = linearize(program, device, torch.float32)
    return equilibrated(schur._dense_s(first_assembly(schur, data, g, diag)))


def phase_k1(device) -> float:
    from skeres_tpu_torch.ops.cholesky import cholesky_both

    err_441 = None
    for dtype in (torch.float32, torch.float64):
        for n in NS:
            e = k1_case(spd(n, dtype, device), K1_RTOL[dtype], f"n={n} {dtype}")
            if n == 441 and dtype == torch.float32:
                err_441 = e
    s = bal49_equilibrated_s(device)
    print(f"[K1] BAL-49 equilibrated S: n={s.shape[0]}")
    # no bound against the plain version here: S of a gauge-free BA problem
    # is ill-conditioned, so two float32 factorizations differ by about
    # cond(S) * eps in L^-1; the backward errors are what both guarantee
    k1_case(s, None, "BAL-49 S float32")

    for dtype in (torch.float32, torch.float64):
        bad = -torch.eye(37, dtype=dtype, device=device)
        l, linv = cholesky_both(bad)
        torch.cuda.synchronize()
        check(not torch.isfinite(l).any() and not torch.isfinite(linv).any(),
              f"non-PD input gave finite output ({dtype})")
    print("[K1] non-PD input: every output element NaN (float32, float64)")
    try:
        cholesky_both(torch.eye(1025, device=device))
    except ValueError as exc:
        print(f"[K1] n=1025 raises: {exc}")
    else:
        raise RuntimeError("chip_smoke: K1 accepted n = 1025")
    return err_441


def solve_bal(bal, device, dtype, iters, solver="DENSE_SCHUR", precond="JACOBI", **kw):
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.types import LinearSolverType, PreconditionerType
    from skeres_tpu_torch.io.bal import build_bal_problem

    problem, _, _ = build_bal_problem(bal)
    options = stt.SolverOptions(
        linear_solver_type=LinearSolverType[solver],
        preconditioner_type=PreconditionerType[precond],
        max_num_iterations=iters,
        run_full_iteration_budget=True,
        dtype=dtype,
        device=device,
        **kw,
    )
    return stt.solve(options, problem)


def phase_solve(device) -> int:
    from skeres_tpu_torch.io.bal import synthetic_bal
    from skeres_tpu_torch.ops.cholesky import cholesky_both, trailing_update_
    from skeres_tpu_torch.ops.pair_product import pair_products

    bal = synthetic_bal(49, 7776, 4)
    print(f"[solve] synthetic BAL-49: {bal.num_cameras} cameras, "
          f"{bal.num_points} points, {bal.num_observations} observations")
    solve_bal(bal, device, torch.float32, 2)  # warm-up: first-call set-up
    cholesky_both.launches = trailing_update_.launches = pair_products.launches = 0
    s = solve_bal(bal, device, torch.float32, 30)
    launches = cholesky_both.launches
    check(trailing_update_.launches == pair_products.launches == 0,
          "BAL-49: S has 441 rows and dense W, yet K2's update or K3 launched")
    steps = s.num_successful_steps + s.num_unsuccessful_steps
    costs = [it.cost for it in s.iterations]
    print(f"[solve] costs: {json.dumps(costs)}")
    print(f"[solve] linear solver iterations: "
          f"{[it.linear_solver_iterations for it in s.iterations[1:]]}")
    print(f"[solve] initial cost {s.initial_cost!r} final cost {s.final_cost!r}")
    print(f"[solve] {steps} LM steps ({s.num_successful_steps} accepted) in "
          f"{s.minimizer_time_in_seconds:.4f} s of minimizer time: "
          f"{steps / s.minimizer_time_in_seconds:.3f} LM steps/s")
    print(f"[solve] jacobian {s.jacobian_evaluation_time_in_seconds:.4f} s, "
          f"linear solver {s.linear_solver_time_in_seconds:.4f} s, residual "
          f"{s.residual_evaluation_time_in_seconds:.4f} s")
    print(f"[solve] K1 launches {launches} for {s.num_linear_solves} damped solves")
    check(all(np.isfinite(costs)), "non-finite cost in the BAL-49 trajectory")
    check(s.final_cost < 1e-2 * s.initial_cost,
          f"final cost {s.final_cost} not below 1e-2 x initial {s.initial_cost}")
    check(steps == 30, f"{steps} LM steps, expected 30")
    check(launches >= s.num_linear_solves > 0,
          f"K1 launched {launches} times for {s.num_linear_solves} damped solves")
    return launches


def card_vs_cpu(device, bal, label: str, rtol: float = 1e-8, solve=None, **kw):
    """The same float64 solve, 10 steps at initial radius 1, on the card and
    on the CPU (``kw``: more solver options for both; ``solve``: another
    scene's solve function in place of :func:`solve_bal`): the same
    accept/reject sequence, costs to ``rtol``. Returns the card's Summary."""
    # initial radius 1: every accept/reject decision of the 10 steps is made
    # on a cost change far above rounding; at the default radius a scene
    # like synthetic_bal(16, 500, 4) converges by step 6 and later decisions
    # compare rounding noise, which two summation orders need not agree on
    solve = solve or solve_bal
    runs = {dev: solve(bal, dev, torch.float64, 10, initial_trust_region_radius=1.0, **kw)
            for dev in (device, "cpu")}
    seq = {dev: [it.step_is_successful for it in s.iterations] for dev, s in runs.items()}
    cost = {dev: np.array([it.cost for it in s.iterations]) for dev, s in runs.items()}
    rel = float(np.max(np.abs(cost[device] - cost["cpu"]) / np.abs(cost["cpu"])))
    pcg = [it.linear_solver_iterations for it in runs[device].iterations[1:]]
    print(f"[{label}] path {runs[device].schur_complement_path or '-'}; accept/reject "
          f"{seq[device]}; linear solver iterations {pcg}; max relative cost difference "
          f"{rel:.3e} over {len(cost['cpu'])} iterations")
    check(seq[device] == seq["cpu"], f"{label}: accept/reject sequences differ")
    check(len(cost[device]) == len(cost["cpu"]) == 11, f"{label}: iteration counts differ")
    check(rel <= rtol, f"{label}: card and CPU costs differ by {rel:.3e} > {rtol:.0e}")
    return runs[device]


def phase_card_vs_cpu(device):
    from skeres_tpu_torch.io.bal import synthetic_bal

    card = card_vs_cpu(device, synthetic_bal(16, 500, 4), "card-vs-cpu")
    check(card.schur_complement_path == "dense-W", "card-vs-cpu: not the dense-W path")


# -- K2 -----------------------------------------------------------------------


def k2_case(a: torch.Tensor, panel: int, label: str, rtol=K2_RTOL, backward=K2_BACKWARD):
    """K2 against its plain version on ``a``: the factor's and the solve's
    backward errors within ``backward``, and, unless ``rtol`` is None, L
    and the solve within ``rtol`` of the plain version's. Returns the
    max-abs error of L."""
    from skeres_tpu_torch.ops.cholesky import (
        blocked_chol_solve,
        blocked_cholesky_factor,
        blocked_cholesky_factor_reference,
    )

    n = a.shape[0]
    fac = blocked_cholesky_factor(a, panel=panel)
    l_ref = blocked_cholesky_factor_reference(a)
    b = torch.as_tensor(np.random.default_rng(n + 1).standard_normal(n),
                        dtype=a.dtype, device=a.device)
    x = blocked_chol_solve(fac, b)
    torch.cuda.synchronize()
    a64, l64, x64 = a.double(), fac.l.double(), x.double()
    fac_err = float(torch.linalg.norm(l64 @ l64.T - a64) / torch.linalg.norm(a64))
    sol_err = float(torch.linalg.norm(a64 @ x64 - b.double())
                    / (torch.linalg.norm(a64) * torch.linalg.norm(x64)))
    msg = f"backward errors {fac_err:.3e} (L L^T), {sol_err:.3e} (solve)"
    errs = {}
    if bool(torch.isfinite(l_ref).all()):
        x_ref = torch.cholesky_solve(b[:, None], l_ref)[:, 0]
        errs = {"L": rel_err(fac.l, l_ref), "solve": rel_err(x, x_ref)}
        msg += "; " + ", ".join(f"{k} max|err| {e:.3e} (rel {r:.3e})" for k, (e, r) in errs.items())
    print(f"[K2] {label} panel {panel}: {msg}")
    bound = backward[a.dtype] if isinstance(backward, dict) else backward
    check(fac_err <= bound and sol_err <= bound,
          f"K2 {label} panel {panel}: backward errors {fac_err:.3e}, {sol_err:.3e} > {bound:.0e}")
    if rtol is not None:
        check(bool(errs), f"K2 {label}: the plain version failed")
        for k, (_, r) in errs.items():
            check(r <= rtol[a.dtype], f"K2 {label} panel {panel}: {k} rel error {r:.3e}")
    return errs["L"][0] if errs else float("nan")


def phase_k2(device) -> float:
    from skeres_tpu_torch.ops.cholesky import PANEL, blocked_chol_solve, blocked_cholesky_factor

    err = None
    for dtype in (torch.float32, torch.float64):
        for n in K2_NS:
            for panel in dict.fromkeys(K2_PANELS + (PANEL,)):  # and the default
                e = k2_case(spd(n, dtype, device), panel, f"n={n} {dtype}")
                if n == K2_NS[-1] and dtype == torch.float32 and panel == PANEL:
                    err = e
    for dtype in (torch.float32, torch.float64):
        for at in (5, 2100):  # the first panel fails, or the ninth of 12
            bad = spd(3000, dtype, device)
            bad[at, at] = -1.0
            fac = blocked_cholesky_factor(bad, panel=256)
            x = blocked_chol_solve(fac, torch.ones(3000, dtype=dtype, device=device))
            first = at // 256
            later = torch.cat([v.reshape(-1) for v in fac.dinv[first:]])
            torch.cuda.synchronize()
            check(not torch.isfinite(later).any() and not torch.isfinite(x).any(),
                  f"K2: a failed panel left finite later outputs ({dtype}, pivot {at})")
    print("[K2] non-PD input: the failed panel, every later one and every entry "
          "of the solve non-finite (float32, float64; first and ninth panel)")
    return err


# -- K3 -----------------------------------------------------------------------


def k3_tables(plan, grid, cinv_flat):
    """The reduced unique-pair table by K3 and by its plain version."""
    from skeres_tpu_torch.core.explicit_schur import _apply_hierarchical_sum
    from skeres_tpu_torch.ops.pair_product import pair_products_reference

    kern = plan.correction_offdiag({"grid": grid}, cinv_flat)
    vals = pair_products_reference(grid, cinv_flat, plan.swap_mask, plan.pair_valid,
                                   plan.pair_kl, plan.f, plan.e, plan.chunk_points)
    plain = _apply_hierarchical_sum(plan.levels, vals)
    torch.cuda.synchronize()
    return kern, plain


def phase_k3(device):
    from skeres_tpu_torch.core.explicit_schur import ExplicitSchurPlan

    f, e, npts, nc = 5, 3, 4000, 40
    rng = np.random.default_rng(7)
    counts = rng.integers(1, 7, size=npts)
    pt = np.repeat(np.arange(npts), counts)
    cam = rng.integers(0, nc, size=len(pt))
    a_flat = rng.normal(size=(len(pt), f * e))
    cinv = rng.normal(size=(npts, e, e))
    cinv = (cinv + np.swapaxes(cinv, 1, 2)).reshape(npts, e * e)
    plan = ExplicitSchurPlan(cam_idx=cam, pt_idx=pt, num_cameras=nc, num_points=npts,
                             f_size=f, e_size=e, pad_waste=100.0, device=device)
    for dtype in (torch.float32, torch.float64):
        grid = plan.build_grid(torch.as_tensor(a_flat, dtype=dtype, device=device))["grid"]
        kern, plain = k3_tables(plan, grid.contiguous(), torch.as_tensor(cinv, dtype=dtype, device=device))
        err, rel = rel_err(kern, plain)
        print(f"[K3] random f=5 e=3 kp={plan.kp} (1-6 obs/point, {npts} points, "
              f"{plan.n_uniq} pairs) {dtype}: table max|err| {err:.3e} (rel {rel:.3e})")
        check(rel <= K3_RTOL[dtype], f"K3 random case {dtype}: rel error {rel:.3e}")


# -- the explicit path on a scene with S past K1's 1024 rows ----------------------


def explicit_twin(schur, data):
    """A second solver on the same evaluator with the dense-W gate at 0, so
    that it takes the explicit S, and its prepare() of the same data."""
    from skeres_tpu_torch.core import schur as schur_mod

    saved = schur_mod.DENSE_W_LIMIT_BYTES
    schur_mod.DENSE_W_LIMIT_BYTES = 0
    try:
        twin = schur_mod.SchurSolver(schur.ev)
    finally:
        schur_mod.DENSE_W_LIMIT_BYTES = saved
    return twin, twin.prepare([(r, jac) for r, jac, _ in data["per_batch"]])


def phase_explicit_vs_dense_w(device):
    from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal

    program = build_bal_problem(synthetic_bal(120, 2000, 4))[0].compile()
    schur, data, g, diag = linearize(program, device, torch.float64)
    twin, twin_data = explicit_twin(schur, data)
    check(schur.schur_path == "dense-W" and twin.schur_path == "explicit",
          "explicit-vs-dense-W: the two solvers do not take the two paths")
    s_exp = twin._dense_s_explicit(first_assembly(twin, twin_data, g, diag))
    s_dw = schur._dense_s_dense_w(first_assembly(schur, data, g, diag))
    torch.cuda.synchronize()
    diff = (s_exp - s_dw).abs()
    worst = float((diff / s_dw.abs().clamp(min=1e-300)).max())
    err, rel = rel_err(s_exp, s_dw)
    print(f"[explicit-vs-dense-W] synthetic_bal(120, 2000, 4) float64: S {tuple(s_exp.shape)}, "
          f"max|diff| {err:.3e} (rel to max|S| {rel:.3e}), max elementwise rel {worst:.3e}")
    # rtol 1e-10, with an atol of 1e-12 max|S| for entries that cancel: each
    # entry sums ~6,000 float64 products in another order on each path
    check(bool(torch.all(diff <= 1e-10 * s_dw.abs() + 1e-12 * float(s_dw.abs().max()))),
          "explicit S and dense-W S differ beyond rtol 1e-10")


def phase_card_vs_cpu_explicit(device):
    from skeres_tpu_torch.core import schur as schur_mod
    from skeres_tpu_torch.io.bal import synthetic_bal
    from skeres_tpu_torch.ops.cholesky import PANEL, cholesky_both, trailing_update_
    from skeres_tpu_torch.ops.pair_product import pair_products

    saved = schur_mod.DENSE_W_LIMIT_BYTES
    schur_mod.DENSE_W_LIMIT_BYTES = 0
    try:
        # S has 1080 rows: every K1 launch of this run is one of K2's panels
        cholesky_both.launches = pair_products.launches = trailing_update_.launches = 0
        card = card_vs_cpu(device, synthetic_bal(120, 2000, 4), "card-vs-cpu explicit")
        k2, k3, up = cholesky_both.launches, pair_products.launches, trailing_update_.launches
    finally:
        schur_mod.DENSE_W_LIMIT_BYTES = saved
    panels = math.ceil(1080 / PANEL)
    print(f"[card-vs-cpu explicit] K3 launches {k3}, K1 panel launches inside K2 {k2}, "
          f"trailing-update launches {up}, {card.num_linear_solves} damped solves")
    check(card.schur_complement_path == "explicit", "card-vs-cpu explicit: not the explicit path")
    check(k3 >= card.num_linear_solves > 0
          and k2 >= panels * card.num_linear_solves
          and up >= (panels - 1) * card.num_linear_solves,
          "card-vs-cpu explicit: K2 or K3 did not launch on every damped solve")


def cuda_ms(fn, reps: int = 20, calls: int = 10) -> float:
    """Median over ``reps`` runs of the milliseconds per call of ``fn``,
    each run timing ``calls`` back-to-back calls with CUDA events, so that
    the card, not the host's launch latency, sets the time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def k1_clock_breakdown(a: torch.Tensor, runs: int = 20) -> None:
    """K1 built with -DSKERES_K1_CLOCKS on ``a`` (float32): thread 0's
    clock64() cycles by phase, summed over ``runs`` launches."""
    import ctypes

    from skeres_tpu_torch.ops.build import load_library

    lib, _ = load_library("cholesky", ("SKERES_K1_CLOCKS",))
    fn, read = lib.skeres_chol_inv_f32, lib.skeres_k1_clocks
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    read.argtypes = [ctypes.c_void_p]
    fn.restype = read.restype = ctypes.c_int
    sums = (ctypes.c_ulonglong * len(K1_CLOCK_PHASES))()
    l, x = torch.empty_like(a), torch.empty_like(a)
    stream = torch.cuda.current_stream().cuda_stream
    torch.cuda.synchronize()
    check(read(sums) == 0, "K1 clocks: read failed")  # clears the counters
    for _ in range(runs):
        check(fn(a.data_ptr(), l.data_ptr(), x.data_ptr(), a.shape[0], stream) == 0,
              "K1 clocks: launch failed")
    torch.cuda.synchronize()
    check(read(sums) == 0, "K1 clocks: read failed")
    total = sum(sums)
    print(f"[timing] K1 clock64 breakdown n={a.shape[0]} float32 ({total / runs:.0f} cycles a "
          "launch): " + ", ".join(f"{name} {100 * v / total:.1f} %"
                                  for name, v in zip(K1_CLOCK_PHASES, sums)))


def phase_timing(device):
    from skeres_tpu_torch.ops.cholesky import cholesky_both, cholesky_both_reference

    times = {}
    for n in K1_TIMED_NS:
        a = spd(n, torch.float32, device)
        # plain, kernel, kernel, plain: the card's clocks drift less than the gap
        t = [cuda_ms(lambda: cholesky_both_reference(a)), cuda_ms(lambda: cholesky_both(a)),
             cuda_ms(lambda: cholesky_both(a)), cuda_ms(lambda: cholesky_both_reference(a))]
        times[n] = min(t[1], t[2]), min(t[0], t[3])
        print(f"[timing] K1 n={n} float32: kernel {t[1]:.4f}/{t[2]:.4f} ms, plain (cuSOLVER "
              f"potrf + trsm) {t[0]:.4f}/{t[3]:.4f} ms (median of 20 runs of 10 calls each)")
        k1_clock_breakdown(a)
    return times[441]


# -- venice-1778 shape ----------------------------------------------------------


def venice_scene():
    from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal

    t0 = time.time()
    bal = synthetic_bal(**VENICE)
    t_gen = time.time() - t0
    t0 = time.time()
    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()
    t_compile = time.time() - t0
    print(f"[venice] synthetic_bal{tuple(VENICE.values())}: {bal.num_cameras} cameras, "
          f"{bal.num_points} points, {bal.num_observations} observations; host time: "
          f"generate {t_gen:.2f} s, build and compile the problem {t_compile:.2f} s")
    return problem, program


def profile_damped_solve(schur, data, g, diag):
    """torch.profiler over one damped solve: device time by kernel, and
    the device's busy share of the solve's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from skeres_tpu_torch.ops.cholesky import PANEL, cholesky_both, trailing_update_

    torch.cuda.synchronize()
    k1_before, up_before = cholesky_both.launches, trailing_update_.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        schur.solve_damped(data, g, diag, 1e-4, 1e-6, 1e32)
        torch.cuda.synchronize()
        wall = time.time() - t0
    k1, up = cholesky_both.launches - k1_before, trailing_update_.launches - up_before
    print(f"[venice] profiled damped solve: K1 panel launches {k1}, trailing-update launches {up}")
    check(up >= 1 and up == k1 - k1 // math.ceil(schur.num_f / PANEL),
          "venice profile: not one trailing update a panel but the last")
    # the device-side events (kernels, copies, sets): one stream, so their
    # sum is the device's busy time
    busy = sum(ev.device_time_total for ev in prof.events()
               if ev.device_type == DeviceType.CUDA) / 1e3  # ms
    events = prof.key_averages()
    print(f"[venice] profile of one damped solve: wall {wall * 1e3:.3f} ms (profiled), "
          f"device time {busy:.3f} ms ({100 * busy / (wall * 1e3):.1f} % busy)")
    table = events.table(sort_by="self_device_time_total", row_limit=15)
    for line in table.splitlines():
        print(f"[venice][profile] {line}")


def phase_venice(device, program):
    """Kernel checks and timings at venice shape, from the first damped
    solve's state. Returns the K3 and K2 numbers for the kernels line."""
    from skeres_tpu_torch.ops.cholesky import (
        PANEL,
        blocked_chol_solve,
        blocked_cholesky_factor,
        blocked_cholesky_factor_reference,
    )
    from skeres_tpu_torch.ops.pair_product import pair_products, pair_products_reference

    t0 = time.time()
    schur, data, g, diag = linearize(program, device, torch.float32, VENICE_CHUNK)
    torch.cuda.synchronize()
    plan = schur.explicit_plan
    print(f"[venice] first linearization {time.time() - t0:.2f} s; path {schur.schur_path}; "
          f"S {schur.num_f} rows; plan: kp {plan.kp}, {plan.npairs} pairs per point, "
          f"{plan.n_uniq} unique camera pairs, {len(plan.levels)} levels "
          f"{[(lv.n_dest, lv.cap) for lv in plan.levels]}")
    check(schur.schur_path == "explicit", "venice: not the explicit path")

    asm = first_assembly(schur, data, g, diag)
    grid = asm["explicit_grid"]["grid"].contiguous()
    cinv_flat = asm["cinv"].reshape(-1, 9).contiguous()
    kern, plain = k3_tables(plan, grid, cinv_flat)
    k3_err, k3_rel = rel_err(kern, plain)
    print(f"[K3] venice shape float32: table max|err| {k3_err:.3e} (rel {k3_rel:.3e})")
    check(k3_rel <= K3_RTOL[torch.float32], f"K3 venice: rel error {k3_rel:.3e}")
    del kern, plain

    s_eq = equilibrated(schur._dense_s(asm))
    del asm
    for jitter in (0.0, 1e-3, 0.1):  # the ladder's rungs
        fac = blocked_cholesky_factor(s_eq, jitter=jitter)
        if bool(torch.isfinite(fac.l).all()):
            break
    check(bool(torch.isfinite(fac.l).all()), "K2 venice: every rung of the ladder failed")
    del fac
    print(f"[K2] venice equilibrated S ({s_eq.shape[0]} rows float32) factors at jitter {jitter}")
    # no bound against the plain version: S of a gauge-free BA problem is
    # ill-conditioned, so two float32 factorizations differ by about
    # cond(S) * eps; the backward errors are what both guarantee
    s_eq.diagonal().add_(jitter)
    k2_case(s_eq, PANEL, "venice S", rtol=None, backward=K2_VENICE_BACKWARD)
    del s_eq
    torch.cuda.empty_cache()

    profile_damped_solve(schur, data, g, diag)

    # K3 at venice shape: kernel, plain, plain, kernel
    swap, valid, kl = plan.swap_mask, plan.pair_valid, plan.pair_kl
    run_k = lambda: pair_products(grid, cinv_flat, swap, valid, kl, 9, 3)
    run_p = lambda: pair_products_reference(grid, cinv_flat, swap, valid, kl, 9, 3,
                                            plan.chunk_points)
    t = [cuda_ms(run_k, calls=5), cuda_ms(run_p, calls=1), cuda_ms(run_p, calls=1),
         cuda_ms(run_k, calls=5)]
    k3_ms, k3_plain = min(t[0], t[3]), min(t[1], t[2])
    moved = (plan.n_pair_rows * 81 + grid.numel() + cinv_flat.numel()) * 4 + 2 * swap.numel()
    # Y = A C^-1 for each slot, then Y A^T for each pair: multiply-adds x 2
    k3_flop = 2 * plan.np_ * (plan.kp * 9 * 3 * 3 + plan.npairs * 9 * 9 * 3)
    print(f"[timing] K3 venice shape ({plan.n_pair_rows} pair rows, {moved / 1e9:.3f} GB "
          f"moved): kernel {t[0]:.4f}/{t[3]:.4f} ms ({moved / 1e6 / k3_ms:.1f} GB/s), plain "
          f"{t[1]:.4f}/{t[2]:.4f} ms (median of 20 runs)")
    k3_cluster_ms = k3_on_cluster_plan(schur, plan, grid, cinv_flat, k3_ms, device)
    del schur, data, g, diag, grid, cinv_flat
    torch.cuda.empty_cache()

    n = 9 * VENICE["num_cameras"]
    gen = torch.Generator(device=device).manual_seed(n)
    for w in sorted({256, PANEL}):  # the first panel's shape at panel 256 and at PANEL
        time_trailing_update(n - w, w, gen, device)

    # K2 at n = 16,002 on a random SPD matrix, each panel: plain, K2, K2, plain
    m = torch.randn(n, n, generator=gen, device=device, dtype=torch.float32)
    a = m @ m.T
    a.diagonal().add_(float(n))
    del m
    times = {"plain": [cuda_ms(lambda: blocked_cholesky_factor_reference(a), calls=1)]}
    for panel in K2_TIMED_PANELS:
        times[panel] = [cuda_ms(lambda: blocked_cholesky_factor(a, panel=panel), calls=1)]
    for panel in reversed(K2_TIMED_PANELS):
        times[panel].append(cuda_ms(lambda: blocked_cholesky_factor(a, panel=panel), calls=1))
    times["plain"].append(cuda_ms(lambda: blocked_cholesky_factor_reference(a), calls=1))
    library = [cuda_ms(lambda: torch.linalg.cholesky_ex(a), calls=1) for _ in range(2)]
    print(f"[timing] K2 n={n} float32: " + ", ".join(
        f"panel {p} {t[0]:.3f}/{t[1]:.3f} ms" for p, t in times.items() if p not in ("plain",))
        + f"; plain (cuSOLVER potrf) {times['plain'][0]:.3f}/{times['plain'][1]:.3f} ms; "
        f"library torch.linalg.cholesky_ex {library[0]:.3f}/{library[1]:.3f} ms "
        "(median of 20 runs)")
    k2_case(a, PANEL, f"n={n} random SPD float32", rtol=None, backward=K2_VENICE_BACKWARD)
    fac = blocked_cholesky_factor(a)
    b = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    solve_ms = cuda_ms(lambda: blocked_chol_solve(fac, b), calls=1)
    print(f"[timing] blocked_chol_solve n={n} float32 panel {PANEL}: {solve_ms:.4f} ms "
          "(median of 20 runs; the factor apart)")
    del a, fac
    torch.cuda.empty_cache()
    return dict(k3=(k3_err, k3_ms, k3_plain, moved, k3_flop), k2=(min(times[PANEL]),
                min(times["plain"]), min(library), n), k3_cluster_ms=k3_cluster_ms)


def k3_on_cluster_plan(schur, plan, grid, cinv_flat, full_ms: float, device) -> float:
    """K3 on the CLUSTER_JACOBI plan's masks at venice shape (clusters of
    ``CLUSTER_SIZE`` cameras: most pairs invalid, another mix than the full
    plan's): the kernel against its plain version on the reduced
    unique-pair table, and its time beside the full plan's."""
    from skeres_tpu_torch.core.explicit_schur import ExplicitSchurPlan
    from skeres_tpu_torch.ops.pair_product import pair_products

    b = schur.ev.program.batches[schur.e_batch]
    t0 = time.time()
    cplan = ExplicitSchurPlan(
        cam_idx=np.asarray(b.slot_indices[schur.f_slot], dtype=np.int64),
        pt_idx=np.asarray(b.slot_indices[schur.e_slot], dtype=np.int64),
        num_cameras=schur.num_cams, num_points=schur.num_points, f_size=9, e_size=3,
        cluster_of=np.arange(schur.num_cams) // CLUSTER_SIZE, device=device)
    valid = float(cplan.pair_valid.float().mean())
    print(f"[K3] cluster plan at venice shape ({CLUSTER_SIZE} cameras a cluster): "
          f"{cplan.n_clusters} clusters, {cplan.n_uniq} unique pairs (full plan {plan.n_uniq}), "
          f"{100 * valid:.1f} % of the pair rows valid (full plan "
          f"{100 * float(plan.pair_valid.float().mean()):.1f} %), levels "
          f"{[(lv.n_dest, lv.cap) for lv in cplan.levels]}, planned in {time.time() - t0:.2f} s")
    kern, plain = k3_tables(cplan, grid, cinv_flat)
    err, rel = rel_err(kern, plain)
    print(f"[K3] cluster plan, venice shape float32: table max|err| {err:.3e} (rel {rel:.3e})")
    check(rel <= K3_RTOL[torch.float32], f"K3 cluster plan: rel error {rel:.3e}")
    check(0.0 < valid < float(plan.pair_valid.float().mean()),
          "K3 cluster plan: its masks are the full plan's")
    del kern, plain
    run = lambda: pair_products(grid, cinv_flat, cplan.swap_mask, cplan.pair_valid,  # noqa: E731
                                cplan.pair_kl, 9, 3)
    ms = min(cuda_ms(run, calls=5), cuda_ms(run, calls=5))
    print(f"[timing] K3 on the cluster plan, venice shape: {ms:.4f} ms (full plan {full_ms:.4f} ms; "
          "median of 20 runs, twice)")
    return ms


def time_trailing_update(m: int, w: int, gen, device) -> None:
    """K2's trailing update alone at the first panel's shape, float32, in
    place on a strided view of an (m + w)-row factor: the kernel (lower
    triangle, 3xTF32) against ``addmm_`` on the full square (full float32,
    the update K2 had before its kernel), in turns; effective TFLOP/s count
    the lower triangle's m (m + 1) w multiply-adds twice."""
    from skeres_tpu_torch.ops.cholesky import trailing_update_, trailing_update_reference_

    big = torch.randn(m + w, m + w, generator=gen, device=device, dtype=torch.float32)
    c = big[w:, w:]
    p = torch.randn(m, w, generator=gen, device=device, dtype=torch.float32)
    want = c.clone()
    trailing_update_reference_(want, p)
    got = c.clone()
    trailing_update_(got, p)
    torch.cuda.synchronize()
    lower = torch.ones(m, m, dtype=torch.bool, device=device).tril_()
    err, rel = rel_err(got[lower], want[lower])
    upper_same = bool(torch.equal(got[~lower], c[~lower]))
    del want, got, lower
    run_k = lambda: trailing_update_(c, p)
    run_p = lambda: c.addmm_(p, p.T, alpha=-1.0)
    t = [cuda_ms(run_p, calls=3), cuda_ms(run_k, calls=3), cuda_ms(run_k, calls=3),
         cuda_ms(run_p, calls=3)]
    ms = min(t[1], t[2])
    flop = m * (m + 1) * w
    print(f"[timing] trailing update m={m} w={w} float32: kernel {t[1]:.4f}/{t[2]:.4f} ms "
          f"({flop / ms / 1e9:.1f} TFLOP/s effective, {3 * flop / ms / 1e9:.1f} TF32 TFLOP/s), "
          f"addmm_ on the full square {t[0]:.4f}/{t[3]:.4f} ms (median of 20 runs); lower "
          f"triangle against the plain version max|err| {err:.3e} (rel {rel:.3e}), upper "
          f"triangle untouched: {upper_same}")
    check(rel <= K2_RTOL[torch.float32], f"trailing update: rel error {rel:.3e}")
    check(upper_same, "trailing update: the upper triangle changed")
    del big, p
    torch.cuda.empty_cache()


def phase_venice_solve(device, problem, program) -> tuple[int, int, float, float]:
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.types import LinearSolverType
    from skeres_tpu_torch.ops.cholesky import PANEL, cholesky_both, trailing_update_
    from skeres_tpu_torch.ops.pair_product import pair_products

    options = stt.SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_SCHUR,
        max_num_iterations=VENICE_STEPS,
        run_full_iteration_budget=True,
        dtype=torch.float32,
        device=device,
        evaluation_chunk_size=VENICE_CHUNK,
    )
    torch.cuda.reset_peak_memory_stats()
    # S has 16,002 rows: every K1 launch of this run is one of K2's panels
    cholesky_both.launches = pair_products.launches = trailing_update_.launches = 0
    s = stt.solve(options, problem, program)
    k2, k3, up = cholesky_both.launches, pair_products.launches, trailing_update_.launches
    steps = s.num_successful_steps + s.num_unsuccessful_steps
    costs = [it.cost for it in s.iterations]
    panels = math.ceil(9 * VENICE["num_cameras"] / PANEL)
    print(f"[venice-solve] path {s.schur_complement_path}; costs: {json.dumps(costs)}")
    print(f"[venice-solve] linear solver iterations: "
          f"{[it.linear_solver_iterations for it in s.iterations[1:]]}")
    print(f"[venice-solve] {steps} LM steps ({s.num_successful_steps} accepted) in "
          f"{s.minimizer_time_in_seconds:.4f} s of minimizer time: "
          f"{steps / s.minimizer_time_in_seconds:.4f} LM steps/s; preprocessor "
          f"{s.preprocessor_time_in_seconds:.4f} s, jacobian "
          f"{s.jacobian_evaluation_time_in_seconds:.4f} s, linear solver "
          f"{s.linear_solver_time_in_seconds:.4f} s, residual "
          f"{s.residual_evaluation_time_in_seconds:.4f} s, total {s.total_time_in_seconds:.4f} s")
    print(f"[venice-solve] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"[venice-solve] {s.num_linear_solves} damped solves: K3 launches {k3} "
          f"({k3 / max(s.num_linear_solves, 1):.2f} a solve), K1 panel launches inside K2 {k2} "
          f"({k2 / max(s.num_linear_solves, 1):.2f} a solve, {panels} panels a factor), "
          f"trailing-update launches {up} ({up / max(s.num_linear_solves, 1):.2f} a solve)")
    check(s.schur_complement_path == "explicit", "venice solve: not the explicit path")
    check(all(math.isfinite(c) for c in costs), "venice solve: non-finite cost")
    check(s.num_successful_steps >= 1, "venice solve: no step accepted")
    check(s.final_cost < s.initial_cost,
          f"venice solve: final cost {s.final_cost} not below initial {s.initial_cost}")
    check(k3 >= s.num_linear_solves > 0 and k2 >= panels * s.num_linear_solves
          and up >= (panels - 1) * s.num_linear_solves and up == k2 - k2 // panels,
          "venice solve: K3 or K2 did not launch on every damped solve")
    return up, k3, steps / s.minimizer_time_in_seconds, s.final_cost



# -- the device loop: one captured CUDA graph per LM step ----------------------
#
# Kernels inside the IF bodies of a CUDA graph show in a torch.profiler trace
# with their right names only in the first graph a process captures (torch
# 2.11, CUDA 12.8: in later ones they come with correlation id 0 and, after a
# few graphs, the names of other kernels). So the traced venice solve is the
# first graph of this process, and the traced BAL-49 solve runs in a child
# process of this script (``--traced-bal49``), which prints its numbers and
# the launches counted in its trace as one JSON line. Each traced solve
# checks first that no graph was captured before it in its process
# (``first_graph``), so a phase moved ahead of it fails instead of reading
# the wrong names. The cause is open (PERF.md, open questions).


def first_graph(label: str) -> None:
    from skeres_tpu_torch.core.graph import CapturedStep

    check(CapturedStep.captured == 0,
          f"{label}: {CapturedStep.captured} CUDA graphs captured before this traced solve; "
          "the trace names kernels inside IF bodies right only in a process's first graph")


def trace_launches(trace_dir: str) -> dict:
    """Kernel launches by name (``TRACE_KERNELS``) in the minimizer's
    profiler trace. With the device loop, minimize() runs these kernels
    only by replaying the captured step: the warm-up and the capture ran
    before it, in the preprocessor."""
    from skeres_tpu_torch.core.solver import TRACE_FILE

    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    counts = dict.fromkeys(TRACE_KERNELS, 0)
    for ev in events:
        if ev.get("cat") == "kernel":
            for key, pattern in TRACE_KERNELS.items():
                counts[key] += pattern in ev.get("name", "")
    return counts


def trace_dir_for(label: str) -> str:
    return os.path.join(ROOT, "build", "chip_smoke_traces", label)


def venice_options(device, solver="DENSE_SCHUR", precond="JACOBI", steps=VENICE_STEPS, **kw):
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.types import LinearSolverType, PreconditionerType

    return stt.SolverOptions(
        linear_solver_type=LinearSolverType[solver],
        preconditioner_type=PreconditionerType[precond], max_num_iterations=steps,
        run_full_iteration_budget=True, dtype=torch.float32, device=device,
        evaluation_chunk_size=VENICE_CHUNK, **kw)


def phase_venice_device_loop(device, problem, program, initial, host_rate: float) -> float:
    """The first CUDA graph of this process: the venice solve of phase 11
    with the device loop (one chunk of 5 steps), traced; then one untraced
    run, beside phase 11's host loop. Returns the traced run's LM steps/s."""
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.ops.cholesky import PANEL

    def solve(**kw):
        for g, v in zip(program.groups, initial):  # each solve writes its solution back
            g.values = v.copy()
        return stt.solve(venice_options(device, **kw), problem, program)

    loop = dict(use_device_loop=True, device_loop_chunk_iterations=VENICE_STEPS)
    trace = trace_dir_for("venice")
    first_graph("device-loop venice")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s = solve(trace_dir=trace, **loop)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = trace_launches(trace)
    steps = s.num_successful_steps + s.num_unsuccessful_steps
    costs = [it.cost for it in s.iterations]
    panels, solves = math.ceil(9 * VENICE["num_cameras"] / PANEL), s.num_linear_solves
    rate = steps / s.minimizer_time_in_seconds
    print(f"[device-loop venice] path {s.schur_complement_path}; costs: {json.dumps(costs)}")
    print(f"[device-loop venice] linear solver iterations: "
          f"{[it.linear_solver_iterations for it in s.iterations[1:]]}")
    print(f"[device-loop venice] {steps} LM steps ({s.num_successful_steps} accepted) in "
          f"{s.minimizer_time_in_seconds:.4f} s of minimizer time (traced): {rate:.4f} LM steps/s; "
          f"preprocessor {s.preprocessor_time_in_seconds:.4f} s, of which warm-up and capture "
          f"{s.device_loop_capture_time_in_seconds:.4f} s")
    print(f"[device-loop venice] peak device memory {peak:.3f} GiB (host loop, phase 11: "
          f"11.4 GiB)")
    print(f"[device-loop venice] launches inside the replays {n} for {solves} damped solves "
          f"({panels} panels a factor)")
    check(s.schur_complement_path == "explicit", "device-loop venice: not the explicit path")
    check(all(math.isfinite(c) for c in costs), "device-loop venice: non-finite cost")
    check(s.num_successful_steps >= 1, "device-loop venice: no step accepted")
    check(s.final_cost < s.initial_cost,
          f"device-loop venice: final cost {s.final_cost} not below initial {s.initial_cost}")
    check(n["IF"] >= solves > 0 and n["K3"] >= solves and n["K1"] >= panels * solves
          and n["update"] >= (panels - 1) * solves and n["update"] == n["K1"] - n["K1"] // panels,
          "device-loop venice: K3 or K2 not in the replays on every damped solve")
    r = solve(**loop)
    untraced = (r.num_successful_steps + r.num_unsuccessful_steps) / r.minimizer_time_in_seconds
    print(f"[device-loop venice] LM steps/s: host loop {host_rate:.4f} (phase 11), device loop "
          f"{untraced:.4f} untraced ({rate:.4f} traced)")
    return rate


def device_loop_card_vs_cpu(bal, label: str, device):
    """Phase 7's comparison with the device loop in chunks of 4."""
    return card_vs_cpu(device, bal, label, use_device_loop=True, device_loop_chunk_iterations=4)


def phase_device_loop_card_vs_cpu(device):
    from skeres_tpu_torch.io.bal import synthetic_bal

    card = device_loop_card_vs_cpu(synthetic_bal(16, 500, 4), "device-loop card-vs-cpu", device)
    check(card.schur_complement_path == "dense-W", "device-loop card-vs-cpu: not the dense-W path")


def phase_device_loop_explicit(device):
    from skeres_tpu_torch.core import schur as schur_mod
    from skeres_tpu_torch.io.bal import synthetic_bal

    saved = schur_mod.DENSE_W_LIMIT_BYTES
    schur_mod.DENSE_W_LIMIT_BYTES = 0  # S of 1080 rows: K3, and K2 over K1 panels
    try:
        card = device_loop_card_vs_cpu(synthetic_bal(120, 2000, 4), "device-loop explicit", device)
    finally:
        schur_mod.DENSE_W_LIMIT_BYTES = saved
    check(card.schur_complement_path == "explicit", "device-loop explicit: not the explicit path")


BAL49_DEVICE_LOOP = dict(use_device_loop=True, device_loop_chunk_iterations=30)


def traced_bal49() -> dict:
    """In a child process: bench.py's device-loop solve of BAL-49 on the
    card, its minimizer traced; the Summary's numbers and the launches."""
    from skeres_tpu_torch.io.bal import synthetic_bal

    check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.zeros(1, device="cuda")  # the context, before the solve's clock
    trace = trace_dir_for("bal49")
    first_graph("device-loop BAL-49")
    s = solve_bal(synthetic_bal(49, 7776, 4), "cuda", torch.float32, 30, trace_dir=trace,
                  **BAL49_DEVICE_LOOP)
    return dict(
        costs=[it.cost for it in s.iterations],
        linear_solver_iterations=[it.linear_solver_iterations for it in s.iterations[1:]],
        initial_cost=s.initial_cost, final_cost=s.final_cost, successful=s.num_successful_steps,
        solves=s.num_linear_solves, steps=s.num_successful_steps + s.num_unsuccessful_steps,
        minimizer_s=s.minimizer_time_in_seconds, capture_s=s.device_loop_capture_time_in_seconds,
        launches=trace_launches(trace),
    )


def spread(values) -> str:
    return (f"median {statistics.median(values):.3f}, min {min(values):.3f}, max {max(values):.3f} "
            f"({', '.join(f'{v:.3f}' for v in values)})")


def phase_device_loop_bal49(device) -> tuple[float, float]:
    """bench.py's device-loop configuration on the card. Returns the
    median LM steps/s of the device loop and of the host loop."""
    from skeres_tpu_torch.core.schur import FALLBACK_CG_ITERATIONS
    from skeres_tpu_torch.io.bal import synthetic_bal

    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--traced-bal49"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    lines = out.stdout.strip().splitlines()
    check(out.returncode == 0 and bool(lines),
          f"traced BAL-49 solve: exit {out.returncode}\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    r = json.loads(lines[-1])
    n, iters = r["launches"], r["linear_solver_iterations"]
    rungs = sum(2 if i == FALLBACK_CG_ITERATIONS else i - 1 for i in iters)
    print(f"[device-loop BAL-49] (child process) costs: {json.dumps(r['costs'])}")
    print(f"[device-loop BAL-49] linear solver iterations: {iters}")
    print(f"[device-loop BAL-49] {r['steps']} LM steps ({r['successful']} accepted), initial cost "
          f"{r['initial_cost']!r} final cost {r['final_cost']!r}; {r['steps'] / r['minimizer_s']:.3f} "
          f"LM steps/s (traced); launches inside the replays {n} for {r['solves']} damped solves "
          f"and {rungs} jitter rungs; capture {r['capture_s']:.4f} s")
    check(all(np.isfinite(r["costs"])), "device-loop BAL-49: non-finite cost")
    check(r["final_cost"] < 1e-2 * r["initial_cost"],
          f"device-loop BAL-49: final cost {r['final_cost']} not below 1e-2 x {r['initial_cost']}")
    check(r["steps"] == 30, f"device-loop BAL-49: {r['steps']} LM steps, expected 30")
    check(n["K1"] == r["solves"] + rungs and n["IF"] >= r["solves"] > 0,
          f"device-loop BAL-49: K1 ran {n['K1']} times in the replays, not once a damped solve "
          "and once a jitter rung")
    bal = synthetic_bal(49, 7776, 4)
    rates = {"device loop": [], "host loop": []}
    captures, preprocess = [], {"device loop": [], "host loop": []}
    for _ in range(TIMED_RUNS):
        for name, kw in (("device loop", BAL49_DEVICE_LOOP), ("host loop", {})):
            s = solve_bal(bal, device, torch.float32, 30, **kw)
            steps = s.num_successful_steps + s.num_unsuccessful_steps
            check(steps == 30, f"{name} BAL-49: {steps} LM steps")
            rates[name].append(steps / s.minimizer_time_in_seconds)
            preprocess[name].append(s.preprocessor_time_in_seconds)
            if kw:
                captures.append(s.device_loop_capture_time_in_seconds)
    for name, v in rates.items():
        print(f"[device-loop BAL-49] {name}: LM steps/s {spread(v)}; preprocessor s "
              f"{spread(preprocess[name])}")
    print(f"[device-loop BAL-49] capture (warm-up of every branch, the capture and the graph's "
          f"upload) s {spread(captures)}")
    return statistics.median(rates["device loop"]), statistics.median(rates["host loop"])


# -- the other linear solvers -----------------------------------------------------


def reset_launches() -> None:
    from skeres_tpu_torch.ops.cholesky import cholesky_both, trailing_update_
    from skeres_tpu_torch.ops.pair_product import pair_products

    cholesky_both.launches = trailing_update_.launches = pair_products.launches = 0


def solve_chain(n, device, dtype, iters, **kw):
    """CGNR on an anchored odometry chain of ``n`` 2-vectors with three
    long-range closures (the scene of tests/test_subset_preconditioner.py,
    with noisy closures, so that the least cost is not zero and costs can
    be compared relatively), the prior and the chain tagged for the SUBSET
    preconditioner."""
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.types import LinearSolverType, PreconditionerType

    rng = np.random.default_rng(0)
    truth = np.cumsum(rng.normal(size=(n, 2)), axis=0)
    problem = stt.Problem()
    blocks = [problem.add_parameter_block(truth[i] + rng.normal(size=2)) for i in range(n)]

    def prior(params, data):
        return 10.0 * (params[0] - data)

    def odo(params, data):
        return 5.0 * (params[1] - params[0] - data)

    ids = [problem.add_residual_block(prior, None, [blocks[0]], data=truth[0])]
    for i in range(n - 1):
        ids.append(problem.add_residual_block(odo, None, [blocks[i], blocks[i + 1]],
                                              data=truth[i + 1] - truth[i]))
    for i, j in [(0, n - 1), (2, n // 2), (1, n - 3)]:
        problem.add_residual_block(odo, None, [blocks[i], blocks[j]],
                                   data=truth[j] - truth[i] + rng.normal(size=2))
    return stt.solve(stt.SolverOptions(
        linear_solver_type=LinearSolverType.CGNR, preconditioner_type=PreconditionerType.SUBSET,
        residual_blocks_for_subset_preconditioner=ids, max_num_iterations=iters,
        run_full_iteration_budget=True, dtype=dtype, device=device, **kw), problem)


# (label, solver, preconditioner, options, cost rtol, K3 launches a damped solve)
SOLVER_CASES = (
    ("DENSE_NORMAL_CHOLESKY", "DENSE_NORMAL_CHOLESKY", "JACOBI", {}, 1e-8, 0),
    ("DENSE_NORMAL_CHOLESKY refined", "DENSE_NORMAL_CHOLESKY", "JACOBI",
     dict(use_mixed_precision_solves=True, max_num_refinement_iterations=2), 1e-8, 0),
    ("DENSE_QR", "DENSE_QR", "JACOBI", {}, 1e-8, 0),
    # CGNR's PCG runs on the whole problem's normal equations, whose condition
    # number amplifies the rounding of two summation orders: a residual test
    # falls one PCG step apart now and then, and the costs differ by 1e-5 to
    # 3e-5 from run to run
    ("CGNR JACOBI", "CGNR", "JACOBI", {}, 1e-3, 0),
    ("ITERATIVE_SCHUR JACOBI", "ITERATIVE_SCHUR", "JACOBI", {}, 1e-8, 0),
    ("ITERATIVE_SCHUR SCHUR_JACOBI", "ITERATIVE_SCHUR", "SCHUR_JACOBI", {}, 1e-8, 0),
    ("ITERATIVE_SCHUR POWER_SERIES_EXPANSION", "ITERATIVE_SCHUR", "POWER_SERIES_EXPANSION", {},
     1e-8, 0),
    ("ITERATIVE_SCHUR CLUSTER_JACOBI", "ITERATIVE_SCHUR", "CLUSTER_JACOBI",
     dict(cluster_jacobi_size=4), 1e-8, 1),
    ("ITERATIVE_SCHUR CLUSTER_TRIDIAGONAL", "ITERATIVE_SCHUR", "CLUSTER_TRIDIAGONAL",
     dict(cluster_jacobi_size=4), 1e-8, 1),
    ("ITERATIVE_SCHUR explicit S", "ITERATIVE_SCHUR", "SCHUR_JACOBI",
     dict(use_explicit_schur_complement=True), 1e-8, 1),
    ("DENSE_SCHUR refined", "DENSE_SCHUR", "JACOBI",
     dict(use_mixed_precision_solves=True, max_num_refinement_iterations=2), 1e-8, 0),
)


def phase_solvers_card_vs_cpu(device) -> dict:
    """Phase 17. Returns the kernels' launches on these paths."""
    from skeres_tpu_torch.core.schur import FALLBACK_CG_ITERATIONS
    from skeres_tpu_torch.io.bal import synthetic_bal
    from skeres_tpu_torch.ops.cholesky import cholesky_both
    from skeres_tpu_torch.ops.pair_product import pair_products

    bal = synthetic_bal(16, 500, 4)
    launches = {}
    for label, solver, precond, kw, rtol, k3_a_solve in SOLVER_CASES:
        reset_launches()
        card = card_vs_cpu(device, bal, f"solvers {label}", rtol, solver=solver, precond=precond,
                           **kw)
        k1, k3, solves = cholesky_both.launches, pair_products.launches, card.num_linear_solves
        check(card.linear_solver_type_used.value == solver
              and card.preconditioner_type_used.value == precond,
              f"solvers {label}: ran {card.linear_solver_type_used.value} with "
              f"{card.preconditioner_type_used.value}")
        check(k3 == k3_a_solve * solves, f"solvers {label}: K3 launched {k3} times for {solves} "
              f"damped solves, expected {k3_a_solve} a solve")
        # the refinement reuses K1's L^-1: one launch a damped solve and a rung
        # (two rungs on a solve that falls to the PCG)
        rungs = sum(2 if it.linear_solver_iterations == FALLBACK_CG_ITERATIONS
                    else it.linear_solver_iterations - 1 for it in card.iterations[1:])
        check(k1 == (solves + rungs if solver == "DENSE_SCHUR" else 0),
              f"solvers {label}: K1 launched {k1} times for {solves} damped solves")
        if solver == "ITERATIVE_SCHUR":
            want = "explicit" if kw.get("use_explicit_schur_complement") else "implicit"
            check(card.schur_complement_path == want, f"solvers {label}: path "
                  f"{card.schur_complement_path}")
        launches[label] = {"K1": k1, "K3": k3, "damped_solves": solves}
    card = card_vs_cpu(device, 24, "solvers CGNR SUBSET (chain)", 1e-8, solve=solve_chain)
    check(card.preconditioner_type_used.value == "SUBSET", "CGNR SUBSET downgraded")
    for label, solver, precond, rtol in (("ITERATIVE_SCHUR SCHUR_JACOBI", "ITERATIVE_SCHUR",
                                          "SCHUR_JACOBI", 1e-8), ("CGNR JACOBI", "CGNR", "JACOBI",
                                                                  1e-3)):
        card = card_vs_cpu(device, bal, f"solvers, device loop {label}", rtol, solver=solver,
                           precond=precond, use_device_loop=True, device_loop_chunk_iterations=4)
        check(card.device_loop_capture_time_in_seconds > 0.0,
              f"solvers, device loop {label}: no graph was captured")
        print(f"[solvers, device loop {label}] capture "
              f"{card.device_loop_capture_time_in_seconds:.4f} s")
    return launches


def time_s_product(device, program) -> None:
    """One implicit S product at venice shape (SCHUR_JACOBI's linearization
    by hand), and the row products it is made of, as ``einsum`` against the
    multiply-and-sum the port uses."""
    from skeres_tpu_torch.core.types import PreconditionerType

    schur, data, g, diag = linearize(program, device, torch.float32, VENICE_CHUNK, iterative=True,
                                     preconditioner=PreconditionerType.SCHUR_JACOBI)
    asm = first_assembly(schur, data, g, diag)
    v = torch.randn(schur.num_f, device=device, dtype=torch.float32,
                    generator=torch.Generator(device=device).manual_seed(1))
    ms = cuda_ms(lambda: schur._s_matvec(asm, v), calls=3)
    print(f"[timing] one implicit S product at venice shape (5 row products, 2 gathers, 2 segment "
          f"sums over {asm['per_batch'][schur.e_batch][1].shape[0]} rows): {ms:.4f} ms "
          "(median of 20 runs)")
    F, E = schur._f_block(asm), asm["per_batch"][schur.e_batch][2]
    rows = F.shape[0]
    vf = torch.randn(rows, 9, device=device)
    ve = torch.randn(rows, 3, device=device)
    u = torch.randn(rows, 2, device=device)
    forms = (
        ("F v", lambda: torch.einsum("bmt,bt->bm", F, vf), lambda: (F * vf[:, None, :]).sum(-1)),
        ("F^T u", lambda: torch.einsum("bmt,bm->bt", F, u), lambda: (F * u[:, :, None]).sum(1)),
        ("E w", lambda: torch.einsum("bmt,bt->bm", E, ve), lambda: (E * ve[:, None, :]).sum(-1)),
        ("E^T u", lambda: torch.einsum("bmt,bm->bt", E, u), lambda: (E * u[:, :, None]).sum(1)),
    )
    for name, ein, elem in forms:
        err, rel = rel_err(elem(), ein())
        t = [cuda_ms(ein, reps=10, calls=3), cuda_ms(elem, reps=10, calls=3),
             cuda_ms(elem, reps=10, calls=3), cuda_ms(ein, reps=10, calls=3)]
        print(f"[timing] row product {name} over {rows} rows float32: einsum {t[0]:.4f}/{t[3]:.4f} "
              f"ms, multiply-and-sum {t[1]:.4f}/{t[2]:.4f} ms (median of 10 runs); max|diff| "
              f"{err:.3e} (rel {rel:.3e})")
        check(rel <= 1e-5, f"row product {name}: the two forms differ by {rel:.3e}")


def iterative_solve(label, device, problem, program, initial, k3_a_solve, reference_cost=None,
                    **options):
    """One ITERATIVE_SCHUR solve of a big scene through ``stt.solve``:
    prints its numbers; every cost finite, a step accepted, the final cost
    below the initial, K3 launched ``k3_a_solve`` times a damped solve."""
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.ops.cholesky import cholesky_both, trailing_update_
    from skeres_tpu_torch.ops.pair_product import pair_products

    for grp, v in zip(program.groups, initial):  # each solve writes its solution back
        grp.values = v.copy()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    s = stt.solve(venice_options(device, "ITERATIVE_SCHUR", **options), problem, program)
    k3, solves = pair_products.launches, s.num_linear_solves
    check(cholesky_both.launches == trailing_update_.launches == 0,
          f"{label}: the iterative solver launched K1 or K2's update")
    steps = s.num_successful_steps + s.num_unsuccessful_steps
    costs = [it.cost for it in s.iterations]
    pcg = [it.linear_solver_iterations for it in s.iterations[1:]]
    beside = "" if reference_cost is None else f" (DENSE_SCHUR after the same steps: {reference_cost!r})"
    print(f"[{label}] path {s.schur_complement_path}; preconditioner "
          f"{s.preconditioner_type_used.value}; costs: {json.dumps(costs)}; final cost "
          f"{s.final_cost!r}{beside}")
    print(f"[{label}] PCG steps a damped solve: {pcg}")
    print(f"[{label}] {steps} LM steps ({s.num_successful_steps} accepted) in "
          f"{s.minimizer_time_in_seconds:.4f} s of minimizer time: "
          f"{steps / s.minimizer_time_in_seconds:.4f} LM steps/s; a damped solve "
          f"{s.linear_solver_time_in_seconds / max(solves, 1):.4f} s; preprocessor "
          f"{s.preprocessor_time_in_seconds:.4f} s, jacobian "
          f"{s.jacobian_evaluation_time_in_seconds:.4f} s, residual "
          f"{s.residual_evaluation_time_in_seconds:.4f} s")
    print(f"[{label}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; K3 "
          f"launches {k3} for {solves} damped solves (expected {k3_a_solve} a solve)")
    check(all(math.isfinite(c) for c in costs), f"{label}: non-finite cost")
    check(s.num_successful_steps >= 1, f"{label}: no step accepted")
    check(s.final_cost < s.initial_cost, f"{label}: final cost {s.final_cost} not below initial")
    check(k3 == k3_a_solve * solves and solves > 0,
          f"{label}: K3 launched {k3} times for {solves} damped solves")
    return s, {"K1": cholesky_both.launches, "K2 update": trailing_update_.launches, "K3": k3}


VENICE_ITERATIVE = (
    ("implicit SCHUR_JACOBI", "implicit", 0, dict(precond="SCHUR_JACOBI")),
    ("explicit S SCHUR_JACOBI", "explicit", 1,
     dict(precond="SCHUR_JACOBI", use_explicit_schur_complement=True)),
    ("implicit CLUSTER_JACOBI", "implicit", 1,
     dict(precond="CLUSTER_JACOBI", cluster_jacobi_size=CLUSTER_SIZE)),
)


def phase_venice_iterative(device, problem, program, initial, reference_cost) -> dict:
    """Phase 18. Returns the kernels' launches by path."""
    time_s_product(device, program)
    launches = {}
    for name, path, k3_a_solve, options in VENICE_ITERATIVE:
        label = f"venice ITERATIVE_SCHUR {name}"
        s, counts = iterative_solve(label, device, problem, program, initial, k3_a_solve,
                                    reference_cost, **options)
        check(s.schur_complement_path == path, f"{label}: path {s.schur_complement_path}")
        check(s.preconditioner_type_used.value == options["precond"],
              f"{label}: the preconditioner was downgraded")
        launches[label] = counts
    return launches


def phase_past_cap(device) -> dict:
    """Phase 19: 4000 cameras, S (36,000 rows, 5.2 GB) past the explicit
    gate and K2's 32,768 rows; never formed."""
    from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal

    t0 = time.time()
    bal = synthetic_bal(**PAST_CAP)
    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()
    print(f"[past-cap] synthetic_bal{tuple(PAST_CAP.values())}: {bal.num_observations} "
          f"observations, S would have {9 * bal.num_cameras} rows; scene and compile "
          f"{time.time() - t0:.2f} s")
    initial = [g.values.copy() for g in program.groups]
    launches = {}
    for precond, k3_a_solve in (("SCHUR_JACOBI", 0), ("CLUSTER_JACOBI", 1),
                                ("CLUSTER_TRIDIAGONAL", 1)):
        label = f"past-cap ITERATIVE_SCHUR {precond}"
        # the explicit S is asked for: the gate refuses it and says why
        s, counts = iterative_solve(label, device, problem, program, initial, k3_a_solve,
                                precond=precond, cluster_jacobi_size=CLUSTER_SIZE,
                                steps=PAST_CAP_STEPS, use_explicit_schur_complement=True)
        check(s.schur_complement_path.startswith("implicit (gate: S too large"),
              f"{label}: path {s.schur_complement_path!r} does not name the gate")
        check(s.preconditioner_type_used.value == precond, f"{label}: downgraded")
        launches[label] = counts
    return launches


def bound(nbytes: float, flop: float, flops_per_s: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / flops_per_s
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    if sys.argv[1:] == ["--traced-bal49"]:
        print(json.dumps(traced_bal49()))
        return 0
    t_start = time.time()
    phase_device()
    device = "cuda"
    from skeres_tpu_torch.ops.cholesky import PANEL

    times = {}  # wall seconds of each phase

    def timed(label, fn, *args):
        t0 = time.time()
        out = fn(*args)
        times[label] = round(time.time() - t0, 1)
        return out

    timed("build", phase_build)
    k1_err = timed("K1", phase_k1, device)
    k2_err = timed("K2", phase_k2, device)
    timed("K3", phase_k3, device)
    k1_launches = timed("solve", phase_solve, device)
    timed("card vs CPU", phase_card_vs_cpu, device)
    timed("explicit vs dense W", phase_explicit_vs_dense_w, device)
    timed("card vs CPU explicit", phase_card_vs_cpu_explicit, device)
    problem, program = timed("venice scene", venice_scene)
    venice = timed("venice", phase_venice, device, program)
    initial = [g.values.copy() for g in program.groups]
    up_launches, k3_launches, venice_host_rate, venice_cost = timed(
        "venice solve", phase_venice_solve, device, problem, program)
    # phase 16 before any other graph: its traced solve must be this
    # process's first CUDA graph (see the note above trace_launches)
    timed("device loop venice", phase_venice_device_loop, device, problem, program, initial,
          venice_host_rate)
    venice_paths = timed("venice iterative", phase_venice_iterative, device, problem, program,
                            initial, venice_cost)
    del problem, program, initial
    torch.cuda.empty_cache()
    big_paths = {**venice_paths, **timed("past cap", phase_past_cap, device)}
    torch.cuda.empty_cache()
    k1_ms, k1_plain = timed("timing", phase_timing, device)
    timed("device loop card vs CPU", phase_device_loop_card_vs_cpu, device)
    timed("device loop explicit", phase_device_loop_explicit, device)
    timed("device loop BAL-49", phase_device_loop_bal49, device)
    solver_paths = timed("solvers card vs CPU", phase_solvers_card_vs_cpu, device)
    k3_err, k3_ms, k3_plain, k3_bytes, k3_flop = venice["k3"]
    k2_ms, k2_plain, k2_library, k2_n = venice["k2"]
    n1 = 9 * 49  # K1's n on the main path: the BAL-49 S
    # bytes: K1 and K2 read A's lower triangle, n(n+1)/2 elements; K1
    # writes L and L^-1 (n x n each), K2 L (n x n) and its panels' inverses
    k1_bound = bound((n1 * (n1 + 1) // 2 + 2 * n1 * n1) * 4, 2 * n1**3 / 3, F32_3XTF32_FLOPS)
    k2_panels = [min(PANEL, k2_n - off) for off in range(0, k2_n, PANEL)]
    k2_bound = bound((k2_n * (k2_n + 1) // 2 + k2_n * k2_n + sum(w * w for w in k2_panels)) * 4,
                     k2_n**3 / 3, F32_3XTF32_FLOPS)
    k3_bound = bound(k3_bytes, k3_flop, 67e12)  # float32 outside the tensor cores
    print(f"[done] wall time {time.time() - t_start:.1f} s; by phase: {json.dumps(times)}")
    print(json.dumps({"kernels": [
        {
            "name": "cholesky_inverse_factor (K1)",
            "route": "cuda",
            "source": "skeres_tpu_torch/csrc/cholesky.cu",
            "replaces": "skeres_tpu/ops/pallas/cholesky.py:98",
            "launches": k1_launches,
            "launches_by_path": {"BAL-49 DENSE_SCHUR": k1_launches, **{
                f"synthetic_bal(16, 500, 4) {k}": v["K1"] for k, v in solver_paths.items()}},
            "max_abs_err": k1_err,
            "ms": k1_ms,
            "plain_ms": k1_plain,
            "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1],
            "library_ms": None,
        },
        {
            "name": "blocked_cholesky_factor (K2; launches: its trailing-update kernel's)",
            "route": "cuda",
            "source": "skeres_tpu_torch/csrc/cholesky.cu",
            "replaces": "skeres_tpu/ops/pallas/cholesky.py:249",
            "launches": up_launches,
            "launches_by_path": {"venice DENSE_SCHUR": up_launches,
                                 **{k: v["K2 update"] for k, v in big_paths.items()}},
            "max_abs_err": k2_err,
            "ms": k2_ms,
            "plain_ms": k2_plain,
            "bound_ms": k2_bound[0],
            "bound_by": k2_bound[1],
            "library_ms": k2_library,
        },
        {
            "name": "pair_products (K3)",
            "route": "cuda",
            "source": "skeres_tpu_torch/csrc/pair_product.cu",
            "replaces": "skeres_tpu/ops/pallas/pair_product.py:49",
            "launches": k3_launches,
            "launches_by_path": {"venice DENSE_SCHUR": k3_launches,
                                 **{k: v["K3"] for k, v in big_paths.items()}, **{
                f"synthetic_bal(16, 500, 4) {k}": v["K3"] for k, v in solver_paths.items()}},
            "max_abs_err": k3_err,
            "ms": k3_ms,
            "cluster_plan_ms": venice["k3_cluster_ms"],
            "plain_ms": k3_plain,
            "bound_ms": k3_bound[0],
            "bound_by": k3_bound[1],
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
