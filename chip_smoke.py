#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (skeres_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure raises, the script exits
non-zero and prints no result line):

  1. device  — a CUDA card is present; print its name and power limit;
               TF32 off for matmuls and cuDNN.
  2. build   — compile K1 and K2's trailing update (csrc/cholesky.cu), K3
               (csrc/pair_product.cu), the S product's pair
               (csrc/s_product.cu) and K1 with its clock64 phase counters
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
               non-uniform problem (f = 5 and 6, e = 3, 1-6 observations per
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
 15. device loop, BAL-49 — 30 steps in one chunk of 30, the full
               iteration budget, float32, its minimizer traced
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
 20. venice, dogleg — the venice scene, DENSE_SCHUR, 5 steps each with
               TRADITIONAL_DOGLEG and SUBSPACE_DOGLEG (host loop): LM
               steps/s, final cost, accepted steps, the Gauss-Newton solves'
               iterations and jitter rungs, the steps that took the Cauchy
               point, K3 and K2's update launches (one K3 and one factor a
               Gauss-Newton solve and a rung: the dogleg step solves
               nothing), beside phase 11's LM.
 21. venice, inner iterations — LM DENSE_SCHUR with ``use_inner_iterations``
               on the host loop and the device loop (the tolerance-stopped
               sweeps one WHILE node of the step's graph): LM steps/s, final
               cost, ``num_inner_iteration_steps``, capture time and peak
               memory, beside phases 11 and 16 without them.
 22. venice, the Problem API — camera 0 constant (the gauge) and a
               SubsetManifold holding f, k1 and k2 on every camera: the
               camera tangent is 6, S has 10,668 rows (explicit, K3 at
               (f, e) = (6, 3), K2 over 21 panels). K3 at that shape
               against its plain version and timed (this is where phase 10's
               K3 check meets the (6, 3) instance); then the solve on the
               host loop and the device loop, camera 0 and the intrinsics
               unchanged after it.
 23. trust region and Problem API, card vs CPU — synthetic_bal(16, 500, 4),
               float64, 10 steps at initial radius 1, card against CPU: both
               dogleg types on the dense-W and the explicit path (cameras 0
               and 1 constant: the gauge fixed), inner
               iterations on both loops, the focal lengths bounded on both
               loops, camera 0 constant with a SubsetManifold on both loops;
               the same decisions and costs to rtol 1e-8.
 24. pose graph — synthetic_sphere(2500) (sphere2500, BASELINE config 3:
               2,500 SE(3) poses with the Eigen-quaternion manifold, 2,548
               edges, pose 0 constant), SPARSE_NORMAL_CHOLESKY (CGNR),
               JACOBI, up to 100 LM steps on the host loop and the device
               loop in float32 and float64 (check_gradients on the float64
               host loop): chi^2 before and after, LM steps/s, termination;
               the gradient check alone, timed; the float64 trajectory
               against the CPU's (CGNR's bound of phase 17, 1e-3; whether it
               holds 1e-8 is printed); the 2-D square loop of
               tests/test_pose_graph.py card against CPU, at its ground truth.
 25. venice line search — the venice scene of phases 10-11 from its
               initial values, MinimizerType.LINE_SEARCH (Ceres
               ``bundle_adjuster --line_search``): L-BFGS rank 20, Wolfe
               steps, float32, 30 iterations: iterations/s, step-search
               evaluations an iteration, the final cost beside phase 11's
               LM, peak memory. Then every direction type with Armijo and
               Wolfe steps on synthetic_bal(16, 500, 4), float64, 20
               iterations, card against CPU (the same iterations, evaluations
               and decisions, costs to rtol 1e-8), and GradientProblem on
               Rosenbrock and on the sphere manifold.
 26. covariance — SCHUR_COMPLEMENT, float64, on phase 22's calibrated
               venice scene at its host-loop solution: S of 10,668 rows by
               the explicit path (K3 at (6, 3) in float64, once, then held
               against its plain version on the same inputs),
               null_space_rank 1 (the gauge's scale), the predicted rank
               10,661; compute(), its eigh and three block queries timed.
               DENSE_SVD on sphere2500 after its float64 solve: J^T J over
               15,000 tangent coordinates (1.8 GB), compute() and its eigh
               timed. The scene of tests/test_covariance_gradient.py: both
               algorithms on both S paths, against each other and card
               against CPU.
 27. scoreboards — the 42 MGH cases and the 34 embedded NIST starts,
               float64, DENSE_QR, with the options of tests/test_mgh.py and
               tests/test_nist.py, on the card; the same on the CPU in a
               child process started after phase 1 (``chip_smoke.py
               --scoreboards-cpu``); the card must certify the same cases.
               Phases 25 and 26 need the venice scene, whose host data lives
               on from phase 10 to 26.

 28. split BAL-49 — synthetic_bal(49, 7776, 4) with each camera split into
               a pose (6) and an intrinsics (3) block: two retained groups,
               so S (441 rows) comes from the column probe, K1 factors it.
               float64, 30 steps, host loop and device loop, against the
               unsplit (dense-W) solve on the card: every step's cost to
               rtol 1e-8, the unsplit final cost phase 6's 4801.92 (rtol
               1e-5); then LM steps/s of both loops in float32.
 29. Dubrovnik shape — synthetic_bal(356, 226_730, 5) (the counts of BAL
               problem-356-226730, 1,133,650 observations), split: S of
               3,204 rows by the probe in 26 chunks, K2 over 7 panels;
               float64, 5 steps, both loops, against the unsplit scene on
               the explicit path (K3 at (9, 3) in float64, K2): every step's
               cost to rtol 1e-8; the probe's and a damped solve's time, the
               peak memory, K2's launches.
 30. split venice — the venice scene of phases 10-26 split (run right after
               phase 19, while its host data lives): one generic S product
               timed (beside phase 18's unsplit one), one chunk of the column
               probe timed and two of its columns held against S e_j;
               ITERATIVE_SCHUR with SCHUR_JACOBI, float32, 5 steps, both
               loops. A DENSE_SCHUR solve (126 chunks, then K2 at 16,002) is
               not run.
 31. general structure, card vs CPU — float64: the three-signature problem
               of tests/test_schur_general.py, the same with the points
               declared between the two retained groups, and the ellipse
               (rows of three slots); DENSE_SCHUR (the probe, K1) and
               ITERATIVE_SCHUR with JACOBI, SCHUR_JACOBI and
               POWER_SERIES_EXPANSION on both loops, 9 steps at initial
               radius 1: the same decisions, costs to rtol 1e-8; the
               SCHUR_COMPLEMENT covariance (S by the probe) against DENSE_SVD,
               card and CPU, to 1e-8 of a block's largest entry.
 32. tools — in subprocesses ``python -m skeres_tpu_torch.cli.bundle_adjuster
               --num_cameras 49 --num_points 7776 --max_iterations 30`` (final
               cost phase 6's), ``pose_graph_3d --num_poses 2500`` (chi^2
               phase 24's 270.37) and ``pose_graph_2d`` on a square loop
               written to a temporary directory; then every
               ``examples_torch`` script's ``main()`` on the card by default,
               each with the assertion of its test.

 33. DENSE_QR device loop — float64, DENSE_QR under ``use_device_loop``
               (its step by the corrected seminormal equations, captured in
               the step's IF node) against the host loop's Householder QR on
               the card: synthetic_bal(6, 60, 4) (10 steps at radius 1) and
               the MGH cases bard, osborne1 and watson_n6 (up to 100 steps):
               the same decisions, costs to rtol 1e-8, MGH certified.
 34. mesh, BAL-49 — the ``obs`` mesh (``skeres_tpu_torch.parallel``) on 3
               gloo ranks sharing the card, each a process of this script
               (``--mesh-rank``; NCCL refuses two ranks on one card):
               BAL-49 in float64, DENSE_SCHUR on the sharded explicit path,
               against the unsharded (dense-W) card solve to 1e-10 a step,
               every rank's costs, decisions and factor bit for bit equal;
               on every rank K3 against its plain version on its grid and
               the straddle grid, K1 on the replicated S against its plain
               version; n_straddle printed. Then ``dryrun_multichip(3,
               "cuda:0")`` (parallel/dryrun.py: the JAX entry's scene, one
               step, K3 on grid and fixup, K2 on S of 1,800 rows) against
               the unsharded step to 1e-10.
 35. mesh, venice shape — synthetic_bal(1778, 1_000_000, 5) with cameras 0
               and 1 constant, 3 gloo ranks on the card, DENSE_SCHUR on the
               explicit path, 5 LM steps on the host loop: float64 against
               the unsharded card solve to 1e-8 a step with the same
               decisions; then float32, its start and first step to 1e-3
               of the unsharded solve's, each later step to 1e-2 while the
               two take the same decisions with no jitter rung (a rung's
               step parts them on the order of their sums), and both final
               costs at most 1.4x the float64 solve's: per rank K3 on its grid
               timed and held to its plain version, K2 on the replicated S
               held to ``cholesky_ex`` (backward error on rank 0), the
               collectives of a LM step (count, bytes, ms, timed one by one),
               LM steps/s and peak memory; n_straddle > 0.
 36. mesh, NCCL device loop — one NCCL rank (a child process): the device
               loop under the mesh, its all_reduces captured in the step's
               conditional nodes, against the unsharded device loop, both on
               the explicit path with cameras 0 and 1 constant: BAL-49 30
               steps (float64 to 1e-10 a step; float32 LM steps/s in turns)
               and the venice shape 5 steps (float64 to 1e-10, LM steps/s).

 37. venice, the camera-padded layout — run right after phase 30, while the
               venice scene lives: the layout's plan (nc, K, the waste, the
               placed copy's bytes, the plan's set-up seconds); the padded S
               product on the minimizer's path (unscaled placed rows, the
               Jacobi scale conjugated) against the generic one, float64
               within 1e-12, both timed in float32 (CUDA events, median of 20,
               in turns), with g and diag (the placement gather against the
               ``index_add_`` camera sums) and one whole linearization; the
               float64 trajectories of DENSE_SCHUR and ITERATIVE_SCHUR
               (SCHUR_JACOBI) with cameras 0 and 1 constant from initial
               radius 1, layout against ``jacobian_sort_threshold=10**12``,
               5 steps: the same decisions, within 1e-8 a step, and the padded
               ITERATIVE_SCHUR solve launching each of the S product's
               kernels once a product (the generic one none), and each of
               the four launching the Snavely kernel once a row chunk of a
               linearization and its residual-only mode once a chunk of a
               cost evaluation; float32 DENSE_SCHUR LM steps/s
               of both forms on the host loop and the device loop (medians of
               3, in turns) and each form's gap between identical runs.
               The layout is on by default past 100,000 rows, so phases
               10-11, 16, 18-22, 26, 29 (its unsplit reference) and 34-36
               take it; phase 18 times the generic S product.

 38. measuring scripts — each script of ``tools_torch`` in a subprocess with
               no ``--device`` (so on the card), its last line parsed as JSON:
               ``bench_sphere.py`` and ``bench_two_signature.py`` at their
               default sizes, ``bench_scaling.py --shards 1 2 4`` (in two
               lanes side by side, the sphere and the ranks beside the
               rest): the value finite and positive, every timed solve's
               final cost below its initial cost, ``extra.device`` the card,
               no kernel launch on their paths.

 39. spans and stamps — BAL-49 float64 on the device loop under
               ``torch.profiler`` (CPU and CUDA): the port's ``skeres.*``
               spans on the host and no device event of those names (the
               spans are of the function scope, so the trace mirrors none
               onto the card); the stamped ``Summary`` timers above 0, each
               iteration's times, cumulative times that increase, one replay
               counted for each of a chunk's; the evaluation timers split
               into the stamped part and the host's first linearization,
               and each span's count, host time and device time launched
               (``tools_torch/trace_spans.py:span_table``), the chunks'
               above 0; then 1024 stamps back to back
               inside one CUDA graph, in order, and the smallest step
               between two of them (``%globaltimer``'s resolution bounds it).

 40. S product — the implicit Schur product's kernel pair
               (``csrc/s_product.cu``) at the camera-padded shapes of BAL
               venice-1778 and Final-13682 (their cameras, their points'
               observation counts, float64; rows drawn on the card, each
               row's camera uniform, so K lands near the cells' 3008 and
               2299): the pair against its plain version (1e-12 of
               max|S v|), a second call bit for bit; each pass, the pair
               and the plain version timed (CUDA events, median of 20, in
               turns), beside the bound of the benchmark's
               ``roofline_implicit.s_product_counts``.

 41. camera blocks — the camera blocks' kernel (``csrc/s_product.cu``,
               ``camera_blocks``) at the same two padded shapes, float64,
               with an SPD C^-1 and s_e: against its plain version (1e-12
               of max|block|), a second call bit for bit, each block
               symmetric; both timed (CUDA events, median of 20, in turns)
               beside the bytes it must read (the placed rows that hold
               observations, their points, C^-1 and s_e once, the blocks
               written) and, as a second count, with each row's C^-1 and
               s_e gather. Phase 37's padded solves launch the kernel once
               a damped solve (the generic form none).

 42. visibility — the benchmark's Final-4585 site scene (4,585 cameras,
               9,125,125 observations) on the card: the visibility plan
               (``core/visibility.py``, CANONICAL_VIEWS, the forest's
               chains) timed on its second run, its clusters, chains,
               longest chain, slot sizes and padded share; the
               CLUSTER_TRIDIAGONAL build and factor
               (``cluster_preconditioner``) and the chain apply
               (``apply_cluster_preconditioner``) timed (CUDA events), the
               apply against its plain version (``dense_cluster_solve``:
               each chain's matrix dense, ``torch.linalg.solve``) to 1e-8.

 43. reprojection — the Snavely residual's kernel (``csrc/reprojection.cu``,
               ``snavely_rows`` and its residual-only mode
               ``snavely_costs``) at BAL venice-1778's and Final-13682's
               counts (cameras, points, observations; rows grouped by
               point, each row's camera uniform; float64): against its
               plain version (r within 1e-14 of |r| + |observation|, J of
               each row's largest |entry|), a second call bit for bit; the
               kernel in both modes and the plain version timed (CUDA
               events, median of 20, in turns) beside the bytes they must
               move; then the evaluator's linearization (``blocks``) and
               cost at the cells' chunking (Final 28 chunks of 1,048,576
               rows, venice one) through the kernel and through the vmapped
               autodiff it replaced (an Evaluator on the same residual
               without its batched form), in turns, with one launch of
               each mode a chunk checked, and the two Jacobians compared.

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

    from skeres_tpu_torch.ops import cholesky, pair_product, reprojection, s_product
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
    s_product.build_kernels()
    reprojection.build_kernels()


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

    e, npts, nc = 3, 4000, 40
    for f in (5, 6):
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
            kern, plain = k3_tables(plan, grid.contiguous(),
                                    torch.as_tensor(cinv, dtype=dtype, device=device))
            err, rel = rel_err(kern, plain)
            print(f"[K3] random f={f} e=3 kp={plan.kp} (1-6 obs/point, {npts} points, "
                  f"{plan.n_uniq} pairs) {dtype}: table max|err| {err:.3e} (rel {rel:.3e})")
            check(rel <= K3_RTOL[dtype], f"K3 random case f={f} {dtype}: rel error {rel:.3e}")


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
    problem, cams, _ = build_bal_problem(bal)
    program = problem.compile()
    t_compile = time.time() - t0
    print(f"[venice] synthetic_bal{tuple(VENICE.values())}: {bal.num_cameras} cameras, "
          f"{bal.num_points} points, {bal.num_observations} observations; host time: "
          f"generate {t_gen:.2f} s, build and compile the problem {t_compile:.2f} s")
    return problem, program, cams


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
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[venice-solve] peak device memory {peak:.3f} GiB")
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
    return up, k3, dict(rate=steps / s.minimizer_time_in_seconds, cost=s.final_cost, peak=peak,
                        accepted=[it.step_is_successful for it in s.iterations])


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


def venice_options(device, solver="DENSE_SCHUR", precond="JACOBI", steps=VENICE_STEPS,
                   dtype=torch.float32, **kw):
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.types import LinearSolverType, PreconditionerType

    return stt.SolverOptions(
        linear_solver_type=LinearSolverType[solver],
        preconditioner_type=PreconditionerType[precond], max_num_iterations=steps,
        run_full_iteration_budget=True, dtype=dtype, device=device,
        evaluation_chunk_size=VENICE_CHUNK, **kw)


def phase_venice_device_loop(device, problem, program, initial, host_rate: float) -> dict:
    """The first CUDA graph of this process: the venice solve of phase 11
    with the device loop (one chunk of 5 steps), traced; then one untraced
    run, beside phase 11's host loop. Returns the untraced run's LM
    steps/s, final cost, capture seconds and peak GiB."""
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
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = solve(**loop)
    untraced = (r.num_successful_steps + r.num_unsuccessful_steps) / r.minimizer_time_in_seconds
    print(f"[device-loop venice] LM steps/s: host loop {host_rate:.4f} (phase 11), device loop "
          f"{untraced:.4f} untraced ({rate:.4f} traced)")
    return dict(rate=untraced, cost=r.final_cost, capture=r.device_loop_capture_time_in_seconds,
                peak=torch.cuda.max_memory_allocated() / 2**30)


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
    """In a child process: the device-loop solve of BAL-49 on the card,
    its minimizer traced; the Summary's numbers and the launches."""
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


def phase_device_loop_bal49(device) -> None:
    """BAL-49's device-loop configuration (``BAL49_DEVICE_LOOP``) on the
    card, traced, then LM steps/s of the device loop and the host loop."""
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


# -- the other linear solvers -----------------------------------------------------


def reset_launches() -> None:
    from skeres_tpu_torch.ops.cholesky import cholesky_both, trailing_update_
    from skeres_tpu_torch.ops.pair_product import pair_products
    from skeres_tpu_torch.ops.reprojection import snavely_costs, snavely_rows
    from skeres_tpu_torch.ops.s_product import camera_blocks, camera_sums, point_sums

    cholesky_both.launches = trailing_update_.launches = pair_products.launches = 0
    point_sums.launches = camera_sums.launches = camera_blocks.launches = 0
    snavely_rows.launches = snavely_costs.launches = 0


def launch_counts() -> dict:
    from skeres_tpu_torch.ops.cholesky import cholesky_both, trailing_update_
    from skeres_tpu_torch.ops.pair_product import pair_products
    from skeres_tpu_torch.ops.reprojection import snavely_costs, snavely_rows
    from skeres_tpu_torch.ops.s_product import camera_blocks, camera_sums, point_sums

    return {"K1": cholesky_both.launches, "K2 update": trailing_update_.launches,
            "K3": pair_products.launches, "S point": point_sums.launches,
            "S camera": camera_sums.launches, "S blocks": camera_blocks.launches,
            "Snavely rows": snavely_rows.launches, "Snavely costs": snavely_costs.launches}


# the Snavely residual's kernel, on every path that evaluates an unsplit
# Euclidean BAL batch (check_no_launches leaves it out there)
SNAVELY = ("Snavely rows", "Snavely costs")


def check_snavely_launches(label: str, s, n: dict) -> dict:
    """One launch of the Snavely kernel a row chunk of a linearization
    (``Summary.num_evaluation_chunks``), and of its residual-only mode a
    chunk of each cost evaluation of a host-loop LM solve. Returns the
    chunks of each kind."""
    per_linearization = s.num_evaluation_chunks // max(s.num_jacobian_evaluations, 1)
    want = (s.num_evaluation_chunks, per_linearization * s.num_residual_evaluations)
    got = (n["Snavely rows"], n["Snavely costs"])
    print(f"[{label}] Snavely kernel launches (rows, costs) {got}: {s.num_evaluation_chunks} "
          f"chunks over {s.num_jacobian_evaluations} linearizations, "
          f"{s.num_residual_evaluations} cost evaluations")
    check(s.num_evaluation_chunks == per_linearization * s.num_jacobian_evaluations > 0
          and got == want, f"{label}: Snavely launches {got}, expected {want}")
    return {"linearization chunks": want[0], "cost chunks": want[1]}


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

    # the generic product (phase 37 times it beside the camera-padded one)
    schur, data, g, diag = linearize(program, device, torch.float32, VENICE_CHUNK, iterative=True,
                                     preconditioner=PreconditionerType.SCHUR_JACOBI,
                                     sort_threshold=10**12)
    asm = first_assembly(schur, data, g, diag)
    v = torch.randn(schur.num_f, device=device, dtype=torch.float32,
                    generator=torch.Generator(device=device).manual_seed(1))
    ms = cuda_ms(lambda: schur._s_matvec(asm, v), calls=3)
    print(f"[timing] one generic implicit S product at venice shape (5 row products, 2 gathers, "
          f"2 segment sums over {asm['per_batch'][schur.e_batch][1].shape[0]} rows): {ms:.4f} ms "
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
    return s, launch_counts()


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


# -- the rest of the trust region and the Problem API (phases 20-23) ---------------


def rungs_of(iters) -> int:
    """Jitter rungs behind DENSE_SCHUR linear solver iteration counts: a
    solve counts 1 + its rungs, or the PCG fallback after two rungs."""
    from skeres_tpu_torch.core.schur import FALLBACK_CG_ITERATIONS

    return sum(2 if i == FALLBACK_CG_ITERATIONS else i - 1 for i in iters)


def venice_solve(label, device, problem, program, initial, **options):
    """One venice-shape DENSE_SCHUR solve through ``stt.solve`` from the
    initial values, its numbers printed; every cost finite, a step
    accepted, the final cost below the initial. Returns (Summary, launches,
    peak GiB, LM steps/s)."""
    import skeres_tpu_torch as stt

    for grp, v in zip(program.groups, initial):  # each solve writes its solution back
        grp.values = v.copy()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    s = stt.solve(venice_options(device, **options), problem, program)
    n = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = s.num_successful_steps + s.num_unsuccessful_steps
    rate = steps / s.minimizer_time_in_seconds
    costs = [it.cost for it in s.iterations]
    print(f"[{label}] path {s.schur_complement_path}; costs: {json.dumps(costs)}")
    print(f"[{label}] {steps} LM steps ({s.num_successful_steps} accepted) in "
          f"{s.minimizer_time_in_seconds:.4f} s of minimizer time: {rate:.4f} LM steps/s; final "
          f"cost {s.final_cost!r}; preprocessor {s.preprocessor_time_in_seconds:.4f} s (capture "
          f"{s.device_loop_capture_time_in_seconds:.4f} s), jacobian "
          f"{s.jacobian_evaluation_time_in_seconds:.4f} s, linear solver "
          f"{s.linear_solver_time_in_seconds:.4f} s, residual "
          f"{s.residual_evaluation_time_in_seconds:.4f} s; peak device memory {peak:.3f} GiB")
    check(all(math.isfinite(c) for c in costs), f"{label}: non-finite cost")
    check(s.num_successful_steps >= 1, f"{label}: no step accepted")
    check(s.final_cost < s.initial_cost, f"{label}: final cost {s.final_cost} not below initial")
    return s, n, peak, rate


def phase_venice_dogleg(device, problem, program, initial, lm: dict) -> dict:
    """Phase 20. ``lm``: phase 11's LM numbers. Returns the launches by path."""
    from skeres_tpu_torch.core.types import DoglegType, TrustRegionStrategyType
    from skeres_tpu_torch.ops.cholesky import PANEL

    panels = math.ceil(9 * VENICE["num_cameras"] / PANEL)
    launches = {}
    for dogleg in ("TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"):
        label = f"venice {dogleg}"
        s, n, _, rate = venice_solve(label, device, problem, program, initial,
                                     trust_region_strategy_type=TrustRegionStrategyType.DOGLEG,
                                     dogleg_type=DoglegType[dogleg])
        gn = s.dogleg_gauss_newton_iterations
        steps = s.num_successful_steps + s.num_unsuccessful_steps
        print(f"[{label}] Gauss-Newton solves {len(gn)} (one a linearization), their linear "
              f"solver iterations {gn}: {rungs_of(gn)} jitter rungs; steps that took the Cauchy "
              f"point {s.num_dogleg_cauchy_steps} of {steps}; K3 launches {n['K3']} "
              f"({n['K3'] / len(gn):.2f} a Gauss-Newton solve), K1 panel launches inside K2 "
              f"{n['K1']}, trailing-update launches {n['K2 update']} "
              f"({n['K2 update'] / len(gn):.2f} a Gauss-Newton solve, {panels} panels a factor)")
        print(f"[{label}] beside LM (phase 11): LM steps/s {rate:.4f} against {lm['rate']:.4f}; "
              f"final cost {s.final_cost!r} against {lm['cost']!r}")
        check(s.schur_complement_path == "explicit", f"{label}: not the explicit path")
        check(len(gn) == s.num_successful_steps + 1, f"{label}: {len(gn)} Gauss-Newton solves")
        check(n["K3"] == len(gn), f"{label}: K3 launched {n['K3']} times for {len(gn)} "
              "Gauss-Newton solves")
        check(n["K2 update"] >= (panels - 1) * len(gn)
              and n["K2 update"] == n["K1"] - n["K1"] // panels,
              f"{label}: K2 did not factor once a Gauss-Newton solve")
        launches[label] = n
    return launches


def phase_venice_inner(device, problem, program, initial, lm: dict, lm_device: dict) -> dict:
    """Phase 21. ``lm``, ``lm_device``: phases 11 and 16's LM numbers.
    Returns the host loop's launches."""
    launches = {}
    for loop, kw, base in (
            ("host loop", {}, lm),
            ("device loop", dict(use_device_loop=True, device_loop_chunk_iterations=VENICE_STEPS),
             lm_device)):
        label = f"venice inner iterations, {loop}"
        s, n, peak, rate = venice_solve(label, device, problem, program, initial,
                                        use_inner_iterations=True, **kw)
        print(f"[{label}] num_inner_iteration_steps {s.num_inner_iteration_steps} (counted as "
              f"the JAX package counts them); beside LM without inner iterations (phase "
              f"{11 if loop == 'host loop' else 16}): LM steps/s {rate:.4f} against "
              f"{base['rate']:.4f}, final cost {s.final_cost!r} against {base['cost']!r}, peak "
              f"{peak:.3f} against {base['peak']:.3f} GiB"
              + (f", capture {s.device_loop_capture_time_in_seconds:.4f} against "
                 f"{base['capture']:.4f} s" if kw else ""))
        if not kw:
            check(n["K3"] == s.num_linear_solves, f"{label}: K3 launched {n['K3']} times")
            launches[label] = n
        else:
            check(s.device_loop_capture_time_in_seconds > 0.0, f"{label}: no graph captured")
    return launches


def phase_venice_problem_api(device, problem, program, cams, initial, lm: dict) -> dict:
    """Phase 22. Returns the host loop's launches, K3's numbers at (f, e) =
    (6, 3) and the host loop's solution (where phase 26 takes the
    covariance)."""
    from skeres_tpu_torch.models.manifolds import SubsetManifold
    from skeres_tpu_torch.ops.cholesky import PANEL
    from skeres_tpu_torch.ops.pair_product import pair_products, pair_products_reference

    nc = VENICE["num_cameras"]
    ci = cams.group_index
    euclidean = cams._group.manifold
    problem.set_manifold(cams, SubsetManifold(9, [6, 7, 8]))
    problem.set_parameter_block_constant(cams[0])
    try:
        t0 = time.time()
        declared = problem.compile()
        for grp, v in zip(program.groups, initial):
            grp.values = v.copy()
        schur, data, g, diag = linearize(declared, device, torch.float32, VENICE_CHUNK)
        plan = schur.explicit_plan
        print(f"[venice Problem API] camera 0 constant, SubsetManifold(9, [6, 7, 8]) on every "
              f"camera: compile and first linearization {time.time() - t0:.2f} s; path "
              f"{schur.schur_path}; S {schur.num_f} rows; plan: kp {plan.kp}, {plan.n_uniq} unique "
              f"camera pairs; effective parameters {declared.num_effective_parameters_reduced} of "
              f"{declared.num_effective_parameters}")
        check(schur.f_size == 6 and schur.num_f == 6 * nc and schur.schur_path == "explicit",
              "venice Problem API: not the explicit S of 6-parameter cameras")
        asm = first_assembly(schur, data, g, diag)
        grid = asm["explicit_grid"]["grid"].contiguous()
        cinv_flat = asm["cinv"].reshape(-1, 9).contiguous()
        del asm
        kern, plain = k3_tables(plan, grid, cinv_flat)
        err, rel = rel_err(kern, plain)
        print(f"[K3] (f, e) = (6, 3) at venice shape float32: table max|err| {err:.3e} "
              f"(rel {rel:.3e})")
        check(rel <= K3_RTOL[torch.float32], f"K3 (6, 3) venice: rel error {rel:.3e}")
        del kern, plain
        swap, valid, kl = plan.swap_mask, plan.pair_valid, plan.pair_kl
        run_k = lambda: pair_products(grid, cinv_flat, swap, valid, kl, 6, 3)  # noqa: E731
        run_p = lambda: pair_products_reference(grid, cinv_flat, swap, valid, kl, 6, 3,  # noqa: E731
                                                plan.chunk_points)
        t = [cuda_ms(run_k, calls=5), cuda_ms(run_p, calls=1), cuda_ms(run_p, calls=1),
             cuda_ms(run_k, calls=5)]
        moved = (plan.n_pair_rows * 36 + grid.numel() + cinv_flat.numel()) * 4 + 2 * swap.numel()
        flop = 2 * plan.np_ * (plan.kp * 6 * 3 * 3 + plan.npairs * 6 * 6 * 3)
        k3 = dict(err=err, ms=min(t[0], t[3]), plain_ms=min(t[1], t[2]), moved=moved, flop=flop)
        print(f"[timing] K3 (6, 3) venice shape ({plan.n_pair_rows} pair rows, {moved / 1e9:.3f} "
              f"GB moved): kernel {t[0]:.4f}/{t[3]:.4f} ms ({moved / 1e6 / k3['ms']:.1f} GB/s), "
              f"plain {t[1]:.4f}/{t[2]:.4f} ms (median of 20 runs)")
        del schur, data, g, diag, grid, cinv_flat, plan
        panels = math.ceil(6 * nc / PANEL)
        launches = {}
        for loop, kw in (("host loop", {}),
                         ("device loop", dict(use_device_loop=True,
                                              device_loop_chunk_iterations=VENICE_STEPS))):
            label = f"venice Problem API, {loop}"
            s, n, peak, rate = venice_solve(label, device, problem, declared, initial, **kw)
            # the solve's state is float32: compare with the float32 values it started from
            cams_after = declared.groups[ci].values
            cams_before = initial[ci].astype(np.float32).astype(np.float64)
            print(f"[{label}] beside LM on the full cameras (phase {11 if not kw else 16}): "
                  f"LM steps/s {rate:.4f}; {s.num_effective_parameters_reduced} effective "
                  f"parameters; K3 launches {n['K3']}, trailing-update launches "
                  f"{n['K2 update']} for {s.num_linear_solves} damped solves ({panels} panels)")
            check(s.schur_complement_path == "explicit", f"{label}: not the explicit path")
            check(np.array_equal(cams_after[0], cams_before[0]), f"{label}: camera 0 moved")
            check(np.array_equal(cams_after[:, 6:], cams_before[:, 6:]),
                  f"{label}: the held intrinsics moved")
            if not kw:
                check(n["K3"] == s.num_linear_solves
                      and n["K2 update"] >= (panels - 1) * s.num_linear_solves,
                      f"{label}: K3 or K2 did not launch on every damped solve")
                launches[label] = n
                solved = [grp.values.copy() for grp in declared.groups]  # phase 26's point
        print(f"[venice Problem API] LM on the full cameras (phase 11): {lm['rate']:.4f} LM "
              f"steps/s, final cost {lm['cost']!r}")
    finally:
        problem.set_manifold(cams, euclidean)
        problem.set_parameter_block_variable(cams[0])
        for grp, v in zip(program.groups, initial):
            grp.values = v.copy()
    return dict(launches=launches, k3=k3, solved=solved)


def solve_declared(bal, device, dtype, iters, declare="", **kw):
    """:func:`solve_bal` (DENSE_SCHUR) with phase 23's declarations:
    "bounds" (every focal length within 0.1 % of its value),
    "gauge+subset" (camera 0 constant, a SubsetManifold holding f, k1, k2)
    or "gauge" (cameras 0 and 1 constant: the 7-dof gauge fixed)."""
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.types import LinearSolverType
    from skeres_tpu_torch.io.bal import build_bal_problem
    from skeres_tpu_torch.models.manifolds import SubsetManifold

    problem, cams, _ = build_bal_problem(bal)
    if declare == "bounds":
        for i in range(len(cams)):
            f = float(cams.values[i, 6])
            problem.set_parameter_lower_bound(cams[i], 6, 0.999 * f)
            problem.set_parameter_upper_bound(cams[i], 6, 1.001 * f)
    elif declare == "gauge+subset":
        problem.set_manifold(cams, SubsetManifold(9, [6, 7, 8]))
        problem.set_parameter_block_constant(cams[0])
    elif declare == "gauge":
        problem.set_parameter_block_constant(cams[0])
        problem.set_parameter_block_constant(cams[1])
    return stt.solve(stt.SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_SCHUR, max_num_iterations=iters,
        run_full_iteration_budget=True, dtype=dtype, device=device, **kw), problem)


def phase_trust_region_card_vs_cpu(device) -> dict:
    """Phase 23. Returns the card's launches by path (host loop)."""
    from skeres_tpu_torch.core import schur as schur_mod
    from skeres_tpu_torch.core.types import DoglegType, TrustRegionStrategyType
    from skeres_tpu_torch.io.bal import synthetic_bal
    from skeres_tpu_torch.ops.cholesky import cholesky_both
    from skeres_tpu_torch.ops.pair_product import pair_products

    bal = synthetic_bal(16, 500, 4)
    loop = dict(use_device_loop=True, device_loop_chunk_iterations=4)
    # dogleg with the gauge fixed: the Gauss-Newton point of a gauge-free
    # scene solves a near-singular system, where rounding decides between a
    # plain factor and a jitter rung and sets the point's gauge components;
    # the traditional step's length, and so the trajectory, follow them (on
    # an NVIDIA H100 80GB HBM3 the card and the CPU once parted by 7.95e-5)
    cases = [(f"{d} {path}", path, dict(trust_region_strategy_type=TrustRegionStrategyType.DOGLEG,
                                        dogleg_type=DoglegType[d], declare="gauge"))
             for path in ("dense-W", "explicit") for d in ("TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG")]
    for name, kw in (("inner iterations", dict(use_inner_iterations=True)),
                     ("bounds", dict(declare="bounds")),
                     ("gauge+subset", dict(declare="gauge+subset"))):
        cases += [(f"{name} host loop", "dense-W", kw), (f"{name} device loop", "dense-W",
                                                         {**kw, **loop})]
    launches = {}
    saved = schur_mod.DENSE_W_LIMIT_BYTES
    for label, path, kw in cases:
        schur_mod.DENSE_W_LIMIT_BYTES = 0 if path == "explicit" else saved
        try:
            reset_launches()
            card = card_vs_cpu(device, bal, f"trust region {label}", solve=solve_declared, **kw)
        finally:
            schur_mod.DENSE_W_LIMIT_BYTES = saved
        check(card.schur_complement_path == path, f"trust region {label}: path "
              f"{card.schur_complement_path}")
        if "use_device_loop" not in kw:
            launches[f"synthetic_bal(16, 500, 4) {label}"] = {
                "K1": cholesky_both.launches, "K3": pair_products.launches}
        if "dogleg_type" in kw:
            print(f"[trust region {label}] Gauss-Newton solve iterations on the card "
                  f"{card.dogleg_gauss_newton_iterations}, Cauchy steps "
                  f"{card.num_dogleg_cauchy_steps}")
    return launches


# -- pose graphs, the line search, covariance, the registries (phases 24-27) ------


def check_no_launches(label: str, may=()) -> dict:
    """The kernels' launches since the last reset: none on these paths, but
    for the kernels named in ``may``."""
    n = launch_counts()
    print(f"[{label}] kernel launches: {json.dumps(n)}")
    check(not any(v for k, v in n.items() if k not in may),
          f"{label}: a kernel launched on a path that factors nothing")
    return n


def same_trajectory(label: str, card, cpu, rtol: float, bound_name: str = "",
                    names=("the card", "the CPU")) -> float:
    """The card's and the CPU's Summaries: the same decisions (and, for a
    line search, the same step-search evaluations) and iteration count,
    costs to ``rtol`` (relative to each CPU cost, or to 1e-10 of the
    initial cost where a cost nears zero, as on a graph whose measurements
    are exact: the square loop ends at 1e-25 from 17.8). Returns the
    largest relative cost difference."""
    seq = [(it.step_is_successful, it.line_search_function_evaluations) for it in card.iterations]
    seq_cpu = [(it.step_is_successful, it.line_search_function_evaluations)
               for it in cpu.iterations]
    a = np.array([it.cost for it in card.iterations])
    b = np.array([it.cost for it in cpu.iterations])
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-10 * abs(b[0])))) \
        if len(a) == len(b) else math.inf
    print(f"[{label}] {len(a) - 1} iterations on {names[0]}, {len(b) - 1} on {names[1]}; "
          f"termination {card.termination_type.value} / {cpu.termination_type.value}; max "
          f"relative cost difference {rel:.3e}" + (f" ({bound_name})" if bound_name else ""))
    check(seq == seq_cpu, f"{label}: the decisions on {names[0]} differ from {names[1]}'s")
    check(card.termination_type == cpu.termination_type, f"{label}: terminations differ")
    check(rel <= rtol, f"{label}: costs on {names[0]} and {names[1]} differ by {rel:.3e} > "
                       f"{rtol:.0e}")
    return rel


SPHERE_POSES = 2500  # sphere2500 (BASELINE config 3)
# CGNR card against CPU (ROADMAP Queue 3 note f): phase 17's bound is 1e-3;
# on sphere2500 the PCG ends on its cap on 12 of 18 solves
SPHERE_CGNR_RTOL = 1e-2


def solve_sphere(graph, device, dtype, device_loop=False, **kw):
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.types import LinearSolverType, PreconditionerType
    from skeres_tpu_torch.io.g2o import build_pose_graph_problem

    problem, poses = build_pose_graph_problem(graph)
    s = stt.solve(stt.SolverOptions(
        linear_solver_type=LinearSolverType.SPARSE_NORMAL_CHOLESKY,
        preconditioner_type=PreconditionerType.JACOBI, max_num_iterations=100, dtype=dtype,
        device=device, use_device_loop=device_loop, **kw), problem)
    return s, poses


def phase_pose_graph(device) -> dict:
    """Phase 24. Returns the launches by path."""
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.gradient_checker import check_program_gradients
    from skeres_tpu_torch.core.types import LinearSolverType
    from skeres_tpu_torch.io.g2o import PoseGraph2D, build_pose_graph_problem, synthetic_sphere

    t0 = time.time()
    graph = synthetic_sphere(SPHERE_POSES)
    n_odo = SPHERE_POSES - 1
    print(f"[pose graph] synthetic_sphere({SPHERE_POSES}): {len(graph.poses)} poses, "
          f"{len(graph.edges)} edges ({n_odo} odometry, {len(graph.edges) - n_odo} loop "
          f"closures), SE(3) with the Eigen-quaternion manifold, pose 0 constant "
          f"({6 * (SPHERE_POSES - 1)} free tangent coordinates); made in {time.time() - t0:.2f} s")
    launches, runs = {}, {}
    for loop in ("host loop", "device loop"):
        for dtype in (torch.float32, torch.float64):
            label = f"sphere{SPHERE_POSES} {loop} {str(dtype).replace('torch.', '')}"
            gradients = dtype == torch.float64 and loop == "host loop"
            reset_launches()
            s, poses = solve_sphere(graph, device, dtype, device_loop=loop == "device loop",
                                    check_gradients=gradients)
            runs[label] = s
            steps = s.num_successful_steps + s.num_unsuccessful_steps
            costs = [it.cost for it in s.iterations]
            print(f"[{label}] CGNR (SPARSE_NORMAL_CHOLESKY) JACOBI: chi^2 {2 * s.initial_cost!r} -> "
                  f"{2 * s.final_cost!r}; {steps} LM steps ({s.num_successful_steps} accepted) in "
                  f"{s.minimizer_time_in_seconds:.4f} s: {steps / s.minimizer_time_in_seconds:.4f} "
                  f"LM steps/s; PCG steps {[it.linear_solver_iterations for it in s.iterations[1:]]}"
                  f"; preprocessor {s.preprocessor_time_in_seconds:.4f} s"
                  + (" (the gradient check included)" if gradients else "")
                  + f"; {s.termination_type.value}: {s.message}")
            launches[label] = check_no_launches(label)
            check(s.linear_solver_type_used.value == "CGNR", f"{label}: not CGNR")
            check(all(math.isfinite(c) for c in costs), f"{label}: non-finite cost")
            check(s.termination_type.value in ("CONVERGENCE", "NO_CONVERGENCE"),
                  f"{label}: {s.termination_type.value}: {s.message}")
            check(s.final_cost < 1e-2 * s.initial_cost, f"{label}: final cost {s.final_cost}")
            qn = np.linalg.norm(poses.values[:, 3:], axis=1)
            check(np.abs(qn - 1.0).max() <= (1e-5 if dtype == torch.float32 else 1e-12),
                  f"{label}: quaternions left the unit sphere")
            check(np.array_equal(poses.values[0], graph.poses[0].astype(
                np.float32 if dtype == torch.float32 else np.float64).astype(np.float64)),
                  f"{label}: pose 0 moved")
            if loop == "device loop":
                check(s.device_loop_capture_time_in_seconds > 0.0, f"{label}: no graph captured")
    # the gradient check alone, f64 on the card
    program = build_pose_graph_problem(graph)[0].compile()
    ev = Evaluator(program, device=device, dtype=torch.float64)
    t0 = time.time()
    ok, msg = check_program_gradients(program, ev)
    torch.cuda.synchronize()
    print(f"[pose graph] gradient check f64 on the card ({program.num_residual_blocks} edges, 12 "
          f"tangent columns each): {'passed' if ok else msg} in {time.time() - t0:.4f} s")
    check(ok, f"pose graph gradient check: {msg}")
    # the f64 trajectory against the CPU's
    cpu, _ = solve_sphere(graph, "cpu", torch.float64)
    # CGNR's PCG ends on its 500-step cap on most of these solves, where the
    # iterate it stops at depends on the summation order: the trajectories
    # part mid-way (by 2.2e-3 on an NVIDIA H100 80GB HBM3, past phase 17's
    # 1e-3) and meet again at the minimum
    label = f"sphere{SPHERE_POSES} f64 card vs CPU"
    card = runs[f"sphere{SPHERE_POSES} host loop float64"]
    same_trajectory(label, card, cpu, SPHERE_CGNR_RTOL, "CGNR, its PCG at the 500-step cap")
    per_step = [abs(a.cost - b.cost) / b.cost for a, b in zip(card.iterations, cpu.iterations)]
    final = abs(card.final_cost - cpu.final_cost) / cpu.final_cost
    print(f"[{label}] relative cost difference by iteration {[f'{d:.1e}' for d in per_step]}; "
          f"final chi^2 {2 * card.final_cost!r} against {2 * cpu.final_cost!r} ({final:.3e}); "
          f"within 1e-8: {max(per_step) <= 1e-8}")
    check(final <= 1e-6, f"{label}: the final costs differ by {final:.3e}")
    # the square loop of tests/test_pose_graph.py
    gt = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, np.pi / 2], [1.0, 1.0, np.pi],
                   [0.0, 1.0, -np.pi / 2]])
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0]], dtype=np.int32)
    meas = []
    for a, b in edges:
        d, c, s_ = gt[b, :2] - gt[a, :2], np.cos(gt[a, 2]), np.sin(gt[a, 2])
        dyaw = gt[b, 2] - gt[a, 2]
        meas.append([c * d[0] + s_ * d[1], -s_ * d[0] + c * d[1],
                     np.arctan2(np.sin(dyaw), np.cos(dyaw))])
    rng = np.random.default_rng(0)
    noisy = gt.copy()
    noisy[1:, :2] += rng.normal(0, 0.2, (3, 2))
    noisy[1:, 2] += rng.normal(0, 0.15, 3)
    square = PoseGraph2D(poses=noisy, ids=np.arange(4), edges=edges, measurements=np.array(meas),
                         sqrt_information=np.broadcast_to(np.eye(3) * 10.0, (4, 3, 3)).copy())
    out = {}
    reset_launches()
    for dev in (device, "cpu"):
        problem, poses = build_pose_graph_problem(square)
        out[dev] = (stt.solve(stt.SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_NORMAL_CHOLESKY, max_num_iterations=50,
            device=dev), problem), poses.values.copy())
    launches["square loop (2-D)"] = check_no_launches("square loop")
    same_trajectory("square loop f64 card vs CPU", out[device][0], out["cpu"][0], 1e-8)
    err = np.abs(out[device][1][:, :2] - gt[:, :2]).max()
    print(f"[square loop] {out[device][0].termination_type.value} on the card, positions within "
          f"{err:.3e} of the ground truth")
    check(out[device][0].termination_type.value == "CONVERGENCE" and err <= 1e-6,
          "square loop: not at the ground truth")
    return launches


LINE_SEARCH_STEPS = 30


def line_search_options(device, dtype, **kw):
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.types import MinimizerType

    return stt.SolverOptions(minimizer_type=MinimizerType.LINE_SEARCH, dtype=dtype,
                             device=device, **kw)


def phase_venice_line_search(device, problem, program, initial, lm: dict) -> dict:
    """Phase 25, venice shape (Ceres ``bundle_adjuster --line_search``):
    L-BFGS (rank 20) with Wolfe steps, float32, 30 iterations, from the
    scene's initial values; then every direction type with both step
    searches card against CPU on a small scene, and GradientProblem.
    Returns the launches by path."""
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.gradient_problem import GradientProblem, solve_gradient_problem
    from skeres_tpu_torch.core.types import LineSearchDirectionType, LineSearchType
    from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal

    for grp, v in zip(program.groups, initial):
        grp.values = v.copy()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    label = "venice line search"
    try:
        s = stt.solve(line_search_options(
            device, torch.float32, line_search_direction_type=LineSearchDirectionType.LBFGS,
            max_lbfgs_rank=20, line_search_type=LineSearchType.WOLFE,
            max_num_iterations=LINE_SEARCH_STEPS, evaluation_chunk_size=VENICE_CHUNK),
            problem, program)
    finally:
        for grp, v in zip(program.groups, initial):
            grp.values = v.copy()
    peak = torch.cuda.max_memory_allocated() / 2**30
    its = len(s.iterations) - 1
    evals = [it.line_search_function_evaluations for it in s.iterations[1:]]
    costs = [it.cost for it in s.iterations]
    print(f"[{label}] LBFGS (rank 20), WOLFE, float32: costs {json.dumps(costs)}")
    print(f"[{label}] {its} iterations ({s.num_successful_steps} accepted) in "
          f"{s.minimizer_time_in_seconds:.4f} s: {its / s.minimizer_time_in_seconds:.4f} "
          f"iterations/s; step-search evaluations {evals} ({sum(evals) / max(its, 1):.3f} an "
          f"iteration; each a cost and a gradient); final cost {s.final_cost!r} against LM's "
          f"{lm['cost']!r} after {VENICE_STEPS} steps (phase 11); peak device memory {peak:.3f} "
          f"GiB (LM {lm['peak']:.3f}); {s.termination_type.value}: {s.message}")
    launches = {label: check_no_launches(label, SNAVELY)}
    check(all(math.isfinite(c) for c in costs), f"{label}: non-finite cost")
    check(s.final_cost < s.initial_cost, f"{label}: no decrease")
    check(its >= 1, f"{label}: no iteration")

    bal = synthetic_bal(16, 500, 4)
    reset_launches()
    for direction in LineSearchDirectionType:
        for search in LineSearchType:
            kw = dict(line_search_direction_type=direction, line_search_type=search,
                      max_num_iterations=20)
            runs = [stt.solve(line_search_options(dev, torch.float64, **kw),
                              build_bal_problem(bal)[0]) for dev in (device, "cpu")]
            same_trajectory(f"line search {direction.value} {search.value} card vs CPU", *runs,
                            1e-8)

    def rosenbrock(x):
        return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2

    c = np.array([1.0, 2.0, 2.0]) / 3.0
    for name, f, n, x0, manifold in (
            ("Rosenbrock", rosenbrock, 2, [-1.2, 1.0], None),
            ("sphere", lambda x: -torch.dot(torch.as_tensor(c, dtype=x.dtype, device=x.device), x),
             3, [1.0, 0.0, 0.0], stt.SphereManifold(3))):
        out = [solve_gradient_problem(line_search_options(dev, torch.float64,
                                                          max_num_iterations=300),
                                      GradientProblem(f, n, manifold), np.array(x0))
               for dev in (device, "cpu")]
        # the Rosenbrock valley magnifies last-bit gradient differences (its
        # CPU test against the JAX package holds it to 1e-6)
        same_trajectory(f"GradientProblem {name} card vs CPU", out[0][1], out[1][1], 1e-6)
        print(f"[GradientProblem {name}] solution on the card {out[0][0].tolist()}, "
              f"{out[0][1].termination_type.value}")
        check(out[0][1].termination_type.value == "CONVERGENCE", f"GradientProblem {name}")
    launches["synthetic_bal(16, 500, 4) line search, every direction and step search"] = \
        check_no_launches("line search card vs CPU", SNAVELY)
    return launches



def covariance_of(problem, device, algorithm, program=None, **kw):
    from skeres_tpu_torch.core.covariance import Covariance, CovarianceOptions
    from skeres_tpu_torch.core.types import CovarianceAlgorithmType

    cov = Covariance(CovarianceOptions(algorithm_type=CovarianceAlgorithmType[algorithm],
                                       device=device, **kw))
    return cov, cov.compute(problem, program)


def timed_query(cov, b1, b2):
    t0 = time.time()
    out = cov.get_covariance_block_in_tangent_space(b1, b2)
    return out, 1e3 * (time.time() - t0)


def phase_venice_covariance(device, problem, program, cams, solved) -> dict:
    """Phase 26a: SCHUR_COMPLEMENT covariance, float64, of phase 22's
    calibrated-camera venice scene at its host-loop solution. Returns the
    launches and K3's check."""
    from skeres_tpu_torch.core.problem import ParameterBlockArray
    from skeres_tpu_torch.models.manifolds import SubsetManifold

    nc = VENICE["num_cameras"]
    euclidean = cams._group.manifold
    problem.set_manifold(cams, SubsetManifold(9, [6, 7, 8]))
    problem.set_parameter_block_constant(cams[0])
    label = "venice calibrated covariance (SCHUR_COMPLEMENT)"
    try:
        for grp, v in zip(program.groups, solved):
            grp.values = v.copy()
        declared = problem.compile()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.time()
        cov, ok = covariance_of(problem, device, "SCHUR_COMPLEMENT", declared, null_space_rank=1,
                                evaluation_chunk_size=VENICE_CHUNK)
        torch.cuda.synchronize()
        wall = time.time() - t0
        n = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        schur = cov._schur
        free = int(declared.free_mask[schur.ret_offset : schur.ret_offset + schur.num_f].sum())
        print(f"[{label}] float64 at phase 22's host-loop solution; S {schur.num_f} rows "
              f"({schur.schur_path} path), {free} free camera coordinates; null_space_rank 1 "
              f"(the scale of the gauge; camera 0 holds the rest); predicted rank {free - 1}")
        print(f"[{label}] compute() {ok}: {wall:.4f} s wall (evaluate "
              f"{cov.seconds['evaluate']:.4f} s, S and its guards {cov.seconds['assemble']:.4f} s, "
              f"eigh of {free} x {free} {cov.seconds['eigh']:.4f} s, the whole pseudo-inverse "
              f"{cov.seconds['pinv']:.4f} s); rank {cov.rank}; smallest kept eigenvalue "
              f"{cov.smallest_kept!r}; peak device memory {peak:.3f} GiB; launches {json.dumps(n)}")
        check(ok, f"{label}: compute() returned False (rank {cov.rank})")
        check(schur.schur_path == "explicit" and schur.f_size == 6 and schur.num_f == 6 * nc,
              f"{label}: not the explicit S of 6-parameter cameras")
        check(cov.rank == free - 1, f"{label}: rank {cov.rank}, predicted {free - 1}")
        check(n["K3"] == 1 and n["K1"] == n["K2 update"] == 0,
              f"{label}: launches {n}, expected K3 once and no factor")
        pts = ParameterBlockArray(problem, schur.elim_group)
        queries = {}
        for name, (b1, b2) in (("camera", (cams[5], cams[5])), ("camera-point", (cams[5], pts[7])),
                               ("point-point", (pts[7], pts[7]))):
            block, ms = timed_query(cov, b1, b2)
            queries[name] = (block, ms)
            print(f"[{label}] {name} block {block.shape}: {ms:.3f} ms; max|entry| "
                  f"{np.abs(block).max():.6e}")
            check(np.isfinite(block).all(), f"{label}: {name} block not finite")
        for name in ("camera", "point-point"):
            block = queries[name][0]
            check(np.allclose(block, block.T, rtol=1e-8, atol=1e-14 * np.abs(block).max())
                  and np.linalg.eigvalsh(0.5 * (block + block.T)).min() > 0.0,
                  f"{label}: the {name} block is not symmetric positive definite")
        zero, _ = timed_query(cov, cams[0], cams[5])
        check(not zero.any(), f"{label}: the constant camera's covariance is not zero")
        # K3 against its plain version on this call's inputs: float64, (6, 3)
        prep = schur.prepare(schur.solver_data(cov._blocks))
        zeros = torch.zeros(declared.num_tangent, dtype=torch.float64, device=device)
        asm = schur._assemble(prep, zeros, zeros)
        grid = asm["explicit_grid"]["grid"].contiguous()
        cinv_flat = asm["cinv"].reshape(-1, 9).contiguous()
        del prep, asm
        kern, plain = k3_tables(schur.explicit_plan, grid, cinv_flat)
        err, rel = rel_err(kern, plain)
        print(f"[K3] (f, e) = (6, 3) at venice shape float64 (the covariance's S): table "
              f"max|err| {err:.3e} (rel {rel:.3e})")
        check(rel <= K3_RTOL[torch.float64], f"K3 (6, 3) float64 venice: rel error {rel:.3e}")
        del kern, plain, grid, cinv_flat, cov
    finally:
        problem.set_manifold(cams, euclidean)
        problem.set_parameter_block_variable(cams[0])
        for grp, v in zip(program.groups, solved):
            grp.values = v.copy()
        torch.cuda.empty_cache()
    return dict(launches={label: n}, k3_f64_err=err)


def phase_covariance(device) -> dict:
    """Phase 26b: DENSE_SVD on sphere2500 after its solve, and the small
    BA scene of tests/test_covariance_gradient.py card against CPU."""
    from skeres_tpu_torch.core.schur import DENSE_W_LIMIT_BYTES
    from skeres_tpu_torch.core import schur as schur_mod
    from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal
    from skeres_tpu_torch.io.g2o import build_pose_graph_problem, synthetic_sphere

    launches = {}
    graph = synthetic_sphere(SPHERE_POSES)
    s, poses = solve_sphere(graph, device, torch.float64)
    problem, poses2 = build_pose_graph_problem(graph)
    poses2.values = poses.values
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    label = f"sphere{SPHERE_POSES} covariance (DENSE_SVD)"
    t0 = time.time()
    cov, ok = covariance_of(problem, device, "DENSE_SVD")
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_free = 6 * (SPHERE_POSES - 1)
    print(f"[{label}] float64 at the f64 solution (chi^2 {2 * s.final_cost!r}); J^T J over "
          f"{6 * SPHERE_POSES} tangent coordinates ({(6 * SPHERE_POSES) ** 2 * 8 / 1e9:.2f} GB), "
          f"{n_free} free: compute() {ok} in {wall:.4f} s (evaluate {cov.seconds['evaluate']:.4f} "
          f"s, J^T J {cov.seconds['assemble']:.4f} s, eigh {cov.seconds['eigh']:.4f} s, the whole "
          f"pseudo-inverse {cov.seconds['pinv']:.4f} s); rank {cov.rank}; smallest kept eigenvalue "
          f"{cov.smallest_kept!r}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    launches[label] = check_no_launches(label)
    check(ok and cov.rank == n_free, f"{label}: compute() {ok}, rank {cov.rank}")
    mid = SPHERE_POSES // 2
    block, ms = timed_query(cov, poses2[mid], poses2[mid])
    print(f"[{label}] pose {mid}'s block: {ms:.3f} ms, diagonal {np.diag(block).tolist()}")
    check(np.isfinite(block).all() and np.linalg.eigvalsh(0.5 * (block + block.T)).min() > 0.0,
          f"{label}: pose {mid}'s block is not positive definite")
    del cov
    torch.cuda.empty_cache()

    # tests/test_covariance_gradient.py's scene: both algorithms, both devices
    bal = synthetic_bal(num_cameras=5, num_points=30, observations_per_point=4)
    reset_launches()
    blocks = {}
    saved = schur_mod.DENSE_W_LIMIT_BYTES
    for path in ("dense-W", "explicit"):
        schur_mod.DENSE_W_LIMIT_BYTES = 0 if path == "explicit" else DENSE_W_LIMIT_BYTES
        try:
            for dev in (device, "cpu"):
                problem, cams, pts = build_bal_problem(bal)
                problem.set_parameter_block_constant(cams[0])
                problem.set_parameter_block_constant(cams[1])
                if dev == device and path == "dense-W":
                    solve_bal_problem(problem, "cpu")
                    solution = [g.values.copy() for g in problem._groups]
                for grp, v in zip(problem._groups, solution):
                    grp.values = v.copy()
                for algo in ("DENSE_SVD", "SCHUR_COMPLEMENT"):
                    cov, ok = covariance_of(problem, dev, algo)
                    check(ok, f"small BA covariance {algo} {dev}: compute() False")
                    pairs = [(cams[2], cams[2]), (cams[2], cams[4]), (cams[3], pts[7]),
                             (pts[11], cams[2]), (pts[3], pts[3]), (pts[3], pts[19]),
                             (cams[0], cams[2])]
                    blocks[(path, dev, algo)] = [cov.get_covariance_block_in_tangent_space(*p)
                                                 for p in pairs]
        finally:
            schur_mod.DENSE_W_LIMIT_BYTES = saved
    # SCHUR_COMPLEMENT against DENSE_SVD as tests/test_covariance_gradient.py
    # holds them; card against CPU as tests/test_torch_covariance.py holds the
    # port against the JAX package (J^T J is 8.4e7-conditioned here)
    worst = {}
    for path in ("dense-W", "explicit"):
        for a, b, rtol, atol in (
                ((device, "SCHUR_COMPLEMENT"), (device, "DENSE_SVD"), 1e-5, 1e-9),
                ((device, "DENSE_SVD"), ("cpu", "DENSE_SVD"), 1e-7, 1e-12),
                ((device, "SCHUR_COMPLEMENT"), ("cpu", "SCHUR_COMPLEMENT"), 1e-7, 1e-12)):
            key = f"{path}: {a[1]} {a[0]} vs {b[1]} {b[0]}"
            worst[key] = max(float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-300))
                             for x, y in zip(blocks[(path, *a)], blocks[(path, *b)]))
            check(all(np.allclose(x, y, rtol=rtol, atol=atol)
                      for x, y in zip(blocks[(path, *a)], blocks[(path, *b)])),
                  f"small BA covariance {key}: differ beyond rtol {rtol:.0e}")
    print("[small BA covariance] synthetic_bal(5, 30, 4), cameras 0 and 1 constant, 7 block pairs "
          "of every type; largest difference relative to each block's largest entry: "
          + "; ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    launches["synthetic_bal(5, 30, 4) covariance, both algorithms"] = launch_counts()
    return launches


def solve_bal_problem(problem, device):
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.types import LinearSolverType

    return stt.solve(stt.SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR,
                                       max_num_iterations=25, device=device), problem)


def scoreboards(device) -> dict:
    """The MGH and NIST registries solved on ``device`` in float64 with
    the options of tests/test_mgh.py and tests/test_nist.py: per case,
    (certified, F)."""
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.types import LinearSolverType
    from skeres_tpu_torch.io.nist_strd import EMBEDDED
    from skeres_tpu_torch.io.nist_strd import PROBLEMS as NIST
    from skeres_tpu_torch.models.mgh import PROBLEMS as MGH

    tight = dict(use_nonmonotonic_steps=True, function_tolerance=1e-16, gradient_tolerance=1e-16,
                 parameter_tolerance=1e-16, linear_solver_type=LinearSolverType.DENSE_QR,
                 device=device)
    out = {}
    for num in sorted(MGH):
        prob = MGH[num]
        problem = stt.Problem()
        x = problem.add_parameter_block(np.asarray(prob.x0, dtype=np.float64))
        problem.add_residual_block(lambda params, data, prob=prob: prob.residual(params[0]),
                                   None, [x])
        s = stt.solve(stt.SolverOptions(max_num_iterations=prob.max_iterations, **tight), problem)
        f = 2.0 * s.final_cost
        out[f"MGH {num} {prob.name}"] = (bool(prob.certified(f)), f, at_cap(s))
    for name in EMBEDDED:
        prob = NIST[name]
        y, X = prob.data()
        for start, b0 in enumerate(prob.starts):
            problem = stt.Problem()
            b = problem.add_parameter_block(np.asarray(b0, dtype=np.float64))
            problem.add_residual_blocks(
                lambda params, data, prob=prob: data[0:1] - prob.model(params[0], data[None, 1:]),
                None, [(b.array, np.zeros(len(y), dtype=np.int32))],
                data=np.concatenate([(np.log(y) if prob.log_response else y).reshape(-1, 1), X],
                                    axis=1))
            s = stt.solve(stt.SolverOptions(max_num_iterations=1500, **tight), problem)
            ssr, c = 2.0 * s.final_cost, prob.certified_ssr
            ok = ssr < 1e-20 if c < 1e-20 else abs(ssr - c) <= 1e-6 * c
            out[f"NIST {name} start {start}"] = (bool(ok), ssr, at_cap(s))
    return out


def at_cap(summary) -> bool:
    return summary.message == "Maximum number of iterations reached."


SCOREBOARDS_CPU_ERR = os.path.join(ROOT, "build", "scoreboards_cpu.err")


def start_cpu_scoreboards() -> subprocess.Popen:
    """The CPU's scoreboards in a child process, while the card runs the
    other phases (phase 27 reads them). Its standard error goes to a file,
    which no pipe can fill up."""
    os.makedirs(os.path.dirname(SCOREBOARDS_CPU_ERR), exist_ok=True)
    with open(SCOREBOARDS_CPU_ERR, "w") as err:
        return subprocess.Popen([sys.executable, os.path.abspath(__file__), "--scoreboards-cpu"],
                                stdout=subprocess.PIPE, stderr=err, text=True, cwd=ROOT)


def phase_scoreboards(device, cpu_child: subprocess.Popen) -> dict:
    """Phase 27. Returns the launches on the path."""
    t0 = time.time()
    reset_launches()
    card = scoreboards(device)
    t_card = time.time() - t0
    launches = check_no_launches("MGH/NIST scoreboards")
    out, _ = cpu_child.communicate(timeout=900)
    lines = out.strip().splitlines()
    if cpu_child.returncode != 0 or not lines:
        with open(SCOREBOARDS_CPU_ERR) as f:
            err = f.read()
        check(False, f"CPU scoreboards: exit {cpu_child.returncode}\n{out[-2000:]}\n{err[-4000:]}")
    cpu = {k: tuple(v) for k, v in json.loads(lines[-1]).items()}
    check(set(card) == set(cpu), "scoreboards: different cases")
    # a case that ends on its step limit on both devices is certified or not
    # by where rounding left it: on the CPU, a start changed by 1e-15 takes
    # MGH penalty2_n10 from F = 2.93661e-4 (certified) to 4.36039e-4
    at_limit = {k for k in card if card[k][2] and cpu[k][2]}
    differ = [k for k in card if card[k][0] != cpu[k][0] and k not in at_limit]
    at_limit_differ = [k for k in at_limit if card[k][0] != cpu[k][0]]
    for group in ("MGH", "NIST"):
        keys = [k for k in card if k.startswith(group)]
        print(f"[scoreboards] {group}: the card certifies {sum(card[k][0] for k in keys)} of "
              f"{len(keys)}, the CPU {sum(cpu[k][0] for k in keys)}; not certified on the card: "
              f"{[k for k in keys if not card[k][0]]}")
    rel = max(abs(card[k][1] - cpu[k][1]) / max(abs(cpu[k][1]), 1e-300)
              for k in card if card[k][0] and cpu[k][1] > 1e-12)
    print(f"[scoreboards] float64, DENSE_QR: {len(card)} cases on the card in {t_card:.1f} s "
          f"(the CPU's ran beside the other phases in a child process); largest relative F "
          f"difference among the certified nonzero minima {rel:.3e}; ending on the step limit on "
          f"both devices: {sorted(at_limit)}; certified differently: {differ}, and at the step "
          f"limit: {[(k, card[k][1], cpu[k][1]) for k in at_limit_differ]} (F on the card, the "
          f"CPU)")
    check(not differ, f"scoreboards: the card and the CPU certify differently: {differ}")
    return {"MGH and NIST scoreboards (float64, DENSE_QR)": launches}


# -- the general Schur structure, the CLIs and the examples (phases 28-32) ---------

SPLIT_STEPS = 30  # phase 28, as phases 6 and 15
BAL49_FINAL = 4801.92  # phase 6's final cost (float32), to the digits PERF.md gives
# the camera, point and observation-per-point counts of BAL problem-356-226730
DUBROVNIK = dict(num_cameras=356, num_points=226_730, observations_per_point=5)
DUBROVNIK_STEPS = 5
# phase 31: every Schur path of the general structure, both loops
GENERAL_SOLVERS = (("DENSE_SCHUR", "JACOBI"), ("ITERATIVE_SCHUR", "JACOBI"),
                   ("ITERATIVE_SCHUR", "SCHUR_JACOBI"),
                   ("ITERATIVE_SCHUR", "POWER_SERIES_EXPANSION"))
SPHERE_CHI2 = 270.37  # phase 24's final chi^2 on sphere2500


def solve_split(bal, device, dtype, iters, split=True, solver="DENSE_SCHUR", precond="JACOBI",
                **kw):
    """``bal`` through ``stt.solve`` with each camera split into a pose (6)
    and an intrinsics (3) block (``split``), or whole; the full budget."""
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.types import LinearSolverType, PreconditionerType
    from skeres_tpu_torch.io.bal import build_bal_problem, build_split_bal_problem

    problem = (build_split_bal_problem if split else build_bal_problem)(bal)[0]
    return stt.solve(stt.SolverOptions(
        linear_solver_type=LinearSolverType[solver],
        preconditioner_type=PreconditionerType[precond], max_num_iterations=iters,
        run_full_iteration_budget=True, dtype=dtype, device=device, **kw), problem)


def cost_gap(label: str, got, ref, rtol: float) -> float:
    """Every step's cost of ``got`` against ``ref`` (two Summaries of the
    same problem): the same iteration count, costs to ``rtol``. Prints how
    many decisions agree. Returns the largest relative difference."""
    a = np.array([it.cost for it in got.iterations])
    b = np.array([it.cost for it in ref.iterations])
    check(len(a) == len(b), f"{label}: {len(a)} iterations against {len(b)}")
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    same = sum(x.step_is_successful == y.step_is_successful
               for x, y in zip(got.iterations, ref.iterations))
    print(f"[{label}] costs {json.dumps(a.tolist())}; max relative difference from the reference "
          f"{rel:.3e} over {len(a)} iterations; {same} of {len(a)} decisions agree")
    check(rel <= rtol, f"{label}: costs differ by {rel:.3e} > {rtol:.0e}")
    return rel


def phase_split_bal49(device) -> dict:
    """Phase 28: BAL-49 split, S (441 rows) by the column probe, K1.
    Returns the launches by path."""
    from skeres_tpu_torch.io.bal import synthetic_bal

    bal = synthetic_bal(49, 7776, 4)
    reset_launches()
    ref = solve_split(bal, device, torch.float64, SPLIT_STEPS, split=False)
    check(ref.schur_complement_path == "dense-W", "split BAL-49: the reference is not dense W")
    print(f"[split BAL-49] unsplit reference, float64 host loop: path dense-W, final cost "
          f"{ref.final_cost!r} (phase 6, float32: {BAL49_FINAL})")
    check(abs(ref.final_cost / BAL49_FINAL - 1.0) <= 1e-5,
          f"split BAL-49: the unsplit float64 final cost {ref.final_cost} is not phase 6's")
    launches = {}
    for loop in ("host loop", "device loop"):
        label = f"split BAL-49 float64 {loop}"
        reset_launches()
        s = solve_split(bal, device, torch.float64, SPLIT_STEPS,
                        use_device_loop=loop == "device loop")
        n = launch_counts()
        check(s.schur_complement_path.startswith("column-probe (gate: structure:"),
              f"{label}: path {s.schur_complement_path}")
        cost_gap(label, s, ref, 1e-8)
        print(f"[{label}] kernel launches {json.dumps(n)} for {s.num_linear_solves} damped solves"
              + (" (counts captures, not replays)" if loop == "device loop" else ""))
        check(n["K2 update"] == n["K3"] == 0, f"{label}: K2's update or K3 launched")
        if loop == "host loop":
            check(n["K1"] >= s.num_linear_solves > 0,
                  f"{label}: K1 launched {n['K1']} times for {s.num_linear_solves} solves")
        else:
            check(n["K1"] >= 1, f"{label}: K1 not in the captured step")
        launches[label] = n
    rates = {}
    for loop in ("host loop", "device loop"):
        kw = dict(use_device_loop=loop == "device loop")
        solve_split(bal, device, torch.float32, 2, **kw)  # first-call set-up
        s = solve_split(bal, device, torch.float32, SPLIT_STEPS, **kw)
        steps = s.num_successful_steps + s.num_unsuccessful_steps
        rates[loop] = steps / s.minimizer_time_in_seconds
        print(f"[split BAL-49 float32 {loop}] {steps} LM steps in {s.minimizer_time_in_seconds:.4f} "
              f"s: {rates[loop]:.3f} LM steps/s; a damped solve "
              f"{s.linear_solver_time_in_seconds / max(s.num_linear_solves, 1):.5f} s (host loop "
              f"clock); final cost {s.final_cost!r}; capture "
              f"{s.device_loop_capture_time_in_seconds:.4f} s")
        check(s.final_cost < 1e-2 * s.initial_cost, f"split BAL-49 float32 {loop}: no descent")
    return launches


def phase_dubrovnik(device) -> dict:
    """Phase 29: the Dubrovnik shape split, S (3,204 rows) by the column
    probe in 26 chunks, K2 over 7 panels; held against the unsplit scene on
    the explicit path (K3 at (9, 3) in float64, K2). Returns the launches
    by path."""
    from skeres_tpu_torch.core.schur import PROBE_CHUNK
    from skeres_tpu_torch.io.bal import build_split_bal_problem, synthetic_bal
    from skeres_tpu_torch.ops.cholesky import PANEL

    t0 = time.time()
    bal = synthetic_bal(**DUBROVNIK)
    n_f = 9 * bal.num_cameras
    panels = -(-n_f // PANEL)
    print(f"[dubrovnik] synthetic_bal{tuple(DUBROVNIK.values())}: {bal.num_cameras} cameras, "
          f"{bal.num_points} points, {bal.num_observations} observations; S {n_f} rows: "
          f"{-(-n_f // PROBE_CHUNK)} probe chunks, {panels} K2 panels; made in "
          f"{time.time() - t0:.2f} s")
    launches = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ref = solve_split(bal, device, torch.float64, DUBROVNIK_STEPS, split=False)
    n = launch_counts()
    print(f"[dubrovnik unsplit float64 host loop] path {ref.schur_complement_path}; final cost "
          f"{ref.final_cost!r}; kernel launches {json.dumps(n)} for {ref.num_linear_solves} "
          f"damped solves; {ref.linear_solver_time_in_seconds / ref.num_linear_solves:.4f} s a "
          f"damped solve; peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(ref.schur_complement_path == "explicit", "dubrovnik: the unsplit scene is not explicit")
    check(n["K3"] == ref.num_linear_solves and n["K2 update"] >= (panels - 1) * n["K3"],
          "dubrovnik unsplit: K3 or K2 not on every damped solve")
    launches["Dubrovnik shape unsplit float64 (explicit)"] = n
    for loop in ("host loop", "device loop"):
        label = f"dubrovnik split float64 {loop}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        s = solve_split(bal, device, torch.float64, DUBROVNIK_STEPS,
                        use_device_loop=loop == "device loop")
        n = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(s.schur_complement_path.startswith("column-probe"), f"{label}: not the probe")
        cost_gap(label, s, ref, 1e-8)
        steps = s.num_successful_steps + s.num_unsuccessful_steps
        print(f"[{label}] {steps} LM steps in {s.minimizer_time_in_seconds:.4f} s: "
              f"{steps / s.minimizer_time_in_seconds:.4f} LM steps/s; a damped solve "
              f"{s.linear_solver_time_in_seconds / s.num_linear_solves:.4f} s (host clock); "
              f"capture {s.device_loop_capture_time_in_seconds:.4f} s; peak {peak:.3f} GiB; "
              f"kernel launches {json.dumps(n)} for {s.num_linear_solves} damped solves"
              + (" (counts captures)" if loop == "device loop" else ""))
        check(n["K3"] == 0, f"{label}: K3 launched on the probe path")
        if loop == "host loop":
            check(n["K2 update"] >= (panels - 1) * s.num_linear_solves > 0
                  and n["K1"] >= panels * s.num_linear_solves,
                  f"{label}: K2 not over {panels} panels on every damped solve")
        else:
            check(n["K2 update"] >= panels - 1, f"{label}: K2 not in the captured step")
        launches[f"Dubrovnik shape split float64 {loop} (probe)"] = n
    # one damped solve's column probe, and the whole damped solve, timed
    program = build_split_bal_problem(bal)[0].compile()
    schur, data, g, diag = linearize(program, device, torch.float64)
    asm = first_assembly(schur, data, g, diag)
    torch.cuda.reset_peak_memory_stats()
    probe_ms = cuda_ms(lambda: schur._dense_s(asm), reps=3, calls=1)
    eye = torch.zeros((schur.num_f, PROBE_CHUNK), dtype=torch.float64, device=device)
    eye[:PROBE_CHUNK].diagonal().fill_(1.0)
    chunk_ms = cuda_ms(lambda: schur._s_matmat(asm, eye), reps=3, calls=1)
    solve_ms = cuda_ms(lambda: schur.solve_damped(data, g, diag, 1e-4, 1e-6, 1e32), reps=3, calls=1)
    print(f"[dubrovnik probe] float64: S ({schur.num_f} rows) by the column probe "
          f"{probe_ms:.3f} ms ({-(-schur.num_f // PROBE_CHUNK)} chunks; one chunk "
          f"{chunk_ms:.3f} ms); the whole damped solve (the probe, K2 over {panels} panels, the "
          f"back-substitution) {solve_ms:.3f} ms; median of 3; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del schur, data, g, diag, asm, eye
    torch.cuda.empty_cache()
    return launches


def split_venice_bal(program, initial):
    """The venice scene of phases 10-26 as a BalProblem, from its compiled
    program and initial values (no second generation)."""
    from skeres_tpu_torch.io.bal import BalProblem

    batch = program.batches[0]
    return BalProblem(cameras=initial[0], points=initial[1],
                      camera_index=np.asarray(batch.slot_indices[0]),
                      point_index=np.asarray(batch.slot_indices[1]),
                      observations=np.asarray(batch.data))


def phase_split_venice(device, program, initial) -> dict:
    """Phase 30: venice shape split (two retained groups, 16,002 retained
    coordinates): the generic S product timed, one chunk of the column
    probe timed and checked, ITERATIVE_SCHUR with SCHUR_JACOBI on both
    loops. Returns the launches by path."""
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.schur import PROBE_CHUNK
    from skeres_tpu_torch.core.types import PreconditionerType
    from skeres_tpu_torch.io.bal import build_split_bal_problem

    t0 = time.time()
    bal = split_venice_bal(program, initial)
    problem = build_split_bal_problem(bal)[0]
    split = problem.compile()
    print(f"[split venice] poses (6) and intrinsics (3) of {bal.num_cameras} cameras, "
          f"{bal.num_points} points, {bal.num_observations} observations; built and compiled "
          f"in {time.time() - t0:.2f} s")
    torch.cuda.empty_cache()
    schur, data, g, diag = linearize(split, device, torch.float32, VENICE_CHUNK, iterative=True,
                                     preconditioner=PreconditionerType.SCHUR_JACOBI)
    asm = first_assembly(schur, data, g, diag)
    gen = torch.Generator(device=device).manual_seed(1)
    v = torch.randn(schur.num_f, device=device, dtype=torch.float32, generator=gen)
    ms = cuda_ms(lambda: schur._s_matvec(asm, v), calls=3)
    print(f"[split venice] one generic S product (two retained slots a row: 8 row products, 3 "
          f"gathers, 3 segment sums over {asm['per_batch'][0][1].shape[0]} rows) float32: "
          f"{ms:.4f} ms (median of 20 runs; phase 18 times the unsplit product)")
    eye = torch.zeros((schur.num_f, PROBE_CHUNK), dtype=torch.float32, device=device)
    eye[:PROBE_CHUNK].diagonal().fill_(1.0)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    chunk_ms = cuda_ms(lambda: schur._s_matmat(asm, eye), reps=3, calls=1)
    extra = (torch.cuda.max_memory_allocated() - base) / 2**30
    cols = schur._s_matmat(asm, eye)
    for j in (0, 77):
        e_j = eye[:, j].contiguous()
        err, rel = rel_err(cols[:, j], schur._s_matvec(asm, e_j))
        check(rel <= 1e-5, f"split venice: probe column {j} differs from S e_j by {rel:.3e}")
    chunks = -(-schur.num_f // PROBE_CHUNK)
    print(f"[split venice] one column-probe chunk (S on {PROBE_CHUNK} identity columns) float32: "
          f"{chunk_ms:.3f} ms (median of 3), {extra:.3f} GiB above the assembly; columns 0 and 77 "
          f"equal S e_j; a DENSE_SCHUR damped solve here would run {chunks} chunks: "
          f"~{chunks * chunk_ms / 1e3:.2f} s before K2 (not run)")
    del schur, data, g, diag, asm, eye, cols, v
    torch.cuda.empty_cache()
    launches = {}
    for loop in ("host loop", "device loop"):
        label = f"split venice ITERATIVE_SCHUR SCHUR_JACOBI {loop}"
        for grp, vals in zip(split.groups, (initial[0][:, :6], initial[0][:, 6:], initial[1])):
            grp.values = np.ascontiguousarray(vals)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        s = stt.solve(venice_options(device, "ITERATIVE_SCHUR", "SCHUR_JACOBI",
                                     use_device_loop=loop == "device loop"), problem, split)
        n = check_no_launches(label)
        steps = s.num_successful_steps + s.num_unsuccessful_steps
        costs = [it.cost for it in s.iterations]
        print(f"[{label}] path {s.schur_complement_path}; costs {json.dumps(costs)}; PCG steps "
              f"{[it.linear_solver_iterations for it in s.iterations[1:]]}; {steps} LM steps in "
              f"{s.minimizer_time_in_seconds:.4f} s: {steps / s.minimizer_time_in_seconds:.4f} "
              f"LM steps/s; capture {s.device_loop_capture_time_in_seconds:.4f} s; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        check(s.schur_complement_path == "implicit", f"{label}: path {s.schur_complement_path}")
        check(all(math.isfinite(c) for c in costs) and s.final_cost < s.initial_cost,
              f"{label}: no descent")
        launches[label] = n
    return launches


# -- the camera-padded layout (phase 37) -------------------------------------------

LAYOUT_RUNS = 3  # LM steps/s of each form and loop: medians of 3, in turns
GENERIC = 10**12  # jacobian_sort_threshold of the generic path


def layout_forms(program, device, dtype):
    """The minimizer's linearization of ITERATIVE_SCHUR (SCHUR_JACOBI) in
    both forms on one evaluator: {form: (schur, minimizer)}, the padded
    layout at the default gates and the generic path."""
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.minimizer import TrustRegionMinimizer
    from skeres_tpu_torch.core.schur import SchurSolver
    from skeres_tpu_torch.core.summary import Summary
    from skeres_tpu_torch.core.types import LinearSolverType, PreconditionerType

    ev = Evaluator(program, device, dtype, chunk_size=VENICE_CHUNK)
    options = stt.SolverOptions(linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
                                device=device, dtype=dtype, evaluation_chunk_size=VENICE_CHUNK)
    forms = {}
    for form, kw in (("padded", {}), ("generic", dict(sort_threshold=GENERIC))):
        schur = SchurSolver(ev, iterative=True, preconditioner=PreconditionerType.SCHUR_JACOBI,
                            **kw)
        forms[form] = (schur, TrustRegionMinimizer(ev, options, Summary(),
                                                   LinearSolverType.ITERATIVE_SCHUR,
                                                   schur_solver=schur))
    return ev, forms


def layout_products(forms, state):
    """Each form's linearization at ``state``, its first damped solve's
    assembly (mu 1e-4) and S product on one random vector: {form: (asm,
    S v, v)}."""
    from skeres_tpu_torch.core.linear_solvers import lm_diagonal

    out = {}
    for form, (schur, m) in forms.items():
        _, g, diag, data, scale, _, _ = m.linearize(state)
        asm = schur._assemble(data, g * scale, lm_diagonal(diag * scale**2, 1e-4, 1e-6, 1e32))
        gen = torch.Generator(device=g.device).manual_seed(1)
        v = torch.randn(schur.num_f, dtype=g.dtype, device=g.device, generator=gen)
        out[form] = (asm, schur._s_matvec(asm, v), v)
    return out


def phase_venice_layout(device, problem, program, cams, initial) -> dict:
    """37: the camera-padded layout at venice shape. The plan; the padded S
    product on the minimizer's path (unscaled placed rows, the Jacobi scale
    conjugated) against the generic one, float64 to 1e-12, both timed in
    float32, with one linearization and its g/diag pass in each form; the
    float64 trajectories of DENSE_SCHUR and ITERATIVE_SCHUR (SCHUR_JACOBI)
    with cameras 0 and 1 constant from initial radius 1, layout against
    generic, within 1e-8 a step with the same decisions; float32 DENSE_SCHUR LM steps/s of both
    forms on both loops (medians of 3, in turns) and the gap between
    identical runs of each form. Returns the launches by path."""
    from torch.profiler import ProfilerActivity, profile

    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core import schur as schur_mod
    from tools_torch.trace_spans import span_table

    def restore():
        for grp, v in zip(program.groups, initial):
            grp.values = v.copy()

    restore()
    state = program.initial_state(device, torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ev, forms = layout_forms(program, device, torch.float32)
    plan_s = span_table(prof.profiler.kineto_results.events())["skeres.plan.layout"]["host_s"]
    schur = forms["padded"][0]
    check(list(schur.sorted_info) == [0] and not forms["generic"][0].sorted_info,
          f"layout: not engaged at venice shape ({schur.camera_padded_layout})")
    info = schur.sorted_info[0]
    n_rows = program.batches[0].num_blocks
    m, T = program.batches[0].residual_dim, program.batches[0].block_tangent_size
    placed = info["nc"] * info["K"] * m * (T + 1) * 4
    print(f"[layout] plan: {schur.camera_padded_layout}; nc {info['nc']}, K {info['K']}, waste "
          f"nc K / B = {info['nc'] * info['K'] / n_rows:.6f} over {n_rows} rows; the placed "
          f"(jac | r) copy {placed} bytes in float32 ({placed / 2**20:.1f} MiB); the plan "
          f"{plan_s:.4f} s of set-up (host; its span, the generic form's refusal included)")

    # the S product on the minimizer's path, and one linearization, float32
    prods = layout_products(forms, state)
    (asm_p, sv_p, v), (asm_g, sv_g, _) = prods["padded"], prods["generic"]
    err32, rel32 = rel_err(sv_p, sv_g)
    check(bool((asm_p["cam_scale"] != 1).any()),
          "layout: the padded rows are not the unscaled copy with the Jacobi scale beside them")
    t = [cuda_ms(lambda: forms["generic"][0]._s_matvec(asm_g, v), calls=3),
         cuda_ms(lambda: schur._s_matvec(asm_p, v), calls=3),
         cuda_ms(lambda: schur._s_matvec(asm_p, v), calls=3),
         cuda_ms(lambda: forms["generic"][0]._s_matvec(asm_g, v), calls=3)]
    print(f"[layout] one implicit S product float32 (CUDA events, median of 20, in turns): "
          f"generic {t[0]:.4f}/{t[3]:.4f} ms, padded {t[1]:.4f}/{t[2]:.4f} ms; padded against "
          f"generic {err32:.3e} (rel {rel32:.3e})")
    del prods, asm_p, asm_g, sv_p, sv_g
    torch.cuda.empty_cache()
    _, blocks = ev.blocks(state)
    gd = {"generic": lambda: ev.gradient_and_diag(blocks),
          "padded": lambda: schur.gradient_and_diag(blocks)}
    lin = {f: (lambda mm=mm: mm.linearize(state)) for f, (_, mm) in forms.items()}
    order = ("generic", "padded", "padded", "generic")
    t_gd = [cuda_ms(gd[f], reps=5, calls=1) for f in order]
    del blocks
    torch.cuda.empty_cache()
    t_lin = [cuda_ms(lin[f], reps=3, calls=1) for f in order]
    print(f"[layout] g and diag float32 (CUDA events, median of 5, in turns): generic "
          f"(index_add_ camera sums) {t_gd[0]:.4f}/{t_gd[3]:.4f} ms, padded (the placement "
          f"gather and reshape sums) {t_gd[1]:.4f}/{t_gd[2]:.4f} ms; one whole linearization "
          f"(evaluation, g and diag, scaling, prepare; median of 3): generic "
          f"{t_lin[0]:.4f}/{t_lin[3]:.4f} ms, padded {t_lin[1]:.4f}/{t_lin[2]:.4f} ms")
    del ev, forms, schur, gd, lin, state
    torch.cuda.empty_cache()

    # the S product on the minimizer's path in float64: the gate
    ev, forms = layout_forms(program, device, torch.float64)
    prods = layout_products(forms, program.initial_state(device, torch.float64))
    err64, rel64 = rel_err(prods["padded"][1], prods["generic"][1])
    print(f"[layout] S product float64, the minimizer's path (cam_scale set): padded against "
          f"generic {err64:.3e} (rel {rel64:.3e})")
    check(rel64 <= 1e-12, f"layout: padded S product {rel64:.3e} > 1e-12 from the generic one")
    del ev, forms, prods
    torch.cuda.empty_cache()

    launches = {}
    # float64 trajectories on the gauged scene (a well-posed trajectory)
    problem.set_parameter_block_constant(cams[0])
    problem.set_parameter_block_constant(cams[1])
    try:
        gauged = problem.compile()
        for solver, precond in (("DENSE_SCHUR", "JACOBI"), ("ITERATIVE_SCHUR", "SCHUR_JACOBI")):
            runs = {}
            for form, thresh in (("padded", 100_000), ("generic", GENERIC)):
                restore()
                torch.cuda.empty_cache()
                products = []  # the implicit S products the solve makes
                product = schur_mod.implicit_s_product

                def counting(*args, product=product, products=products):
                    products.append(1)
                    return product(*args)

                schur_mod.implicit_s_product = counting
                reset_launches()
                try:
                    # initial radius 1, as phases 17, 23 and 31: every decision
                    # on a cost change far above rounding (at the default radius
                    # ITERATIVE_SCHUR's rejected candidates reach a cost of
                    # 8.5e17, whose value moves by 1.4e-7 between the two forms)
                    s = stt.solve(venice_options(device, solver, precond, dtype=torch.float64,
                                                 jacobian_sort_threshold=thresh,
                                                 initial_trust_region_radius=1.0), problem, gauged)
                finally:
                    schur_mod.implicit_s_product = product
                runs[form] = s
                n = launches[f"venice layout float64 {solver} {form}"] = launch_counts()
                n.update(check_snavely_launches(f"layout float64 {solver} {form}", s, n))
                # the camera blocks (SCHUR_JACOBI, the explicit S's diagonal)
                # from the placed rows once a damped solve, in the padded form
                blocks = s.num_linear_solves if form == "padded" else 0
                print(f"[layout] float64 {solver} {form}: {s.num_linear_solves} damped solves, "
                      f"camera blocks launches {n['S blocks']}")
                check(n["S blocks"] == blocks, f"layout float64 {solver} {form}: camera blocks "
                      f"launched {n['S blocks']} times, expected {blocks}")
                if solver == "DENSE_SCHUR":
                    check(n["K3"] >= s.num_linear_solves > 0 and n["K2 update"] > 0,
                          f"layout float64 DENSE_SCHUR {form}: K3 or K2 did not launch")
                else:  # the pair on each product of the padded batch, on no other
                    pair = len(products) if form == "padded" else 0
                    print(f"[layout] float64 {solver} {form}: {len(products)} S products, "
                          f"launches point {n['S point']}, camera {n['S camera']}")
                    check(len(products) > 0 and n["S point"] == n["S camera"] == pair,
                          f"layout float64 {solver} {form}: launches {n} for {len(products)} "
                          f"S products, expected {pair} of each kernel")
            p, g = runs["padded"], runs["generic"]
            a = np.array([it.cost for it in p.iterations])
            b = np.array([it.cost for it in g.iterations])
            same = ([(it.step_is_successful, it.linear_solver_iterations) for it in p.iterations]
                    == [(it.step_is_successful, it.linear_solver_iterations)
                        for it in g.iterations])
            gap = float(np.max(np.abs(a - b) / b)) if len(a) == len(b) else math.inf
            print(f"[layout] float64 {solver} {precond}, cameras 0 and 1 constant, initial "
                  f"radius 1, {VENICE_STEPS} steps ({p.total_time_in_seconds:.2f} s and "
                  f"{g.total_time_in_seconds:.2f} s): "
                  f"padded ({p.camera_padded_layout}) costs {json.dumps(list(a))} against generic "
                  f"{json.dumps(list(b))}: max relative gap a step {gap:.3e}; the same decisions "
                  f"and linear solver iterations: {same}; path {p.schur_complement_path}")
            check(same and p.schur_complement_path == g.schur_complement_path,
                  f"layout float64 {solver}: the decisions differ")
            check(gap <= 1e-8, f"layout float64 {solver}: {gap:.3e} > 1e-8 a step")
            check(p.camera_padded_layout.startswith(f"batch 0: {VENICE['num_cameras']} x ")
                  and g.camera_padded_layout.startswith("batch 0: off (gate: "),
                  f"layout float64 {solver}: the forms did not take their paths")
    finally:
        problem.set_parameter_block_variable(cams[0])
        problem.set_parameter_block_variable(cams[1])
        restore()

    # float32 LM steps/s of both forms on both loops, in turns; the gap
    # between identical runs of one form
    for loop in ("host", "device"):
        kw = dict(use_device_loop=True, device_loop_chunk_iterations=VENICE_STEPS) \
            if loop == "device" else {}
        runs = {"padded": [], "generic": []}
        for form in ("padded", "generic", "generic", "padded", "padded", "generic"):
            restore()
            torch.cuda.empty_cache()
            reset_launches()
            s = stt.solve(venice_options(device, jacobian_sort_threshold=(
                100_000 if form == "padded" else GENERIC), **kw), problem, program)
            check(all(math.isfinite(it.cost) for it in s.iterations)
                  and s.final_cost < s.initial_cost, f"layout float32 {loop} {form}: no descent")
            runs[form].append(((len(s.iterations) - 1) / s.minimizer_time_in_seconds,
                               s.final_cost, launch_counts()))
        for form, rs in runs.items():
            rates, finals = [r[0] for r in rs], [r[1] for r in rs]
            gap = (max(finals) - min(finals)) / min(finals)
            print(f"[layout] float32 DENSE_SCHUR {loop} loop, {form}: LM steps/s median "
                  f"{statistics.median(rates):.4f} ({spread(rates)}); final costs "
                  f"{json.dumps(finals)}: gap between identical runs {gap:.3e}")
            launches[f"venice layout float32 DENSE_SCHUR {loop} loop {form} (3 runs)"] = {
                k: sum(r[2][k] for r in rs) for k in rs[0][2]}
    restore()
    return launches


def general_problem(between=False, priors=False):
    """The three-signature problem of tests/test_schur_general.py (3 poses
    of 4, 3 intrinsics of 2, 12 points of 3, eliminated; batches (pose,
    intrinsics, point), (pose, point) and a pose prior), optionally with
    the points declared between the retained groups, and with priors on the
    points and intrinsics (a full-rank J^T J for the covariance)."""
    import skeres_tpu_torch as stt

    rng = np.random.default_rng(11)
    pose_v = rng.standard_normal((3, 4)) * 0.5
    intr_v = 1.0 + 0.1 * rng.standard_normal((3, 2))
    pt_v = rng.standard_normal((12, 3))
    problem = stt.Problem()
    poses = problem.add_parameter_block_array(pose_v, name="poses")
    if between:
        pts = problem.add_parameter_block_array(pt_v, name="points")
        intrs = problem.add_parameter_block_array(intr_v, name="intrs")
    else:
        intrs = problem.add_parameter_block_array(intr_v, name="intrs")
        pts = problem.add_parameter_block_array(pt_v, name="points")
    problem.set_schur_elimination_group(pts, 0)
    problem.set_schur_elimination_group(poses, 1)
    problem.set_schur_elimination_group(intrs, 1)
    pose_idx = np.repeat(np.arange(3), 12)
    pt_idx = np.tile(np.arange(12), 3)
    mono_data = rng.standard_normal((36, 2))

    def mono(params, data):
        pose, intr, pt = params
        u = torch.tanh(pose[0] + 0.3 * pt[0]) * intr[0]
        v = (pose[2] + pose[3] * pt[2]) * intr[1]
        return torch.stack([u - data[0], v * 0.5 - data[1]])

    def stereo(params, data):
        pose, pt = params
        return torch.stack([pose[0] * pt[0] + pose[1], pose[2] * pt[1] - pose[3] * pt[2],
                            torch.sum(pose[:3] * pt)]) - data

    problem.add_residual_blocks(mono, None, [(poses, pose_idx), (intrs, pose_idx.copy()),
                                             (pts, pt_idx)], data=mono_data)
    sel = rng.choice(36, size=14, replace=False)
    problem.add_residual_blocks(stereo, None, [(poses, pose_idx[sel]), (pts, pt_idx[sel])],
                                data=rng.standard_normal((14, 3)))
    problem.add_residual_blocks(lambda p, d: 0.7 * (p[0] - d), None, [(poses, np.arange(3))],
                                data=rng.standard_normal((3, 4)) * 0.1)
    if priors:
        problem.add_residual_blocks(lambda p, d: 0.5 * (p[0] - d), None, [(pts, np.arange(12))],
                                    data=np.zeros((12, 3)))
        problem.add_residual_blocks(lambda p, d: 0.5 * (p[0] - d), None, [(intrs, np.arange(3))],
                                    data=np.ones((3, 2)))
    return problem, poses, intrs, pts


def phase_general_card_vs_cpu(device) -> dict:
    """Phase 31: the general structure, float64, card against CPU: the
    three-signature problem, the same with the points between the retained
    groups, and the ellipse (three slots a row); DENSE_SCHUR (the column
    probe, K1) and ITERATIVE_SCHUR with JACOBI, SCHUR_JACOBI and
    POWER_SERIES_EXPANSION on both loops; then the SCHUR_COMPLEMENT
    covariance against DENSE_SVD. Returns the launches by path."""
    import skeres_tpu_torch as stt
    from examples_torch.ellipse_approximation import build_problem as ellipse_problem
    from skeres_tpu_torch.core.covariance import Covariance, CovarianceOptions
    from skeres_tpu_torch.core.types import CovarianceAlgorithmType, LinearSolverType
    from skeres_tpu_torch.core.types import PreconditionerType

    scenes = {"three-signature": lambda: general_problem()[0],
              "points between": lambda: general_problem(between=True)[0],
              "ellipse": lambda: ellipse_problem(60, 10)}
    launches, worst = {}, 0.0
    for scene, build in scenes.items():
        for solver, precond in GENERAL_SOLVERS:
            for loop in ("host loop", "device loop"):
                label = f"general {scene} {solver} {precond} {loop}"
                runs = {}
                for dev in (device, "cpu"):
                    reset_launches()
                    runs[dev] = stt.solve(stt.SolverOptions(
                        linear_solver_type=LinearSolverType[solver],
                        preconditioner_type=PreconditionerType[precond], max_num_iterations=9,
                        eta=1e-10, initial_trust_region_radius=1.0, run_full_iteration_budget=True,
                        use_device_loop=loop == "device loop", device_loop_chunk_iterations=3,
                        dtype=torch.float64, device=dev), build())
                    if dev == device:
                        n = launch_counts()
                worst = max(worst, same_trajectory(label, runs[device], runs["cpu"], 1e-8))
                card = runs[device]
                if solver == "DENSE_SCHUR":
                    check(card.schur_complement_path.startswith("column-probe"),
                          f"{label}: path {card.schur_complement_path}")
                    check(n["K1"] >= (card.num_linear_solves if loop == "host loop" else 1) > 0,
                          f"{label}: K1 launched {n['K1']} times")
                else:
                    check(not any(n.values()), f"{label}: a kernel launched")
                launches[label] = n
    print(f"[general] {len(launches)} trajectories card against CPU, the largest relative cost "
          f"difference {worst:.3e}")
    # covariance at the CPU's solution, on both devices
    problem, poses, intrs, pts = general_problem(priors=True)
    stt.solve(stt.SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR,
                                max_num_iterations=50, device="cpu"), problem)
    covs = {}
    for dev in (device, "cpu"):
        for algorithm in ("SCHUR_COMPLEMENT", "DENSE_SVD"):
            cov = Covariance(CovarianceOptions(
                algorithm_type=CovarianceAlgorithmType[algorithm], device=dev))
            check(cov.compute(problem), f"general covariance {algorithm} on {dev}: compute failed")
            covs[(dev, algorithm)] = cov
    pairs = [(poses[0], poses[2]), (poses[1], intrs[1]), (intrs[2], pts[5]), (pts[3], pts[3]),
             (pts[0], pts[11]), (pts[7], poses[2])]
    gap = 0.0
    for a, b in pairs:
        want = covs[("cpu", "DENSE_SVD")].get_covariance_block_in_tangent_space(a, b)
        scale = np.abs(want).max()
        for key, cov in covs.items():
            got = cov.get_covariance_block_in_tangent_space(a, b)
            gap = max(gap, float(np.abs(got - want).max() / scale))
    print(f"[general covariance] SCHUR_COMPLEMENT (S by the column probe) and DENSE_SVD, card and "
          f"CPU, against the CPU's DENSE_SVD over {len(pairs)} block pairs of every type: the "
          f"largest difference {gap:.3e} of a block's largest entry")
    check(gap <= 1e-8, f"general covariance: blocks differ by {gap:.3e}")
    return launches


def run_tool(label: str, args, timeout: int = 600) -> str:
    """``python -m <args>`` from the checkout; its standard output."""
    t0 = time.time()
    out = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                         timeout=timeout, cwd=ROOT)
    check(out.returncode == 0, f"{label}: exit {out.returncode}\n{out.stdout[-2000:]}\n"
          f"{out.stderr[-4000:]}")
    print(f"[tools] {label}: exit 0 in {time.time() - t0:.1f} s")
    return out.stdout


def report_cost(stdout: str, which: str) -> float:
    """The Initial or Final cost of a full report printed by a tool."""
    import re

    return float(re.search(rf"^{which}\s+(\S+)", stdout, re.M).group(1))


def write_square_g2o(directory: str) -> str:
    """A 2-D square loop of four poses: exact relative measurements (1, 0,
    pi/2), identity information, perturbed initial poses."""
    path = os.path.join(directory, "square.g2o")
    init = [(0.0, 0.0, 0.0), (1.1, -0.1, 1.4), (0.9, 1.2, 3.0), (-0.1, 0.9, -1.4)]
    lines = [f"VERTEX_SE2 {i} {x} {y} {t}" for i, (x, y, t) in enumerate(init)]
    lines += [f"EDGE_SE2 {i} {(i + 1) % 4} 1.0 0.0 {np.pi / 2} 1 0 0 1 0 1" for i in range(4)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` with its standard output swallowed (the
    examples print their reports and progress)."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kw)


def phase_tools(device) -> dict:
    """Phase 32: the CLIs in subprocesses and every example's ``main()`` on
    the card, by default (no device given), each with the assertion of its
    test. Returns the launches by path."""
    import tempfile

    import examples_torch.bundle_adjuster as ex_ba
    import examples_torch.curve_fitting as ex_curve
    import examples_torch.denoising as ex_denoise
    import examples_torch.ellipse_approximation as ex_ellipse
    import examples_torch.helloworld as ex_hello
    import examples_torch.more_garbow_hillstrom as ex_mgh
    import examples_torch.nist as ex_nist
    import examples_torch.pose_graph_2d as ex_pg2
    import examples_torch.pose_graph_3d as ex_pg3
    import examples_torch.powell as ex_powell
    import examples_torch.robot_pose_mle as ex_robot
    import examples_torch.rosenbrock as ex_rosen
    import examples_torch.sampled_function as ex_sampled
    from skeres_tpu_torch.io.bal import load_bal, parse_bal_text, synthetic_bal, write_bal

    out = run_tool("bundle_adjuster BAL-49", ["skeres_tpu_torch.cli.bundle_adjuster",
                                               "--num_cameras", "49", "--num_points", "7776",
                                               "--max_iterations", "30"])
    final = report_cost(out, "Final")
    print(f"[tools] bundle_adjuster BAL-49 (float64 on the card): final cost {final!r} (phase 6: "
          f"{BAL49_FINAL})")
    check(abs(final / BAL49_FINAL - 1.0) <= 1e-5, f"bundle_adjuster: final cost {final}")
    out = run_tool("pose_graph_3d sphere2500", ["skeres_tpu_torch.cli.pose_graph_3d",
                                                "--num_poses", "2500"])
    chi2 = 2.0 * report_cost(out, "Final")
    print(f"[tools] pose_graph_3d --num_poses 2500: chi^2 {2.0 * report_cost(out, 'Initial')!r} "
          f"-> {chi2!r} (phase 24: {SPHERE_CHI2})")
    check(abs(chi2 - SPHERE_CHI2) <= 0.01, f"pose_graph_3d: chi^2 {chi2}")
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        g2o = write_square_g2o(tmp)
        run_tool("pose_graph_2d square", ["skeres_tpu_torch.cli.pose_graph_2d", "--input", g2o,
                                          "--output", os.path.join(tmp, "poses.txt")])
        sol = np.loadtxt(os.path.join(tmp, "poses.txt"))
        check(np.abs(sol[:, :2] - [[0, 0], [1, 0], [1, 1], [0, 1]]).max() < 1e-6,
              "pose_graph_2d: the square is not recovered")
        print(f"[tools] pose_graph_2d recovers the square: {sol.tolist()}")
        bal49 = synthetic_bal(49, 7776, 4)
        txt = write_bal(os.path.join(tmp, "bal49.txt"), bal49)
        t0 = time.perf_counter()
        load_bal(txt)  # the native parser's g++ build
        build_s = time.perf_counter() - t0
        parse_s = {}
        for name, parse in (("native", load_bal), ("python", parse_bal_text)):
            t0 = time.perf_counter()
            got = parse(txt)
            parse_s[name] = time.perf_counter() - t0
            check(all(np.array_equal(getattr(got, f), getattr(bal49, f))
                      for f in ("cameras", "points", "camera_index", "point_index",
                                "observations")), f"load_bal: the {name} parse differs")
        print(f"[tools] BAL-49 as a .txt ({os.path.getsize(txt)} bytes) parsed bit for bit: "
              f"load_bal (native) {parse_s['native']:.4f} s, parse_bal_text "
              f"{parse_s['python']:.4f} s (host clock; the native build {build_s:.2f} s)")
        launches = {}
        results = {}
        t0 = time.time()
        reset_launches()
        s = quiet(ex_ellipse.main, num_points=60, num_segments=10)
        launches["ellipse example (column probe)"] = launch_counts()
        check(s.termination_type.name == "CONVERGENCE" and s.final_cost < 0.1 * s.initial_cost
              and s.schur_complement_path.startswith("column-probe"), "ellipse example")
        check(launches["ellipse example (column probe)"]["K1"] >= s.num_linear_solves > 0,
              "ellipse example: K1 not on every damped solve")
        results["ellipse_approximation"] = (s.initial_cost, s.final_cost)
        x = quiet(ex_sampled.main)
        check(abs(x - 4.5) < 1e-3, f"sampled_function: x = {x}")
        results["sampled_function"] = x
        dead, mle = quiet(ex_robot.main, [])
        check(mle < 0.3 * dead, "robot_pose_mle")
        results["robot_pose_mle"] = (dead, mle)
        noisy, restored = quiet(ex_denoise.main, ["--side", "32"])
        check(restored < 0.7 * noisy, "denoising")
        results["denoising"] = (noisy, restored)
        s, sol = quiet(ex_rosen.main)
        check(s.final_cost < 1e-10 and np.abs(sol - 1.0).max() < 1e-4, "rosenbrock")
        results["rosenbrock"] = sol.tolist()
        results["more_garbow_hillstrom"] = quiet(ex_mgh.main, ["--problem", "5"])
        check(results["more_garbow_hillstrom"] == (1, 1), "more_garbow_hillstrom")
        results["nist"] = quiet(ex_nist.main, ["--difficulty", "lower"])
        check(results["nist"][0] == results["nist"][1] > 0, "nist")
        s, x = quiet(ex_hello.main)
        check(abs(x - 10.0) < 1e-6, "helloworld")
        results["helloworld"] = x
        for robust in ([], ["--robustify"]):
            s, (m, c) = quiet(ex_curve.main, robust)
            check(abs(m - 0.3) < 0.03 and abs(c - 0.1) < 0.1, f"curve_fitting {robust}")
            results["curve_fitting" + "".join(robust)] = (m, c)
        s, xs = quiet(ex_powell.main, [])
        check(s.final_cost < 1e-12, "powell")
        results["powell"] = s.final_cost
        s = quiet(ex_ba.main, ["--num_cameras", "16", "--num_points", "500",
                               "--max_iterations", "10"])
        check(s.final_cost < s.initial_cost, "bundle_adjuster shim")
        results["bundle_adjuster shim"] = s.final_cost
        s = quiet(ex_pg2.main, ["--input", g2o])
        check(s.final_cost < 1e-12, "pose_graph_2d shim")
        s = quiet(ex_pg3.main, ["--num_poses", "200", "--max_iterations", "10"])
        check(s.final_cost < s.initial_cost, "pose_graph_3d shim")
        results["pose_graph_3d shim"] = s.final_cost
    print(f"[tools] the 13 examples on the card (default device) in {time.time() - t0:.1f} s, each "
          f"with its test's assertion: {json.dumps(results)}")
    return launches


# -- DENSE_QR under the device loop; the obs mesh on torch.distributed -----------------

MGH_QR = (8, 17, 201)  # bard, osborne1, watson_n6: minima above zero
BAL49 = dict(num_cameras=49, num_points=7776, observations_per_point=4)
MESH_RANKS = 3  # gloo ranks sharing cuda:0: NCCL refuses two ranks on one card
MESH_TIMEOUT = 600  # seconds a phase's ranks may take


def phase_dense_qr_device_loop(device) -> dict:
    """33: DENSE_QR under the device loop (its step by the corrected
    seminormal equations, captured in the step's IF node) against the host
    loop's Householder QR, float64, on a small BAL scene and three MGH
    cases."""
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.types import LinearSolverType
    from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal
    from skeres_tpu_torch.models.mgh import PROBLEMS

    def solve(build, loop, **kw):
        s = stt.solve(stt.SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_QR, use_device_loop=loop,
            device_loop_chunk_iterations=10, dtype=torch.float64, device=device, **kw), build())
        check(not loop or device != "cuda" or s.device_loop_capture_time_in_seconds > 0,
              "DENSE_QR device loop: no graph captured")
        return s

    def mgh(p):
        def build():
            problem = stt.Problem()
            x = problem.add_parameter_block(np.asarray(p.x0, dtype=np.float64))
            problem.add_residual_block(lambda params, data: p.residual(params[0]), None, [x])
            return problem
        return build

    reset_launches()
    cases = [("synthetic_bal(6, 60, 4)", lambda: build_bal_problem(synthetic_bal(6, 60, 4))[0],
              dict(max_num_iterations=10, initial_trust_region_radius=1.0), None)]
    cases += [(PROBLEMS[n].name, mgh(PROBLEMS[n]), dict(max_num_iterations=100), PROBLEMS[n])
              for n in MGH_QR]
    for label, build, kw, p in cases:
        loop, host = solve(build, True, **kw), solve(build, False, **kw)
        same_trajectory(f"dense-qr-loop {label}", loop, host, 1e-8,
                        names=("the device loop", "the host loop"))
        check(p is None or p.certified(2.0 * loop.final_cost),
              f"DENSE_QR device loop: {label} not certified")
    return {"DENSE_QR device loop (BAL, MGH)": check_no_launches("dense-qr-loop", SNAVELY)}


def mesh_ranks(case: str, world: int, device: str = "cuda") -> list:
    """Run ``case`` on ``world`` ranks, each a process of this script
    (``--mesh-rank``) on ``device`` (gloo for several ranks on one card,
    NCCL for one): every rank's report, in rank order. A rank that fails,
    or outlasts ``MESH_TIMEOUT``, fails the phase."""
    from skeres_tpu_torch.parallel.dryrun import run_ranks

    outs = run_ranks(lambda store, r: [sys.executable, os.path.abspath(__file__), "--mesh-rank",
                                       str(r), str(world), store, case, device],
                     world, MESH_TIMEOUT)
    reports = []
    for r, out in enumerate(outs):
        lines = out.splitlines()
        for line in lines[:-1]:
            print(f"[{case} rank {r}] {line}")
        reports.append(json.loads(lines[-1]))
    return reports


def sync(device) -> None:
    """Wait for the card (nothing on the CPU, where a rehearsal runs)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def host_ms(fn, reps: int = 3, calls: int = 1) -> float:
    """``cuda_ms``'s counterpart on the host clock, for a CPU rehearsal."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e3 * (time.perf_counter() - t0) / calls)
    return statistics.median(times)


def mesh_kernel_checks(schur, mesh, rank: int, world: int) -> dict:
    """On one rank, at the problem's current values: K3 on the rank's grid
    and on the straddle grid against its plain version (judged on the
    reduced tables), timed on the rank's grid (the ranks in turns); the
    factor of the replicated, equilibrated S of a damped solve by K1 (n <=
    1024) or K2 against its plain version, and a digest of its outputs,
    which every rank must share."""
    import hashlib

    import torch.distributed as dist
    from skeres_tpu_torch.core.explicit_schur import _apply_hierarchical_sum
    from skeres_tpu_torch.ops.cholesky import (
        MAX_CHOLESKY_N,
        blocked_cholesky_factor,
        blocked_cholesky_factor_reference,
        cholesky_both,
        cholesky_both_reference,
    )
    from skeres_tpu_torch.ops.pair_product import pair_products_reference

    ev, plan = schur.ev, schur.explicit_plan
    program = ev.program
    # the first linearization's Jacobi-scaled system, as ``linearize``
    cost, blocks = ev.blocks(program.initial_state(ev.device, ev.dtype))
    g, diag = ev.gradient_and_diag(blocks)
    scale = 1.0 / (1.0 + torch.sqrt(diag))
    prep = schur.prepare(schur.scale_data(schur.solver_data(blocks), scale))
    del blocks
    asm = first_assembly(schur, prep, g * scale, diag * scale * scale)
    cinv = asm["cinv"].reshape(-1, schur.e_size ** 2)
    out = {}
    grids = [("grid", prep["explicit_grid"]["grid"], plan.local_pt, plan.swap_mask,
              plan.pair_valid, plan.levels)]
    if plan.n_straddle:
        grids.append(("fixup", prep["explicit_grid"]["fix"], plan.fix_pt, plan.fix_swap,
                      plan.fix_valid, plan.fix_levels))
    for label, grid, pts, swap, valid, levels in grids:
        args = (grid.contiguous(), cinv[pts].contiguous(), swap, valid)
        kern = _apply_hierarchical_sum(levels, plan._pair_values(*args))
        plain = _apply_hierarchical_sum(levels, pair_products_reference(
            *args, plan.pair_kl, plan.f, plan.e, plan.chunk_points))
        sync(ev.device)
        out[f"k3_{label}_err"] = rel_err(kern, plain)[0] if kern.numel() else 0.0
        out[f"k3_{label}_rel"] = rel_err(kern, plain)[1] if kern.numel() else 0.0
    args = (prep["explicit_grid"]["grid"].contiguous(), cinv[plan.local_pt].contiguous(),
            plan.swap_mask, plan.pair_valid)
    timer = cuda_ms if ev.device.type == "cuda" else host_ms
    for r in range(world):  # one rank at a time on the shared card
        dist.barrier()
        if r == rank:
            out["k3_ms"] = timer(lambda: plan._pair_values(*args), reps=5, calls=5)
            out["k3_plain_ms"] = timer(lambda: pair_products_reference(
                *args, plan.pair_kl, plan.f, plan.e, plan.chunk_points), reps=3, calls=1)
    dist.barrier()
    s = schur._dense_s(asm)
    del prep, asm
    d_eq = torch.sqrt(torch.clamp(torch.diagonal(s), min=torch.finfo(s.dtype).tiny))
    s.div_(d_eq[:, None]).div_(d_eq[None, :])
    digest = hashlib.sha256()
    if s.shape[0] <= MAX_CHOLESKY_N:
        outs = cholesky_both(s)
        refs = cholesky_both_reference(s)
        out["factor"] = "K1"
    else:
        fac = blocked_cholesky_factor(s)
        outs, refs = (fac.l, *fac.dinv), (blocked_cholesky_factor_reference(s),)
        out["factor"] = "K2"
        if rank == 0:  # the backward error in float64, on one rank
            l64 = fac.l.double()
            out["k2_backward"] = float(torch.linalg.norm(l64 @ l64.T - s.double())
                                       / torch.linalg.norm(s.double()))
            del l64
    sync(ev.device)
    out["factor_err"], out["factor_rel"] = rel_err(outs[0], refs[0])
    for t in outs:
        digest.update(t.contiguous().cpu().numpy().tobytes())
    out["factor_digest"] = digest.hexdigest()
    out["s_rows"] = s.shape[0]
    return out


def gauged_bal(scene: dict):
    """The BAL scene ``scene`` with cameras 0 and 1 held constant (the
    7-dof gauge fixed, as phase 23 does): float32 decisions on the
    gauge-free scene turn on rounding (a jitter rung, or a plain factor
    that rounding lets through), so two runs that sum in other orders, or
    one run twice with ``index_add_``'s float32 sums, may part. Returns
    (problem, program)."""
    from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal

    problem, cams, _ = build_bal_problem(synthetic_bal(**scene))
    problem.set_parameter_block_constant(cams[0])
    problem.set_parameter_block_constant(cams[1])
    return problem, problem.compile()


def mesh_case(case: str, mesh, rank: int, world: int, device: str) -> dict:
    """One rank's share of phase 34 (``bal49``), 35 (``venice``) or 36
    (``nccl``); its report."""
    import skeres_tpu_torch as stt
    import skeres_tpu_torch.core.solver as solver_mod
    import torch.distributed as dist
    from skeres_tpu_torch.core import schur as schur_mod
    from skeres_tpu_torch.core.types import LinearSolverType
    from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal
    from skeres_tpu_torch.parallel.mesh import all_reduce_sum

    made = []  # the solves' Schur solvers, for their plans

    class Recorded(schur_mod.SchurSolver):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    solver_mod.SchurSolver = Recorded

    def lm(problem, dtype, steps, m, program=None, **kw):
        return stt.solve(stt.SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_SCHUR, max_num_iterations=steps,
            dtype=dtype, device=device, mesh=m, **kw), problem, program)

    def rows(s):
        return dict(costs=[it.cost for it in s.iterations],
                    accepted=[it.step_is_successful for it in s.iterations],
                    factors=[it.linear_solver_iterations for it in s.iterations],
                    final_cost=s.final_cost,
                    path=s.schur_complement_path, devices=s.num_devices,
                    rate=(len(s.iterations) - 1) / s.minimizer_time_in_seconds,
                    capture=s.device_loop_capture_time_in_seconds)

    if case == "nccl":  # 36: one NCCL rank, the device loop against the unsharded one
        report = {}
        schur_mod.DENSE_W_LIMIT_BYTES = 0  # the explicit path on both sides
        # the trajectory in float64 (float32 runs part by index_add_'s sums);
        # BAL-49's rates in float32, in turns
        scenes = [("BAL-49", BAL49, 30, dict(device_loop_chunk_iterations=30),
                   [(torch.float64, "one"), (torch.float64, "mesh"), (torch.float32, "one"),
                    (torch.float32, "mesh"), (torch.float32, "mesh"), (torch.float32, "one")]),
                  ("venice", VENICE, VENICE_STEPS, {},
                   [(torch.float64, "one"), (torch.float64, "mesh")])]
        for label, scene, steps, kw, order in scenes:
            runs = {}
            for dtype, which in order:
                problem, _ = gauged_bal(scene)
                reset_launches()
                s = lm(problem, dtype, steps, mesh if which == "mesh" else None,
                       use_device_loop=True, run_full_iteration_budget=True, **kw)
                runs.setdefault(f"{which} {str(dtype)[6:]}", []).append(
                    dict(rows(s), launches=launch_counts()))
                if device == "cuda":
                    torch.cuda.empty_cache()
            report[label] = runs
        return report

    report = {}
    if case == "bal49":
        problem = build_bal_problem(synthetic_bal(**BAL49))[0]
        program = problem.compile()
        dtype, steps, kw = torch.float64, 30, {}
    else:  # the float64 trajectory first, then the instrumented float32 solve
        problem, program = gauged_bal(VENICE)
        s = lm(problem, torch.float64, VENICE_STEPS, mesh, program,
               run_full_iteration_budget=True)
        report["costs64"] = [it.cost for it in s.iterations]
        report["accepted64"] = [it.step_is_successful for it in s.iterations]
        problem, program = gauged_bal(VENICE)
        if device == "cuda":
            torch.cuda.empty_cache()
        dtype, steps, kw = torch.float32, VENICE_STEPS, dict(run_full_iteration_budget=True)
    initial = [g.values.copy() for g in program.groups]
    coll = dict(calls=0, bytes=0, ms=0.0)
    plain_all_reduce = dist.all_reduce

    def timed_all_reduce(t, *a, **k):  # the collectives of the solve, timed one by one
        sync(device)
        t0 = time.perf_counter()
        work = plain_all_reduce(t, *a, **k)
        sync(device)
        coll["ms"] += 1e3 * (time.perf_counter() - t0)
        coll["calls"] += 1
        coll["bytes"] += t.numel() * t.element_size()
        return work

    dist.all_reduce = timed_all_reduce
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    s = lm(problem, dtype, steps, mesh, program, **kw)
    dist.all_reduce = plain_all_reduce
    for g, v in zip(program.groups, initial):  # the checks below start where the solve did
        g.values = v
    schur = made[-1]
    plan = schur.explicit_plan
    report.update(rows(s), launches=launch_counts(), rank=rank,
                  rows=list(schur.ev.row_range[0]), points=int(plan.local_pt.numel()),
                  n_straddle=plan.n_straddle, k3_fixup_launches=plan.fix_products,
                  damped_solves=s.num_linear_solves, lm_steps=len(s.iterations) - 1,
                  collectives=coll, peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                                             if device == "cuda" else 0.0),
                  reduce_calls=all_reduce_sum.calls, layout=s.camera_padded_layout)
    check(plan.mesh is not None and s.schur_complement_path == "explicit",
          f"{case}: the explicit plan is not sharded")
    report.update(mesh_kernel_checks(schur, mesh, rank, world))
    return report


def mesh_rank_main(rank: int, world: int, store: str, case: str, device: str) -> None:
    import torch.distributed as dist
    from skeres_tpu_torch.parallel.mesh import initialize_distributed, make_obs_mesh

    if device == "cuda":
        torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(f"file://{store}", world, rank, device_type=device)
    mesh = make_obs_mesh(device_type=device)
    report = mesh_case(case, mesh, rank, world, device)
    print(json.dumps(report), flush=True)
    dist.destroy_process_group()


def check_ranks_agree(label: str, reports: list, keys) -> None:
    """Every rank's ``keys`` equal rank 0's, bit for bit."""
    for r, rep in enumerate(reports[1:], 1):
        for k in keys:
            check(rep[k] == reports[0][k], f"{label}: rank {r}'s {k} differs from rank 0's")


def phase_mesh_bal49(device) -> dict:
    """34: BAL-49 and the dryrun scene sharded over 3 gloo ranks on the
    card, float64, against the unsharded card solve and step."""
    from skeres_tpu_torch.core import schur as schur_mod
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.minimizer import TrustRegionMinimizer
    from skeres_tpu_torch.core.schur import SchurSolver
    from skeres_tpu_torch.core.summary import Summary
    from skeres_tpu_torch.core.types import LinearSolverType
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal
    from skeres_tpu_torch.parallel.dryrun import SCENE, dryrun_multichip

    one = stt.solve(stt.SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR,
                                      max_num_iterations=30, dtype=torch.float64,
                                      device=device), build_bal_problem(synthetic_bal(**BAL49))[0])
    reports = mesh_ranks("bal49", MESH_RANKS, device)
    check_ranks_agree("mesh BAL-49", reports, ("costs", "accepted", "factor_digest", "n_straddle"))
    rep = reports[0]
    a, b = np.array(rep["costs"]), np.array([it.cost for it in one.iterations])
    check(len(a) == len(b) and rep["accepted"] == [it.step_is_successful for it in one.iterations],
          "mesh BAL-49: the sharded decisions differ from the unsharded card solve's")
    gap = float(np.max(np.abs(a - b) / b))
    for r in reports:
        print(f"[mesh-bal49] rank {r['rank']}: rows {r['rows']}, {r['points']} whole points, "
              f"K3 {r['k3_grid_err']:.3e} (rel {r['k3_grid_rel']:.3e}) on its grid, "
              f"{r.get('k3_fixup_err', 0.0):.3e} on the fixup grid; {r['factor']} on S "
              f"({r['s_rows']} rows) {r['factor_err']:.3e} (rel {r['factor_rel']:.3e}); "
              f"launches in the solve {json.dumps(r['launches'])}, fixup K3 "
              f"{r['k3_fixup_launches']}; {r['collectives']['calls']} all_reduces "
              f"({r['collectives']['bytes']} bytes, {r['collectives']['ms']:.2f} ms) over "
              f"{r['lm_steps']} LM steps; peak {r['peak_gib']:.3f} GiB")
    print(f"[mesh-bal49] {MESH_RANKS} gloo ranks on one card, float64: n_straddle "
          f"{rep['n_straddle']}, {len(a) - 1} steps, final cost {a[-1]!r} against the unsharded "
          f"{b[-1]!r} (dense-W path); max relative cost gap a step {gap:.3e}; every rank equal")
    check(gap <= 1e-10, f"mesh BAL-49: {gap:.3e} > 1e-10 from the unsharded solve")
    for r in reports:
        check(r["factor"] == "K1" and r["factor_rel"] <= K1_RTOL[torch.float64],
              f"mesh BAL-49: K1 on S, rank {r['rank']}: rel error {r['factor_rel']:.3e}")
        check(max(r["k3_grid_rel"], r.get("k3_fixup_rel", 0.0)) <= K3_RTOL[torch.float64],
              f"mesh BAL-49: K3 against its plain version, rank {r['rank']}")
        # 31,104 rows split 3 ways end on whole points: no fixup grid here
        fixups = r["damped_solves"] * (r["n_straddle"] > 0)
        check(r["launches"]["K1"] >= r["damped_solves"] > 0
              and r["launches"]["K3"] == r["damped_solves"] + fixups
              and r["k3_fixup_launches"] == fixups,
              f"mesh BAL-49: K1 or K3 (grid, fixup) missing from a damped solve, rank "
              f"{r['rank']}")

    # the dryrun scene: one sharded explicit-S step, K2 on S (1,800 rows)
    dry = dryrun_multichip(MESH_RANKS, f"{device}:0" if device == "cuda" else device)
    check_ranks_agree("dryrun", dry, ("cost", "new_cost", "n_straddle"))
    schur_mod.DENSE_W_LIMIT_BYTES, limit = 0, schur_mod.DENSE_W_LIMIT_BYTES
    try:
        program = build_bal_problem(synthetic_bal(**SCENE))[0].compile()
        ev = Evaluator(program, device, torch.float64)
        m = TrustRegionMinimizer(ev, stt.SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_SCHUR, device=device), Summary(),
            LinearSolverType.DENSE_SCHUR, schur_solver=SchurSolver(ev))
        state = program.initial_state(device, torch.float64)
        cost, g, diag, data, scale, _, _ = m.linearize(state)
        new = m.solve_step(state, data, g, diag, scale, 1e4,
                           torch.zeros((), dtype=torch.float64, device=device))[0]
        ref = float(m.try_step(new)[0])
    finally:
        schur_mod.DENSE_W_LIMIT_BYTES = limit
    dgap = abs(dry[0]["new_cost"] - ref) / ref
    print(f"[mesh-dryrun] {MESH_RANKS} gloo ranks: n_straddle {dry[0]['n_straddle']}, cost "
          f"{dry[0]['cost']!r} -> {dry[0]['new_cost']!r} (unsharded {ref!r}, gap {dgap:.3e}); "
          f"per rank K3 {[d['k3_launches'] for d in dry]} (fixup "
          f"{[d['k3_fixup_launches'] for d in dry]}), K1 panels {[d['k1_launches'] for d in dry]}, "
          f"K2 updates {[d['k2_update_launches'] for d in dry]}, all_reduces "
          f"{[d['all_reduces'] for d in dry]}")
    print(f"[mesh-dryrun] camera-padded layout: {dry[0]['layout']}")
    check(all(f"sharded, {MESH_RANKS} shards" in d["layout"] for d in dry),
          "dryrun: the sharded camera-padded layout did not engage")
    check(dry[0]["n_straddle"] > 0 and dry[0]["new_cost"] < dry[0]["cost"], "dryrun: no step")
    check(dgap <= 1e-10, f"dryrun: {dgap:.3e} > 1e-10 from the unsharded step")
    check(all(d["k3_launches"] == 2 and d["k2_update_launches"] > 0 for d in dry),
          "dryrun: K3 or K2 did not launch")
    sum_ = lambda key: sum(r["launches"][key] for r in reports)  # noqa: E731
    return {
        f"BAL-49 on {MESH_RANKS} gloo ranks, float64 (K3: grid + fixup)": dict(
            K1=sum_("K1"), **{"K2 update": sum_("K2 update")}, K3=sum_("K3")),
        f"dryrun scene on {MESH_RANKS} gloo ranks, one step (K3: grid + fixup)": {
            "K1": sum(d["k1_launches"] for d in dry),
            "K2 update": sum(d["k2_update_launches"] for d in dry),
            "K3": sum(d["k3_launches"] for d in dry)},
    }


# a 5-step float32 solve of the gauged venice scene ends at most this many
# times the float64 solve's final cost: the jitter rungs its rounding
# decides set its path (the largest of 15 readings on five scene seeds on
# an H100, the Snavely kernel, its plain version and autodiff: 1.2849)
MESH_VENICE_F32_RATIO = 1.4


def phase_mesh_venice(device) -> dict:
    """35: the venice shape at full width over 3 gloo ranks on the card,
    DENSE_SCHUR on the explicit path, 5 LM steps on the host loop, cameras
    0 and 1 constant (``gauged_bal``): in float64 against the unsharded card
    solve step by step, then in float32 (the rates, the collectives, K3 on
    each rank's grid, K2) against the unsharded float32 solve: the start
    and the first step to 1e-3, each later step to 1e-2 while both solves
    have taken the same decisions with no jitter rung, and both final costs
    against the float64 solve's (``MESH_VENICE_F32_RATIO``). A float32 solve
    of this scene parts from itself after the first step on the last bits
    of J and the order of its sums (the jitter rungs they decide): on five
    scene seeds one lands 1.28x above float64 after 5 steps, for the
    Snavely kernel, its plain version and autodiff alike, each on another
    seed."""
    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.types import LinearSolverType

    refs = {}
    for dtype in (torch.float64, torch.float32):
        problem, program = gauged_bal(VENICE)
        one = stt.solve(stt.SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_SCHUR, max_num_iterations=VENICE_STEPS,
            run_full_iteration_budget=True, dtype=dtype, device=device,
            evaluation_chunk_size=VENICE_CHUNK), problem, program)
        refs[dtype] = dict(costs=[it.cost for it in one.iterations],
                           accepted=[it.step_is_successful for it in one.iterations],
                           factors=[it.linear_solver_iterations for it in one.iterations],
                           final_cost=one.final_cost,
                           rate=(len(one.iterations) - 1) / one.minimizer_time_in_seconds)
        del problem, program, one
        if device == "cuda":
            torch.cuda.empty_cache()
    reports = mesh_ranks("venice", MESH_RANKS, device)
    check_ranks_agree("mesh venice", reports, ("costs", "accepted", "factor_digest", "n_straddle",
                                               "costs64", "accepted64"))
    rep = reports[0]
    ref64 = refs[torch.float64]
    a, b = np.array(rep["costs64"]), np.array(ref64["costs"])
    gap64 = float(np.max(np.abs(a - b) / b)) if len(a) == len(b) else math.inf
    print(f"[mesh-venice] float64: costs {rep['costs64']} against the unsharded "
          f"{ref64['costs']}: max relative gap a step {gap64:.3e}; decisions {rep['accepted64']}")
    check(rep["accepted64"] == ref64["accepted"], "mesh venice float64: decisions differ")
    check(gap64 <= 1e-8, f"mesh venice float64: {gap64:.3e} > 1e-8 from the unsharded solve")
    lm = refs[torch.float32]
    # float32 against the unsharded float32 solve: the start and the first
    # step to 1e-3 (J's last bits move the first step's cost by up to 3e-4
    # on this scene); each later step to 1e-2 while both have taken the same
    # decisions with no jitter rung (one factor attempt a step). A rung's
    # regularized step parts the two by up to 15 % on the order of their
    # sums alone (the same rung on both sides, an H100), and the paths part
    first = max(abs(a - b) / b for a, b in zip(rep["costs"][:2], lm["costs"][:2]))
    same = next((k for k, (a, f, a_lm, f_lm) in enumerate(zip(
        rep["accepted"], rep["factors"], lm["accepted"], lm["factors"]))
        if (a, f) != (a_lm, f_lm) or f > 1), len(lm["costs"]))
    held = max((abs(a - b) / b for a, b in zip(rep["costs"][2:same], lm["costs"][2:same])),
               default=0.0)
    # and both solves' final cost against the float64 solve's (15 float32
    # solves of this scene on five scene seeds, sharded none, on an H100:
    # 0.9928x to 1.2849x)
    ratios = [c / refs[torch.float64]["final_cost"] for c in (rep["final_cost"],
                                                               lm["final_cost"])]
    for r in reports:
        c = r["collectives"]
        print(f"[mesh-venice] rank {r['rank']}: rows {r['rows']}, {r['points']} whole points; "
              f"K3 on its grid {r['k3_ms']:.4f} ms (plain {r['k3_plain_ms']:.4f}; ranks in turns "
              f"on one card), err {r['k3_grid_err']:.3e} (rel {r['k3_grid_rel']:.3e}), fixup "
              f"{r.get('k3_fixup_err', 0.0):.3e}; K2 on S ({r['s_rows']} rows) against "
              f"cholesky_ex {r['factor_err']:.3e} (rel {r['factor_rel']:.3e})"
              + (f", backward {r['k2_backward']:.3e}" if "k2_backward" in r else "")
              + f"; a LM step: {c['calls'] / r['lm_steps']:.1f} all_reduces, "
              f"{c['bytes'] / r['lm_steps'] / 2**20:.2f} MiB, {c['ms'] / r['lm_steps']:.2f} ms "
              f"(gloo through the host, timed one by one); {r['rate']:.4f} LM steps/s; launches "
              f"{json.dumps(r['launches'])}; peak {r['peak_gib']:.3f} GiB")
    print(f"[mesh-venice] {MESH_RANKS} gloo ranks on one card (a gloo-on-one-card rate, not a "
          f"multi-GPU one): n_straddle {rep['n_straddle']}, float32 costs {rep['costs']} "
          f"against the unsharded {lm['costs']} (the start and first step within {first:.3e}, "
          f"the {max(same - 2, 0)} later steps before a jitter rung or a parted decision "
          f"within {held:.3e}; "
          f"unsharded host loop {lm['rate']:.4f} LM steps/s); decisions {rep['accepted']} and "
          f"{lm['accepted']}, factor attempts {rep['factors']} and {lm['factors']}; final cost "
          f"{rep['final_cost']!r} and {lm['final_cost']!r}, {ratios[0]:.4f}x and "
          f"{ratios[1]:.4f}x the float64 solve's {refs[torch.float64]['final_cost']!r}")
    c = rep["collectives"]
    print(f"[mesh-venice] camera-padded layout: {rep['layout']}; a LM step on rank 0: "
          f"{c['calls'] / rep['lm_steps']:.2f} all_reduces, "
          f"{c['bytes'] / rep['lm_steps'] / 2**20:.2f} MiB with {sum(rep['accepted'][1:])} of "
          f"{rep['lm_steps']} steps accepted (the generic path, an earlier run on an H100: 12 and "
          f"72.15 MiB with 4 of 5)")
    check(rep["n_straddle"] > 0, "mesh venice: no straddling point")
    check(f"sharded, {MESH_RANKS} shards" in rep["layout"],
          "mesh venice: the sharded camera-padded layout did not engage")
    check(first <= 1e-3, f"mesh venice float32: the start or the first step {first:.3e} > 1e-3 "
          f"from the unsharded")
    check(held <= 1e-2, f"mesh venice float32: a step before any jitter rung {held:.3e} > 1e-2 "
          f"from the unsharded")
    check(all(r <= MESH_VENICE_F32_RATIO for r in ratios), f"mesh venice float32: final costs "
          f"{ratios} x the float64 solve's, past {MESH_VENICE_F32_RATIO}")
    for r in reports:
        check(r["factor"] == "K2" and ("k2_backward" not in r
                                       or r["k2_backward"] <= K2_VENICE_BACKWARD),
              f"mesh venice: K2 on S, rank {r['rank']}")
        check(max(r["k3_grid_rel"], r.get("k3_fixup_rel", 0.0)) <= K3_RTOL[torch.float32],
              f"mesh venice: K3 against its plain version, rank {r['rank']}")
        check(r["launches"]["K3"] == 2 * r["damped_solves"]
              and r["launches"]["K2 update"] > 0, f"mesh venice: K3 or K2, rank {r['rank']}")
    sum_ = lambda key: sum(r["launches"][key] for r in reports)  # noqa: E731
    return {f"venice on {MESH_RANKS} gloo ranks, float32 (K3: grid + fixup)": {
        "K1": sum_("K1"), "K2 update": sum_("K2 update"), "K3": sum_("K3")}}


def phase_mesh_nccl(device) -> dict:
    """36: the device loop under a 1-rank NCCL mesh (the collectives in the
    graph's conditional bodies) against the unsharded device loop, float32:
    BAL-49 30 steps and the venice shape 5 steps, both on the explicit
    path."""
    (rep,) = mesh_ranks("nccl", 1, device)
    out = {}
    for label, runs in rep.items():
        every = [r for v in runs.values() for r in v]
        check(device != "cuda" or all(r["capture"] > 0 for r in every),
              f"NCCL mesh {label}: no graph captured")
        check(all(r["path"] == "explicit" and r["launches"]["K3"] > 0 for r in every),
              f"NCCL mesh {label}: not the explicit path, or K3 not captured")
        for dtype in ("float64", "float32"):
            if f"mesh {dtype}" not in runs:
                continue
            one, mesh = runs[f"one {dtype}"], runs[f"mesh {dtype}"]
            a, b = np.array(mesh[0]["costs"]), np.array(one[0]["costs"])
            check(len(a) == len(b), f"NCCL mesh {label}: step counts differ")
            gap = float(np.max(np.abs(a - b) / b))  # a decision that parts moves the costs
            check(dtype == "float32" or gap <= 1e-10,
                  f"NCCL mesh {label} float64: {gap:.3e} > 1e-10 from the unsharded loop")
            print(f"[mesh-nccl] {label} {dtype}: device loop LM steps/s, one NCCL rank "
                  f"{[round(r['rate'], 4) for r in mesh]} against unsharded "
                  f"{[round(r['rate'], 4) for r in one]} (in turns); capture "
                  f"{[round(r['capture'], 3) for r in mesh]} s against "
                  f"{[round(r['capture'], 3) for r in one]}; max relative cost gap {gap:.3e}; "
                  f"{sum(x == y for x, y in zip(mesh[0]['accepted'], one[0]['accepted']))} of "
                  f"{len(a)} decisions agree; final {a[-1]!r}; launches (captures, not "
                  f"replays) {json.dumps(mesh[0]['launches'])}")
        key = "mesh float32" if "mesh float32" in runs else "mesh float64"
        out[f"{label} device loop, 1 NCCL rank, {key[5:]} (captures)"] = runs[key][0]["launches"]
    return out


# -- the measuring scripts of tools_torch -----------------------------------------------

# phase 38: each script at its default size (bench_scaling at 1, 2 and 4
# shards), with no --device, so on the card; the two lanes run side by side,
# each script of a lane after the other (the numbers of record are taken
# with each script alone)
MEASURING_SCRIPTS = (
    (("bench_two_signature.py", ()),),
    (("bench_sphere.py", ()),
     ("bench_scaling.py", ("--shards", "1", "2", "4"))),
)
SCRIPT_TIMEOUT = 300  # seconds one script may take


def run_script(script: str, flags) -> tuple[dict, list, list, float]:
    """``python3 tools_torch/<script> <flags>`` from the checkout: its last
    line (the JSON result), its ``[<script>] solve`` records, its standard
    output's lines and its wall seconds."""
    t0 = time.time()
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools_torch", script), *flags],
                         capture_output=True, text=True, timeout=SCRIPT_TIMEOUT, cwd=ROOT)
    wall = time.time() - t0
    check(out.returncode == 0, f"{script} {' '.join(flags)}: exit {out.returncode}\n"
          f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    lines = out.stdout.strip().splitlines()
    solves = [json.loads(ln.split(" solve ", 1)[1]) for ln in lines
              if ln.startswith("[bench") and " solve {" in ln]
    return json.loads(lines[-1]), solves, lines, wall


def phase_measuring_scripts() -> dict:
    """38: every measuring script of tools_torch in a subprocess on the card
    (no --device), its last line parsed as JSON: the value finite and
    positive, every timed solve's final cost below its initial cost, the
    card's name in ``extra.device``, and no kernel launched (their paths
    have none). Returns the launches by script."""
    from concurrent.futures import ThreadPoolExecutor

    card = torch.cuda.get_device_name(0)
    with ThreadPoolExecutor(len(MEASURING_SCRIPTS)) as pool:
        lanes = [pool.submit(lambda lane: [(script, flags, run_script(script, flags))
                                           for script, flags in lane], lane)
                 for lane in MEASURING_SCRIPTS]
        runs = [run for lane in lanes for run in lane.result()]
    paths = {}
    for script, flags, (result, solves, lines, wall) in runs:
        label = " ".join((script, *flags))
        value, extra = result["value"], result["extra"]
        check(isinstance(value, (int, float)) and math.isfinite(value) and value > 0,
              f"{label}: value {value!r}")
        check(extra["device"]["name"] == card, f"{label}: device {extra['device']!r}, not {card}")
        check(bool(solves), f"{label}: no solve line")
        for rec in solves:
            check(math.isfinite(rec["final_cost"]) and rec["final_cost"] < rec["initial_cost"],
                  f"{label} {rec['label']}: final cost {rec['final_cost']} not below the initial "
                  f"{rec['initial_cost']}")
        n = {k: sum(rec["launches"][k] for rec in solves) for k in ("K1", "K2 update", "K3")}
        damped = sum(rec["linear_solves"] for rec in solves)
        check(not any(n.values()), f"{label}: launches {n} on a path without a kernel")
        paths[f"tools_torch/{label}"] = n
        for ln in lines[:-1]:  # the scripts' own JSON rows (variants, shard counts)
            if ln.startswith("{"):
                print(f"[scripts] {script}: {ln[:400]}")
        setup = [round(rec["preprocessor_s"], 3) for rec in solves]
        print(f"[scripts] {label}: {result['metric']} {value!r} {result['unit']}; "
              f"extra {json.dumps(extra)[:600]}; set-up (preprocessor, capture included) s "
              f"{setup}; launches {n} over {damped} damped solves; wall {wall:.1f} s")
    return paths


# -- the port's spans and the device loop's stamps (phase 39) ----------------------------


def phase_spans_and_stamps(device) -> dict:
    from torch.profiler import ProfilerActivity, profile

    import skeres_tpu_torch as stt
    from skeres_tpu_torch.core.graph import stamp
    from skeres_tpu_torch.core.types import LinearSolverType
    from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal
    from tools_torch.trace_spans import span_table

    problem, _, _ = build_bal_problem(synthetic_bal(**BAL49))
    options = stt.SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR,
                                dtype=torch.float64, device=device, **BAL49_DEVICE_LOOP)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s = stt.solve(options, problem)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    host = {ev.name() for ev in events if ev.device_type().name == "CPU"
            and ev.name().startswith("skeres.")}
    mirrored = {ev.name() for ev in events if ev.device_type().name == "CUDA"
                and ev.name().startswith("skeres.")}
    want = {"skeres.solve", "skeres.plan.schur", "skeres.plan.w", "skeres.device_loop.capture",
            "skeres.minimize", "skeres.step.linearize", "skeres.device_loop.chunk"}
    check(want <= host, f"spans: {sorted(want - host)} missing from the trace")
    check(not mirrored, f"spans: {sorted(mirrored)} mirrored onto the card")
    steps = s.num_successful_steps + s.num_unsuccessful_steps
    times = [s.linear_solver_time_in_seconds, s.residual_evaluation_time_in_seconds,
             s.jacobian_evaluation_time_in_seconds]
    check(min(times) > 0 and sum(times) <= s.minimizer_time_in_seconds,
          f"stamps: timers {times} against the minimizer's {s.minimizer_time_in_seconds}")
    check(all(0 < it.step_solver_time_in_seconds < it.iteration_time_in_seconds
              for it in s.iterations[1:]), "stamps: an iteration's times out of order")
    cumulative = [it.cumulative_time_in_seconds for it in s.iterations]
    check(all(b > a for a, b in zip(cumulative, cumulative[1:])),
          f"stamps: cumulative times {cumulative} do not increase")
    chunk = BAL49_DEVICE_LOOP["device_loop_chunk_iterations"]
    limits = [min(chunk, options.max_num_iterations - k * chunk)
              for k in range(math.ceil(steps / chunk))]
    check(s.num_device_loop_replays == sum(limits),
          f"stamps: {s.num_device_loop_replays} replays for {steps} steps in chunks of {chunk}")
    # the evaluation timers hold the host's first linearization (its clock,
    # its sync) and the stamped candidate costs and relinearizations
    stamped = sum(it.iteration_time_in_seconds - it.step_solver_time_in_seconds
                  for it in s.iterations[1:])
    table = span_table(events)
    rows = {k: [v["count"], round(v["host_s"] * 1e3, 3), round(v["device_s"] * 1e3, 3)]
            for k, v in table.items()}
    print(f"[trace] evaluation {(times[1] + times[2]) * 1e3:.3f} ms = stamped {stamped * 1e3:.3f} "
          f"ms + the host's first linearization {(times[1] + times[2] - stamped) * 1e3:.3f} ms; "
          f"spans (count, host ms, device ms launched): {json.dumps(rows)}")
    check(table["skeres.device_loop.chunk"]["device_s"] > 0,
          "spans: no device time launched inside the chunks' replays")
    n = 1024
    dst = torch.zeros(n, dtype=torch.int64, device=device)
    index = torch.arange(n, device=device)
    stamp(dst, index[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(n):
            stamp(dst, index[k])
    graph.replay()
    torch.cuda.synchronize()
    steps_ns = dst.diff()
    check(bool((steps_ns >= 0).all()), "stamps: a graph's stamps out of order")
    finest = int(steps_ns[steps_ns > 0].min())
    print(f"[trace] spans {len(host)}, none mirrored; {steps} steps, {s.num_device_loop_replays} "
          f"replays; linear solver {times[0] * 1e3:.3f} ms, residual {times[1] * 1e3:.3f} ms, "
          f"Jacobian {times[2] * 1e3:.3f} ms of the minimizer's "
          f"{s.minimizer_time_in_seconds * 1e3:.3f} ms; stamps in a graph: smallest step "
          f"{finest} ns, median {float(steps_ns.double().median()):.0f} ns")
    return {"finest_stamp_ns": finest}


# -- the implicit S product's kernel pair (phase 40) ------------------------------------

# the camera-padded shapes of the benchmark's ITERATIVE_SCHUR cells: cameras,
# and (points, observations a point) as the BAL files count them
S_SHAPES = {
    "venice-1778": (1778, ((32_331, 6), (961_592, 5))),
    "final-13682": (13_682, ((2_205_175, 6), (2_250_942, 7))),
}
S_RTOL = 1e-12  # float64: each output a sum of a few thousand rows' products


def s_product_inputs(nc: int, point_counts, device, dtype=torch.float64) -> dict:
    """Both passes' inputs at a BAL scene's padded shape, drawn on the card:
    points seen as often as ``point_counts`` says, in random order, rows
    grouped by point, each row's camera uniform over ``nc``; the rows 26
    values wide (2 x 12 and the residual, as the minimizer places them)."""
    from skeres_tpu_torch.core.schur import _cam_padded_src

    gen = torch.Generator(device=device).manual_seed(40)
    per_pt = torch.cat([torch.full((n,), k, dtype=torch.int64, device=device)
                        for n, k in point_counts])
    per_pt = per_pt[torch.randperm(len(per_pt), generator=gen, device=device)]
    n_pts = len(per_pt)
    pt = torch.repeat_interleave(torch.arange(n_pts, device=device), per_pt)
    b = len(pt)
    cam = torch.randint(0, nc, (b,), generator=gen, device=device)
    wide = torch.randn((b + 1, 26), generator=gen, dtype=dtype, device=device)
    wide[b].zero_()  # the row the unused slots read
    counts = torch.bincount(cam, minlength=nc)
    src = _cam_padded_src(cam, nc, int(counts.max()))
    x = dict(rows=wide[:b, :24].contiguous().view(b, 2, 12), cam=cam, counts=counts,
             placed=wide.index_select(0, src)[:, :24].unflatten(1, (2, 12)),
             pidx=torch.cat([pt, pt.new_zeros(1)])[src],
             seg=torch.searchsorted(pt, torch.arange(n_pts + 1, device=device)),
             v=torch.randn(nc * 9, generator=gen, dtype=dtype, device=device),
             cinv=torch.randn((n_pts, 3, 3), generator=gen, dtype=dtype, device=device),
             s_e=0.5 + torch.rand((n_pts, 3), generator=gen, dtype=dtype, device=device),
             s_f=0.5 + torch.rand((nc, 9), generator=gen, dtype=dtype, device=device),
             d=torch.rand((nc, 9), generator=gen, dtype=dtype, device=device))
    x["K"] = int(counts.max())
    return x


def phase_s_product(device) -> dict:
    """Phase 40: the S product's kernel pair at venice's and Final's padded
    shapes against its plain version; times and bounds."""
    import types

    from benchmark.roofline_implicit import s_product_counts
    from skeres_tpu_torch.ops import s_product as sp

    report = {}
    for name, (nc, point_counts) in S_SHAPES.items():
        x = s_product_inputs(nc, point_counts, device)
        rows, placed, v_cam = x["rows"], x["placed"], x["v"].view(nc, 9)
        point_args = (rows, True, x["cam"], v_cam, x["seg"], None, x["cinv"], x["s_e"])
        wc = sp.point_sums(*point_args)

        def camera(wc, sums=sp.camera_sums):  # S v as implicit_s_product adds D_f v
            return x["d"] * v_cam + sums(placed, True, x["pidx"], x["counts"], v_cam, wc,
                                         x["s_f"])

        def kernels():
            return camera(sp.point_sums(*point_args))

        def plain():
            return camera(sp.point_sums_reference(*point_args), sp.camera_sums_reference)

        got, again, ref = kernels(), kernels(), plain()
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        check(torch.equal(got, again), f"S product at {name}: two calls differ")
        check(rel <= S_RTOL, f"S product at {name}: kernels and plain version differ by {rel:.3e}")
        t = [cuda_ms(kernels, calls=1), cuda_ms(plain, calls=1), cuda_ms(plain, calls=1),
             cuda_ms(kernels, calls=1)]
        point_ms = cuda_ms(lambda: sp.point_sums(*point_args), calls=1)
        camera_ms = cuda_ms(lambda: camera(wc), calls=1)
        solver = types.SimpleNamespace(e_batches=[0], sorted_info={0: None},
                                       batch_info=[dict(ret_slots=[(0, 0, 0, 9)])])
        asm = {"per_batch": [(None, rows, rows[:, :, 9:])], "cinv": x["cinv"]}
        counted = s_product_counts(solver, asm, x["v"])
        bound_ms, bound_by = bound(counted["bytes"], counted["flops"], counted["peak"])
        ms = statistics.median([t[0], t[3]])
        print(f"[S product] {name}: {rows.shape[0]} rows, {x['seg'].shape[0] - 1} points, "
              f"{nc} x {x['K']} placed, float64: kernels {t[0]:.4f}/{t[3]:.4f} ms (point pass "
              f"{point_ms:.4f}, camera pass {camera_ms:.4f}), plain {t[1]:.4f}/{t[2]:.4f} ms "
              f"(medians of 20, in turns); bound {bound_ms:.4f} ms ({bound_by}: "
              f"{counted['bytes'] / 1e9:.3f} GB), {100 * bound_ms / ms:.2f} % of it; max|diff| "
              f"{err:.3e} (rel {rel:.3e})")
        report[name] = dict(ms=ms, point_ms=point_ms, camera_ms=camera_ms,
                            plain_ms=statistics.median([t[1], t[2]]), bound_ms=bound_ms,
                            bound_by=bound_by, max_abs_err=err, rel_err=rel,
                            rows=rows.shape[0], K=x["K"])
        del x, rows, placed, wc, got, again, ref
        torch.cuda.empty_cache()
    return report


# -- the camera blocks' kernel (phase 41) ------------------------------------------------

def phase_camera_blocks(device) -> dict:
    """Phase 41: the camera blocks' kernel at venice's and Final's padded
    shapes against its plain version, times and bounds."""
    from skeres_tpu_torch.ops import s_product as sp

    report = {}
    for name, (nc, point_counts) in S_SHAPES.items():
        x = s_product_inputs(nc, point_counts, device)
        cinv = x["cinv"] @ x["cinv"].transpose(1, 2)  # SPD, as C^-1 is
        args = (x["placed"], True, x["pidx"], x["counts"], 9, cinv, x["s_e"])
        got, again = sp.camera_blocks(*args), sp.camera_blocks(*args)
        ref = sp.camera_blocks_reference(*args)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        check(torch.equal(got, again), f"camera blocks at {name}: two calls differ")
        check(torch.equal(got, got.transpose(1, 2)), f"camera blocks at {name}: not symmetric")
        check(rel <= S_RTOL, f"camera blocks at {name}: kernel and plain version differ by "
              f"{rel:.3e}")
        del got, again, ref
        torch.cuda.empty_cache()
        t = [cuda_ms(lambda: sp.camera_blocks(*args), calls=1),
             cuda_ms(lambda: sp.camera_blocks_reference(*args), calls=1),
             cuda_ms(lambda: sp.camera_blocks_reference(*args), calls=1),
             cuda_ms(lambda: sp.camera_blocks(*args), calls=1)]
        rows, n_pts, item = int(x["counts"].sum()), cinv.shape[0], 8
        # read once: the 2 x 12 values and the point of every placed row that
        # holds an observation, the counts, C^-1 and s_e; the blocks written
        nbytes = rows * (24 + 1) * item + nc * item + n_pts * 12 * item + nc * 81 * item
        gathered = nbytes + rows * 12 * item - n_pts * 12 * item  # C^-1, s_e a row
        flop = rows * 2 * (27 + 36 + 90)  # M, M F, F^T (M F): multiply-adds a row
        bound_ms, bound_by = bound(nbytes, flop, 34e12)  # float64 outside the tensor cores
        gathered_ms = bound(gathered, flop, 34e12)[0]
        ms = statistics.median([t[0], t[3]])
        print(f"[camera blocks] {name}: {rows} rows, {n_pts} points, {nc} x {x['K']} placed, "
              f"float64: kernel {t[0]:.4f}/{t[3]:.4f} ms, plain {t[1]:.4f}/{t[2]:.4f} ms "
              f"(medians of 20, in turns); bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes / 1e9:.3f} GB), {100 * bound_ms / ms:.2f} % of it; with each row's C^-1 "
              f"and s_e gathered {gathered_ms:.4f} ms ({gathered / 1e9:.3f} GB), "
              f"{100 * gathered_ms / ms:.2f} %; max|diff| {err:.3e} (rel {rel:.3e})")
        report[name] = dict(ms=ms, plain_ms=statistics.median([t[1], t[2]]), bound_ms=bound_ms,
                            bound_by=bound_by, gathered_bound_ms=gathered_ms, max_abs_err=err,
                            rel_err=rel, rows=rows, K=x["K"])
        del x, cinv, args
        torch.cuda.empty_cache()
    return report


# -- visibility clusters at Final-4585's counts (phase 42) ------------------------------

VISIBILITY_SEED = 2_718_281_828_459


def phase_visibility(device) -> dict:
    """Phase 42: the visibility plan (``core/visibility.py``) of the
    benchmark's Final-4585 site scene and the CLUSTER_TRIDIAGONAL factor and
    chain apply on its clusters, float64 on the card: the plan timed (its
    second run), its clusters, chains and padding; the build and factor
    and the apply timed (CUDA events); the apply against its plain version
    (each chain's block tridiagonal matrix dense, ``torch.linalg.solve``)."""
    from benchmark import harness
    from skeres_tpu_torch.core import schur as schur_mod
    from skeres_tpu_torch.core import visibility as vis
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.linear_solvers import lm_diagonal
    from skeres_tpu_torch.core.types import PreconditionerType, VisibilityClusteringType

    cell = harness.load_cell("final4585.cluster-tridiagonal")
    config = cell["config_data"]
    mod = harness.load_module("scenes", config["generator"])
    scene = mod.generate(config, VISIBILITY_SEED, device)
    nc, npt = config["num_cameras"], config["num_points"]
    cam = torch.as_tensor(scene.camera_index, device=device).long()
    pt = torch.as_tensor(scene.point_index, device=device).long()
    plan_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clusters = vis.plan_visibility(cam, pt, nc, npt, "CANONICAL_VIEWS", chains=True)
        torch.cuda.synchronize()
        plan_s.append(time.perf_counter() - t0)
    about = clusters.describe()
    check(about["chains"] > 1 and about["padded_share"] < 0.5,
          f"visibility plan: {about}")
    problem, _ = mod.build_problem(scene)
    ev = Evaluator(problem.compile(), device=device, chunk_size=1 << 20)
    _, blocks = ev.blocks(ev.program.initial_state(device, torch.float64))
    g, diag = ev.gradient_and_diag(blocks)
    scale = 1.0 / (1.0 + torch.sqrt(diag))
    g, diag = g * scale, diag * scale**2
    solver = schur_mod.SchurSolver(ev, iterative=True,
                                   preconditioner=PreconditionerType.CLUSTER_TRIDIAGONAL,
                                   visibility_clustering=VisibilityClusteringType.CANONICAL_VIEWS)
    check(solver.cluster_layout is not None, "visibility plan: no cluster layout")
    data = solver.prepare(solver.scale_data(solver.solver_data(blocks), scale))
    asm = solver._assemble(data, g, lm_diagonal(diag, 1e-4, 1e-6, 1e32))
    factors = schur_mod.cluster_preconditioner(solver, asm)
    v = torch.randn(solver.num_f, dtype=torch.float64, device=device)
    got = schur_mod.apply_cluster_preconditioner(solver, factors, v)
    plain = schur_mod.dense_cluster_solve(solver, asm, v, factors["band_scale"])
    torch.cuda.synchronize()
    rel = float(torch.linalg.norm(got - plain) / torch.linalg.norm(plain))
    check(rel <= 1e-8, f"visibility apply against its plain version: {rel:.3e}")
    factor_ms = cuda_ms(lambda: schur_mod.cluster_preconditioner(solver, asm), reps=3, calls=1)
    apply_ms = cuda_ms(lambda: schur_mod.apply_cluster_preconditioner(solver, factors, v))
    report = dict(about, plan_s=plan_s, factor_ms=factor_ms, apply_ms=apply_ms, rel_err=rel,
                  band_scale=factors["band_scale"], steps=len(solver.cluster_layout.steps),
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"[visibility] Final-4585 scene: {json.dumps(report)}")
    del solver, asm, data, blocks, factors, ev, problem
    torch.cuda.empty_cache()
    return report


# -- the Snavely residual's kernel (phase 43) ---------------------------------------------

# the benchmark's BAL cells: cameras, points, observations, evaluation chunk
REPROJECTION_SHAPES = {
    "venice-1778": (1778, S_SHAPES["venice-1778"][1], None),
    "final-13682": (13_682, S_SHAPES["final-13682"][1], 1 << 20),
}
REPROJECTION_RTOL = 1e-14  # float64: the same formulas, contracted into FMAs


def reprojection_scene(nc: int, point_counts, device):
    """A BAL problem at these counts, drawn on the card and built as the
    cells build theirs: rotations of scale 0.3, cameras 10 from the points
    along z (so that |x|, |y| < 1 in the image plane, as in BAL), focal
    ~500, k1 and k2 of scale 0.05 and 0.01; points seen as often as
    ``point_counts`` says, rows grouped by point, each row's camera
    uniform; observations ~100 pixels. Returns the kernel's arguments, the
    program, and the same program on ``snavely_by_autodiff``."""
    from skeres_tpu_torch.core.problem import Problem
    from skeres_tpu_torch.models.reprojection import snavely_reprojection_error

    gen = torch.Generator(device=device).manual_seed(43)
    per_pt = torch.cat([torch.full((n,), k, dtype=torch.int64, device=device)
                        for n, k in point_counts])
    per_pt = per_pt[torch.randperm(len(per_pt), generator=gen, device=device)]
    n_pts = len(per_pt)
    pt = torch.repeat_interleave(torch.arange(n_pts, device=device), per_pt)
    cam = torch.randint(0, nc, (len(pt),), generator=gen, device=device)
    cams = torch.randn((nc, 9), generator=gen, dtype=torch.float64, device=device)
    cams[:, 0:3] *= 0.3
    cams[:, 3:6] *= 0.5
    cams[:, 5] = -10.0
    cams[:, 6] = 500.0 + 100.0 * torch.rand(nc, generator=gen, dtype=torch.float64,
                                            device=device)
    cams[:, 7] *= 0.05
    cams[:, 8] *= 0.01
    points = torch.randn((n_pts, 3), generator=gen, dtype=torch.float64, device=device)
    obs = 100.0 * torch.randn((len(pt), 2), generator=gen, dtype=torch.float64, device=device)
    programs = []
    for fn in (snavely_reprojection_error, snavely_by_autodiff):
        problem = Problem()
        cam_arr = problem.add_parameter_block_array(cams.cpu().numpy())
        pt_arr = problem.add_parameter_block_array(points.cpu().numpy())
        problem.add_residual_blocks(fn, None,
                                    [(cam_arr, cam.cpu().numpy()), (pt_arr, pt.cpu().numpy())],
                                    data=obs.cpu().numpy())
        programs.append(problem.compile())
    return (cams, points, cam, pt, obs), *programs


def snavely_by_autodiff(params, observation):
    """``snavely_reprojection_error`` without its batched form: the
    evaluator maps and differentiates it with ``torch.func``."""
    from skeres_tpu_torch.models.reprojection import snavely_reprojection_error

    return snavely_reprojection_error(params, observation)


def phase_reprojection(device) -> dict:
    """Phase 43: the Snavely residual's kernel at venice's and Final's
    counts against its plain version, times and bounds; the evaluator
    through it and through the vmapped autodiff it replaced."""
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.ops import reprojection as rp

    report = {}
    for name, (nc, point_counts, chunk) in REPROJECTION_SHAPES.items():
        args, program, autodiff_program = reprojection_scene(nc, point_counts, device)
        rows, n_pts, obs = args[2].shape[0], args[1].shape[0], args[4]
        (r, jac), (r2, jac2) = rp.snavely_rows(*args), rp.snavely_rows(*args)
        cost, cost2 = rp.snavely_costs(*args), rp.snavely_costs(*args)
        r_ref, jac_ref = rp.snavely_rows_reference(*args)
        cost_ref = rp.snavely_costs_reference(*args)
        torch.cuda.synchronize()
        terms = (r_ref.abs() + obs.abs()).amax(1)
        err = {"r": float(((r - r_ref).abs().amax(1) / terms).max()),
               "J": float(((jac - jac_ref).abs().amax((1, 2))
                           / jac_ref.abs().amax((1, 2))).max()),
               "cost": float(((cost - cost_ref).abs() / (terms * terms)).max())}
        check(torch.equal(r, r2) and torch.equal(jac, jac2) and torch.equal(cost, cost2),
              f"reprojection at {name}: two calls differ")
        check(max(err.values()) <= REPROJECTION_RTOL,
              f"reprojection at {name}: kernel and plain version differ by {err}")
        del r2, jac2, cost2, r_ref, jac_ref, cost_ref, terms
        torch.cuda.empty_cache()
        t = [cuda_ms(lambda: rp.snavely_rows(*args, r, jac), calls=1),
             cuda_ms(lambda: rp.snavely_rows_reference(*args), calls=1),
             cuda_ms(lambda: rp.snavely_rows_reference(*args), calls=1),
             cuda_ms(lambda: rp.snavely_rows(*args, r, jac), calls=1)]
        c = [cuda_ms(lambda: rp.snavely_costs(*args), calls=1) for _ in range(2)]
        del r, jac, cost
        torch.cuda.empty_cache()
        # read once: a row's observation and two int64 indices, the camera
        # and point tables; written once: r and J (the costs: one value a row)
        tables = (nc * 9 + n_pts * 3) * 8
        nbytes = rows * (2 * 8 + 16 + 26 * 8) + tables
        cost_bytes = rows * (2 * 8 + 16 + 8) + tables
        bound_ms, bound_by = bound(nbytes, 400 * rows, 34e12)  # float64 outside the tensor cores
        cost_bound_ms = bound(cost_bytes, 80 * rows, 34e12)[0]
        ms, cost_ms = statistics.median([t[0], t[3]]), statistics.median(c)

        # the evaluator at the cell's chunking, through the kernel and
        # through the vmapped autodiff (the same residual without its
        # batched form; the same state serves both programs)
        ev = Evaluator(program, device=device, chunk_size=chunk)
        auto = Evaluator(autodiff_program, device=device, chunk_size=chunk)
        state = program.initial_state(device, torch.float64)
        chunks = 1 if chunk is None else -(-rows // chunk)
        check(ev.takes_batched_form(0) and not auto.takes_batched_form(0),
              f"reprojection at {name}: the evaluators did not take their paths")
        before = (rp.snavely_rows.launches, rp.snavely_costs.launches)
        _, (fused,) = ev.blocks(state)
        ev.cost(state)
        grown = (rp.snavely_rows.launches - before[0], rp.snavely_costs.launches - before[1])
        check(grown == (chunks, chunks) and ev.num_evaluation_chunks == chunks,
              f"reprojection at {name}: {grown} launches for {chunks} chunks")
        before = (rp.snavely_rows.launches, rp.snavely_costs.launches)
        _, (generic,) = auto.blocks(state)
        auto.cost(state)
        torch.cuda.synchronize()
        check((rp.snavely_rows.launches, rp.snavely_costs.launches) == before,
              f"reprojection at {name}: the autodiff evaluator launched the kernel")
        jac_gap = float((fused.jac - generic.jac).abs().max() / generic.jac.abs().max())
        check(jac_gap <= 1e-10, f"reprojection at {name}: the evaluator's two Jacobians "
              f"differ by {jac_gap:.3e}")
        del fused, generic
        torch.cuda.empty_cache()
        e = [cuda_ms(lambda: ev.blocks(state), reps=10, calls=1),
             cuda_ms(lambda: auto.blocks(state), reps=10, calls=1),
             cuda_ms(lambda: auto.blocks(state), reps=10, calls=1),
             cuda_ms(lambda: ev.blocks(state), reps=10, calls=1)]
        ec = [cuda_ms(lambda: ev.cost(state), reps=10, calls=1),
              cuda_ms(lambda: auto.cost(state), reps=10, calls=1),
              cuda_ms(lambda: auto.cost(state), reps=10, calls=1),
              cuda_ms(lambda: ev.cost(state), reps=10, calls=1)]
        print(f"[reprojection] {name}: {rows} rows, {nc} cameras, {n_pts} points, float64: "
              f"kernel {t[0]:.4f}/{t[3]:.4f} ms, plain {t[1]:.4f}/{t[2]:.4f} ms (medians of 20, "
              f"in turns); bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e9:.3f} GB), "
              f"{100 * bound_ms / ms:.2f} % of it; residual-only {c[0]:.4f}/{c[1]:.4f} ms, bound "
              f"{cost_bound_ms:.4f} ms ({cost_bytes / 1e9:.3f} GB), "
              f"{100 * cost_bound_ms / cost_ms:.2f} %; max err {json.dumps(err)}")
        print(f"[reprojection] {name}: the evaluator in {chunks} chunk(s): linearization "
              f"kernel {e[0]:.3f}/{e[3]:.3f} ms, vmapped autodiff {e[1]:.3f}/{e[2]:.3f} ms; cost "
              f"kernel {ec[0]:.3f}/{ec[3]:.3f} ms, autodiff {ec[1]:.3f}/{ec[2]:.3f} ms (medians "
              f"of 10, in turns); Jacobians within {jac_gap:.3e} of max|J|")
        report[name] = dict(ms=ms, plain_ms=statistics.median([t[1], t[2]]), bound_ms=bound_ms,
                            bound_by=bound_by, cost_ms=cost_ms, cost_bound_ms=cost_bound_ms,
                            max_err=err, rows=rows, chunks=chunks,
                            linearize_ms=statistics.median([e[0], e[3]]),
                            autodiff_linearize_ms=statistics.median([e[1], e[2]]),
                            cost_eval_ms=statistics.median([ec[0], ec[3]]),
                            autodiff_cost_ms=statistics.median([ec[1], ec[2]]))
        del args, program, autodiff_program, ev, auto, state, obs
        torch.cuda.empty_cache()
    return report


def bound(nbytes: float, flop: float, flops_per_s: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flop / flops_per_s
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main() -> int:
    if sys.argv[1:] == ["--traced-bal49"]:
        print(json.dumps(traced_bal49()))
        return 0
    if sys.argv[1:] == ["--scoreboards-cpu"]:
        torch.set_num_threads(1)
        print(json.dumps(scoreboards("cpu")))
        return 0
    if sys.argv[1:2] == ["--mesh-rank"]:
        rank, world, store, case, device = sys.argv[2:7]
        mesh_rank_main(int(rank), int(world), store, case, device)
        return 0
    t_start = time.time()
    phase_device()
    cpu_scoreboards = start_cpu_scoreboards()
    try:
        return run_phases(t_start, cpu_scoreboards)
    finally:
        if cpu_scoreboards.poll() is None:
            cpu_scoreboards.kill()
            cpu_scoreboards.communicate()


def run_phases(t_start: float, cpu_scoreboards: subprocess.Popen) -> int:
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
    problem, program, cams = timed("venice scene", venice_scene)
    venice = timed("venice", phase_venice, device, program)
    initial = [g.values.copy() for g in program.groups]
    up_launches, k3_launches, lm_host = timed(
        "venice solve", phase_venice_solve, device, problem, program)
    # phase 16 before any other graph: its traced solve must be this
    # process's first CUDA graph (see the note above trace_launches)
    lm_device = timed("device loop venice", phase_venice_device_loop, device, problem, program,
                      initial, lm_host["rate"])
    venice_paths = timed("venice iterative", phase_venice_iterative, device, problem, program,
                            initial, lm_host["cost"])
    tr_paths = {
        **timed("venice dogleg", phase_venice_dogleg, device, problem, program, initial, lm_host),
        **timed("venice inner iterations", phase_venice_inner, device, problem, program, initial,
                lm_host, lm_device),
    }
    api = timed("venice Problem API", phase_venice_problem_api, device, problem, program, cams,
                initial, lm_host)
    tr_paths.update(api["launches"])
    k3_f6 = api["k3"]
    torch.cuda.empty_cache()
    big_paths = {**venice_paths, **timed("past cap", phase_past_cap, device)}
    torch.cuda.empty_cache()
    # phase 30 while the venice scene's host data lives
    general_paths = timed("split venice", phase_split_venice, device, program, initial)
    torch.cuda.empty_cache()
    # phase 37 while the venice scene's host data lives, after phase 16's graph
    general_paths.update(timed("venice layout", phase_venice_layout, device, problem, program,
                               cams, initial))
    torch.cuda.empty_cache()
    k1_ms, k1_plain = timed("timing", phase_timing, device)
    timed("device loop card vs CPU", phase_device_loop_card_vs_cpu, device)
    timed("device loop explicit", phase_device_loop_explicit, device)
    timed("device loop BAL-49", phase_device_loop_bal49, device)
    solver_paths = timed("solvers card vs CPU", phase_solvers_card_vs_cpu, device)
    solver_paths.update(timed("trust region card vs CPU", phase_trust_region_card_vs_cpu, device))
    # phases 24-27: the venice scene (host data) lived on for 25 and 26
    new_paths = timed("pose graph", phase_pose_graph, device)
    new_paths.update(timed("venice line search", phase_venice_line_search, device, problem,
                           program, initial, lm_host))
    cov = timed("venice covariance", phase_venice_covariance, device, problem, program, cams,
                api["solved"])
    del problem, program, initial, cams, api
    new_paths.update(timed("covariance", phase_covariance, device))
    new_paths.update(timed("scoreboards", phase_scoreboards, device, cpu_scoreboards))
    # phases 28, 29, 31 and 32: the general Schur structure, the CLIs and the examples
    general_paths.update(timed("split BAL-49", phase_split_bal49, device))
    general_paths.update(timed("dubrovnik", phase_dubrovnik, device))
    general_paths.update(timed("general card vs CPU", phase_general_card_vs_cpu, device))
    general_paths.update(timed("tools", phase_tools, device))
    # phases 33-36: DENSE_QR under the device loop, the obs mesh
    mesh_paths = timed("DENSE_QR device loop", phase_dense_qr_device_loop, device)
    torch.cuda.empty_cache()
    mesh_paths.update(timed("mesh BAL-49", phase_mesh_bal49, device))
    mesh_paths.update(timed("mesh venice", phase_mesh_venice, device))
    mesh_paths.update(timed("mesh NCCL device loop", phase_mesh_nccl, device))
    torch.cuda.empty_cache()
    script_paths = timed("measuring scripts", phase_measuring_scripts)
    timed("spans and stamps", phase_spans_and_stamps, device)
    s_report = timed("S product", phase_s_product, device)
    blocks_report = timed("camera blocks", phase_camera_blocks, device)
    timed("visibility", phase_visibility, device)
    reprojection_report = timed("reprojection", phase_reprojection, device)
    # the pair's launches on the main path: phase 37's padded float64
    # ITERATIVE_SCHUR solve, one launch of each kernel a product
    n = general_paths["venice layout float64 ITERATIVE_SCHUR padded"]
    s_launches = {"point": n["S point"], "camera": n["S camera"]}
    # the Snavely kernel's on the same solve: one launch a chunk of each
    # linearization (rows) and of each cost evaluation (costs)
    snavely_launches = {"rows": n["Snavely rows"], "costs": n["Snavely costs"],
                        "linearization_chunks": n["linearization chunks"],
                        "cost_chunks": n["cost chunks"]}
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
                (k if k.startswith("synthetic") else f"synthetic_bal(16, 500, 4) {k}"): v["K1"]
                for k, v in solver_paths.items()}, **{
                f"{k} (panels inside K2)": v["K1"] for k, v in tr_paths.items()},
                **{k: v["K1"] for k, v in {**new_paths, **cov["launches"]}.items()},
                **{k: v["K1"] for k, v in {**general_paths, **mesh_paths,
                                            **script_paths}.items()}},
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
                                 **{k: v["K2 update"] for k, v in big_paths.items()},
                                 **{k: v["K2 update"] for k, v in tr_paths.items()},
                                 **{k: v["K2 update"] for k, v in
                                    {**new_paths, **cov["launches"], **general_paths,
                                     **mesh_paths, **script_paths}.items()}},
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
                                 **{k: v["K3"] for k, v in big_paths.items()},
                                 **{k: v["K3"] for k, v in tr_paths.items()}, **{
                (k if k.startswith("synthetic") else f"synthetic_bal(16, 500, 4) {k}"): v["K3"]
                for k, v in solver_paths.items()},
                **{k: v["K3"] for k, v in {**new_paths, **cov["launches"], **general_paths,
                                            **mesh_paths, **script_paths}.items()}},
            "max_abs_err": k3_err,
            "ms": k3_ms,
            "cluster_plan_ms": venice["k3_cluster_ms"],
            "f6_e3": {"max_abs_err": k3_f6["err"], "ms": k3_f6["ms"],
                      "plain_ms": k3_f6["plain_ms"],
                      "bound_ms": bound(k3_f6["moved"], k3_f6["flop"], 67e12)[0],
                      "float64_max_abs_err": cov["k3_f64_err"]},
            "plain_ms": k3_plain,
            "bound_ms": k3_bound[0],
            "bound_by": k3_bound[1],
            "library_ms": None,
        },
        {
            "name": "point_sums, camera_sums (the implicit S product's pair)",
            "route": "cuda",
            "source": "skeres_tpu_torch/csrc/s_product.cu",
            "replaces": None,
            "launches": s_launches,
            "launches_by_path": {k: {"point": v["S point"], "camera": v["S camera"]} for k, v in {
                **big_paths, **tr_paths, **solver_paths, **new_paths, **cov["launches"],
                **general_paths, **mesh_paths, **script_paths}.items() if "S point" in v},
            "by_shape": s_report,
            "library_ms": None,
        },
        {
            "name": "camera_blocks (the camera blocks of S)",
            "route": "cuda",
            "source": "skeres_tpu_torch/csrc/s_product.cu",
            "replaces": None,
            "launches": n["S blocks"],
            "launches_by_path": {k: v["S blocks"] for k, v in {
                **big_paths, **tr_paths, **solver_paths, **new_paths, **cov["launches"],
                **general_paths, **mesh_paths, **script_paths}.items() if "S blocks" in v},
            "by_shape": blocks_report,
            "library_ms": None,
        },
        {
            "name": "snavely_rows, snavely_costs (the Snavely residual and its Jacobian)",
            "route": "cuda",
            "source": "skeres_tpu_torch/csrc/reprojection.cu",
            "replaces": None,
            "launches": snavely_launches,
            "launches_by_path": {k: {"rows": v["Snavely rows"], "costs": v["Snavely costs"]}
                                 for k, v in {**big_paths, **tr_paths, **solver_paths,
                                              **new_paths, **cov["launches"], **general_paths,
                                              **mesh_paths, **script_paths}.items()
                                 if "Snavely rows" in v},
            "by_shape": reprojection_report,
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
