"""The port's CUDA kernels on a card: each kernel against its plain
PyTorch version, and a small solve on the card against the same solve on
the CPU. Every case carries the ``gpu`` marker and skips without a CUDA
card. The file imports no jax, so that it also runs on a machine with a
card and no jax:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(``--noconftest`` because ``tests/conftest.py`` configures jax).
"""

import numpy as np
import pytest
import torch

import skeres_tpu_torch as stt
from skeres_tpu_torch.core.types import LinearSolverType
from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal
from skeres_tpu_torch.ops import cholesky as k1
from skeres_tpu_torch.ops import pair_product as k3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _spd(n):
    rng = np.random.default_rng(n)
    m = rng.standard_normal((n, n))
    return m @ m.T + n * np.eye(n)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_k1_matches_plain_version_on_card(cuda, dtype, tol):
    """Max-abs error of L and L^-1 within ``tol`` of max|reference|: float32
    rounding over n-term sums at n <= 1024, and float64's. The sizes cover
    one step, a ragged last step on either side of 32, K2's panel and the
    largest n."""
    ns = (1, 31, 32, 33, 256, 441, 1024)
    before = k1.cholesky_both.launches
    for n in ns:
        a = torch.tensor(_spd(n), dtype=dtype, device=cuda)
        l, linv = k1.cholesky_both(a)
        l_ref, linv_ref = k1.cholesky_both_reference(a)
        torch.cuda.synchronize()
        for x, ref in ((l, l_ref), (linv, linv_ref)):
            assert float((x - ref).abs().max()) <= tol * float(ref.abs().max())
    assert k1.cholesky_both.launches == before + len(ns)
    bad = -torch.eye(8, dtype=dtype, device=cuda)
    l, linv = k1.cholesky_both(bad)
    assert torch.isnan(l).all() and torch.isnan(linv).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("at", [0, 3, 438, 440])
def test_k1_failed_pivot_gives_all_nan_on_card(cuda, dtype, at):
    """A pivot that fails in the first or the last diagonal block (n = 441:
    the last block is ragged) makes every output element NaN."""
    a = torch.tensor(_spd(441), dtype=dtype, device=cuda)
    a[at, at] = -1.0
    l, linv = k1.cholesky_both(a)
    torch.cuda.synchronize()
    assert torch.isnan(l).all() and torch.isnan(linv).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 257, 3000])
def test_trailing_update_matches_plain_version_on_card(cuda, dtype, m):
    """The update kernel and its plain version on a strided view (row
    stride m + 5), at a panel width of K2 and ragged ones: each within
    (w + 8) eps (|C| + |P| |P|^T) of float64 elementwise (a w-term sum, and
    the 3xTF32 split's dropped lo.lo terms in float32); the strict upper
    triangle and all outside the view untouched; one launch a call. w = 37
    takes the wrapper's zero-padded copy of P."""
    for w in (256, 36, 37):
        rng = np.random.default_rng(m + w)
        big = torch.tensor(rng.standard_normal((m + 3, m + 5)), dtype=dtype, device=cuda)
        p = torch.tensor(rng.standard_normal((m, w)), dtype=dtype, device=cuda)
        before = big.clone()
        c0, p64 = before[3:, 5:].double(), p.double()
        want = c0 - p64 @ p64.T
        bound = (w + 8) * torch.finfo(dtype).eps * (c0.abs() + p64.abs() @ p64.abs().T)
        launches = k1.trailing_update_.launches
        k1.trailing_update_(big[3:, 5:], p)
        assert k1.trailing_update_.launches == launches + 1
        plain = before[3:, 5:].clone()
        k1.trailing_update_reference_(plain, p)
        torch.cuda.synchronize()
        lower = torch.tril(torch.ones(m, m, dtype=torch.bool, device=cuda))
        for got in (big[3:, 5:], plain):
            assert bool(((got.double() - want).abs() <= bound)[lower].all())
        assert torch.equal(big[3:, 5:][~lower], before[3:, 5:][~lower])
        outside = torch.ones_like(big, dtype=torch.bool)
        outside[3:, 5:] = False
        assert torch.equal(big[outside], before[outside])


@pytest.mark.gpu
def test_solve_on_card_matches_cpu(cuda):
    """A float64 DENSE_SCHUR solve on the card (K1) and on the CPU (plain
    versions): the same steps and costs to rtol 1e-8."""
    bal = synthetic_bal(6, 60, 4)
    before = k1.cholesky_both.launches
    runs = []
    for device in (cuda, "cpu"):
        problem, _, _ = build_bal_problem(bal)
        runs.append(stt.solve(stt.SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_SCHUR, max_num_iterations=5,
            run_full_iteration_budget=True, initial_trust_region_radius=1.0,
            dtype=torch.float64, device=device,
        ), problem))
    card, cpu = runs
    assert k1.cholesky_both.launches >= before + card.num_linear_solves > before
    assert [it.step_is_successful for it in card.iterations] == [
        it.step_is_successful for it in cpu.iterations]
    np.testing.assert_allclose([it.cost for it in card.iterations],
                               [it.cost for it in cpu.iterations], rtol=1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_k2_matches_plain_version_on_card(cuda, dtype, tol):
    """K2 (K1 panels + the trailing-update kernel) against cuSOLVER's
    factor: L and a solve within ``tol`` of max|reference|, a short last
    panel included; a failed panel makes the solve non-finite."""
    n, panel = 1100, 256
    a = torch.tensor(_spd(n), dtype=dtype, device=cuda)
    before, updates = k1.cholesky_both.launches, k1.trailing_update_.launches
    fac = k1.blocked_cholesky_factor(a, panel=panel)
    assert k1.cholesky_both.launches == before + 5  # one K1 launch a panel
    assert k1.trailing_update_.launches == updates + 4  # one a panel but the last
    l_ref = k1.blocked_cholesky_factor_reference(a)
    b = torch.ones(n, dtype=dtype, device=cuda)
    x = k1.blocked_chol_solve(fac, b)
    x_ref = torch.cholesky_solve(b[:, None], l_ref)[:, 0]
    torch.cuda.synchronize()
    for got, ref in ((fac.l, l_ref), (x, x_ref)):
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
    a[700, 700] = -1.0
    assert not torch.isfinite(k1.blocked_chol_solve(k1.blocked_cholesky_factor(a, panel), b)).any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("f,e,kp", [(9, 3, 5), (6, 3, 5), (5, 3, 6)])
def test_k3_matches_plain_version_on_card(cuda, dtype, tol, f, e, kp):
    """K3 against its plain version on random inputs, every row within
    ``tol`` of max|reference|; an unsupported (f, e) raises."""
    rng = np.random.default_rng(kp)
    p = 1000
    iu, ju = np.triu_indices(kp, k=1)
    args = [
        torch.tensor(rng.standard_normal((p, kp * f * e)), dtype=dtype, device=cuda),
        torch.tensor(rng.standard_normal((p, e * e)), dtype=dtype, device=cuda),
        torch.tensor(rng.random((p, len(iu))) < 0.5, device=cuda),
        torch.tensor(rng.random((p, len(iu))) < 0.8, device=cuda),
        torch.tensor(np.stack([iu, ju]).astype(np.int32), device=cuda),
    ]
    before = k3.pair_products.launches
    got = k3.pair_products(*args, f, e)
    ref = k3.pair_products_reference(*args, f, e)
    torch.cuda.synchronize()
    assert k3.pair_products.launches == before + 1
    assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
    # the same grid read as (f, e) = (e, f): consistent shapes, no instance
    cinv_t = torch.zeros((p, f * f), dtype=dtype, device=cuda)
    with pytest.raises(ValueError, match="instantiated"):
        k3.pair_products(args[0], cinv_t, *args[2:], e, f)


# -- the device loop: CUDA graphs with conditional IF nodes ------------------------


def _schur_on(device):
    """A float64 SchurSolver on the card and the minimizer's scaled first
    linearization of synthetic_bal(6, 60, 4) (S: 54 rows, K1)."""
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.schur import SchurSolver

    ev = Evaluator(build_bal_problem(synthetic_bal(6, 60, 4))[0].compile(), device=device)
    _, blocks = ev.blocks(ev.program.initial_state(device, torch.float64))
    g, diag = ev.gradient_and_diag(blocks)
    schur = SchurSolver(ev)
    scale = 1.0 / (1.0 + torch.sqrt(diag))
    data = schur.prepare(schur.scale_data(schur.solver_data(blocks), scale))
    return schur, data, g * scale, diag * scale * scale


def _indefinite_s(n, shift, seed=0):
    """A symmetric matrix whose equilibrated form has its least eigenvalue
    at ``shift`` (< 0: the factor fails until the jitter passes -shift)."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    s = m @ m.T / n + np.eye(n)
    d = np.sqrt(np.diag(s))
    e = s / d[:, None] / d[None, :]  # unit diagonal
    # e - c I equilibrates to (e - c I) / (1 - c): least eigenvalue shift
    c = (np.linalg.eigvalsh(e)[0] - shift) / (1.0 - shift)
    return (e - c * np.eye(n)) * d[:, None] * d[None, :]


@pytest.mark.gpu
@pytest.mark.parametrize("shift,want_iters,want_jitter", [(-5e-4, 2, 1e-3), (-0.5, 32, 0.1)])
def test_captured_damped_solve_equals_eager_on_card(cuda, shift, want_iters, want_jitter):
    """solve_damped captured as a CUDA graph (its ladder and PCG fallback
    as IF nodes) and replayed, on an S that K1 cannot factor at delta = 0
    but can at 1e-3 (the first rung, inside the graph), and on one that
    fails every rung (the PCG inside the graph): the iteration count and
    the jitter equal the eager solve's, and dx to rtol 1e-9 (the rhs sums
    camera rows with atomics, in another order on every run; the crafted
    S has a condition number of ~1e4)."""
    from skeres_tpu_torch.core.graph import CapturedStep

    schur, data, g, diag = _schur_on(cuda)
    s_np = _indefinite_s(schur.num_f, shift)
    s_bad = torch.tensor(s_np, dtype=torch.float64, device=cuda)
    schur._dense_s = lambda asm: s_bad.clone()
    mu = torch.tensor(1e-4, dtype=torch.float64, device=cuda)
    jitter0 = torch.zeros((), dtype=torch.float64, device=cuda)
    out = (torch.empty_like(g), torch.zeros((), dtype=torch.int64, device=cuda),
           torch.zeros((), dtype=torch.float64, device=cuda))

    def step():
        for buf, val in zip(out, schur.solve_damped(data, g, diag, mu, 1e-6, 1e32, jitter0)):
            buf.copy_(val)

    captured = CapturedStep(step, cuda)
    captured.capture()
    assert captured.graph is not None
    for buf in out:
        buf.zero_()
    captured()
    eager = schur.solve_damped(data, g, diag, mu, 1e-6, 1e32, jitter0)
    torch.cuda.synchronize()
    captured.release()
    assert int(out[1]) == int(eager[1]) == want_iters
    assert float(out[2]) == float(eager[2]) == pytest.approx(want_jitter, rel=1e-12)
    assert torch.isfinite(out[0]).all()
    torch.testing.assert_close(out[0], eager[0], rtol=1e-9, atol=1e-12)


@pytest.mark.gpu
def test_device_loop_on_card_matches_cpu(cuda):
    """synthetic_bal(16, 500, 4), float64, 10 steps in chunks of 4 at
    initial radius 1: the device loop's replayed CUDA graphs on the card
    take the CPU's decisions, costs to rtol 1e-8."""
    runs = []
    for device in (cuda, "cpu"):
        problem, cams, _ = build_bal_problem(synthetic_bal(16, 500, 4))
        s = stt.solve(stt.SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_SCHUR, max_num_iterations=10,
            run_full_iteration_budget=True, initial_trust_region_radius=1.0,
            use_device_loop=True, device_loop_chunk_iterations=4,
            dtype=torch.float64, device=device,
        ), problem)
        runs.append((s, cams.values.copy()))
    (card, card_cams), (cpu, cpu_cams) = runs
    assert card.device_loop_capture_time_in_seconds > 0.0
    assert len(card.iterations) == len(cpu.iterations) == 11
    assert [it.step_is_successful for it in card.iterations] == [
        it.step_is_successful for it in cpu.iterations]
    np.testing.assert_allclose([it.cost for it in card.iterations],
                               [it.cost for it in cpu.iterations], rtol=1e-8)
    np.testing.assert_allclose(card_cams, cpu_cams, rtol=1e-6, atol=1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("turns", [0, 1, 7])
def test_captured_while_node_equals_eager_loop_on_card(cuda, turns):
    """``while_loop`` captured as a conditional WHILE node and replayed,
    against the eager Python loop on the same carry: the number of turns
    is data (``limit``, set after the capture), the body holds a matrix
    product and a nested ``cond``, and each replay runs as many turns as
    its data ask for; a graph that never enters its body leaves the carry
    as it was."""
    from skeres_tpu_torch.core.graph import CapturedStep, cond, while_loop

    a = torch.tensor(np.random.default_rng(0).standard_normal((8, 8)) / 4.0, device=cuda)
    x = torch.ones(8, dtype=torch.float64, device=cuda)
    k = torch.zeros((), dtype=torch.int64, device=cuda)
    odd = torch.zeros((), dtype=torch.int64, device=cuda)
    limit = torch.full((), 3, dtype=torch.int64, device=cuda)

    def body():
        x.copy_(a @ x + 1.0)
        k.add_(1)
        cond(k % 2 == 1, lambda: odd.add_(1))

    def step():
        while_loop(lambda: k < limit, body)

    captured = CapturedStep(step, cuda)
    captured.capture()
    assert captured.graph is not None
    results = []
    for run in (captured, step):  # the replayed graph, then the eager loop
        x.fill_(1.0)
        k.zero_()
        odd.zero_()
        limit.fill_(turns)
        run()
        torch.cuda.synchronize()
        results.append((x.clone(), int(k), int(odd)))
    captured.release()
    (gx, gk, godd), (ex, ek, eodd) = results
    assert gk == ek == turns and godd == eodd == (turns + 1) // 2
    torch.testing.assert_close(gx, ex, rtol=1e-12, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "solver,precond,kw,rtol",
    [
        ("ITERATIVE_SCHUR", "SCHUR_JACOBI", {}, 1e-8),
        ("ITERATIVE_SCHUR", "POWER_SERIES_EXPANSION", {}, 1e-8),
        ("ITERATIVE_SCHUR", "CLUSTER_JACOBI", dict(cluster_jacobi_size=4), 1e-8),
        ("ITERATIVE_SCHUR", "SCHUR_JACOBI", dict(use_explicit_schur_complement=True), 1e-8),
        # CGNR: PCG on the whole problem's normal equations, whose condition
        # number amplifies rounding: card and CPU costs drift to 1e-5..3e-5 and
        # a residual test may fall one PCG step apart (seen: 49 against 50)
        ("CGNR", "JACOBI", {}, 1e-3),
    ],
)
def test_iterative_device_loop_on_card_matches_cpu(cuda, solver, precond, kw, rtol):
    """The iterative solvers under the device loop on the card (each LM
    step one replayed CUDA graph whose PCG is a WHILE node) against the
    CPU: the same decisions, costs to ``rtol``, and for the Schur solvers
    the same PCG step counts."""
    from skeres_tpu_torch.core.types import PreconditionerType

    runs = []
    for device in (cuda, "cpu"):
        problem, _, _ = build_bal_problem(synthetic_bal(16, 500, 4))
        runs.append(stt.solve(stt.SolverOptions(
            linear_solver_type=LinearSolverType[solver],
            preconditioner_type=PreconditionerType[precond], max_num_iterations=8,
            run_full_iteration_budget=True, initial_trust_region_radius=1.0,
            use_device_loop=True, device_loop_chunk_iterations=4,
            dtype=torch.float64, device=device, **kw,
        ), problem))
    card, cpu = runs
    assert card.device_loop_capture_time_in_seconds > 0.0
    assert [it.step_is_successful for it in card.iterations] == [
        it.step_is_successful for it in cpu.iterations]
    counts = [[it.linear_solver_iterations for it in s.iterations] for s in (card, cpu)]
    if solver == "CGNR":
        assert max(abs(a - b) for a, b in zip(*counts)) <= 2
    else:
        assert counts[0] == counts[1]
    assert max(counts[0]) > 1
    np.testing.assert_allclose([it.cost for it in card.iterations],
                               [it.cost for it in cpu.iterations], rtol=rtol)


@pytest.mark.gpu
def test_dense_solvers_under_the_device_loop_on_card(cuda):
    """DENSE_NORMAL_CHOLESKY captures (its factor and triangular solves are
    library calls that a conditional body takes) and equals the CPU;
    DENSE_QR captures too (its step by the corrected seminormal equations:
    ``torch.linalg.qr`` cannot be captured in a conditional node) and
    equals the CPU's device loop and the card's host loop (Householder QR)."""
    def solve(solver, device, device_loop=True):
        problem, _, _ = build_bal_problem(synthetic_bal(16, 500, 4))
        return stt.solve(stt.SolverOptions(
            linear_solver_type=LinearSolverType[solver], max_num_iterations=8,
            run_full_iteration_budget=True, initial_trust_region_radius=1.0,
            use_device_loop=device_loop, device_loop_chunk_iterations=4, dtype=torch.float64,
            device=device), problem)

    for solver in ("DENSE_NORMAL_CHOLESKY", "DENSE_QR"):
        card, cpu = solve(solver, cuda), solve(solver, "cpu")
        assert card.device_loop_capture_time_in_seconds > 0.0
        runs = [cpu] + ([solve(solver, cuda, device_loop=False)] if solver == "DENSE_QR" else [])
        for other in runs:
            assert [it.step_is_successful for it in card.iterations] == [
                it.step_is_successful for it in other.iterations]
            np.testing.assert_allclose([it.cost for it in card.iterations],
                                       [it.cost for it in other.iterations], rtol=1e-8)


# -- dogleg, inner iterations and the Problem API on the card ----------------------


def _card_and_cpu(cuda, declare=None, compare_cameras=True, **kw):
    """The same float64 solve of synthetic_bal(16, 500, 4), 8 steps at
    initial radius 1 with the full budget, on the card and on the CPU:
    the same decisions, costs to rtol 1e-8, and unless
    ``compare_cameras`` is False the final cameras to rtol 1e-6;
    ``declare(problem, cams)`` adds declarations to both problems."""
    runs = []
    for device in (cuda, "cpu"):
        problem, cams, _ = build_bal_problem(synthetic_bal(16, 500, 4))
        if declare is not None:
            declare(problem, cams)
        s = stt.solve(stt.SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_SCHUR, max_num_iterations=8,
            run_full_iteration_budget=True, initial_trust_region_radius=1.0,
            dtype=torch.float64, device=device, **kw), problem)
        runs.append((s, cams.values.copy()))
    (card, card_cams), (cpu, cpu_cams) = runs
    assert [it.step_is_successful for it in card.iterations] == [
        it.step_is_successful for it in cpu.iterations]
    np.testing.assert_allclose([it.cost for it in card.iterations],
                               [it.cost for it in cpu.iterations], rtol=1e-8)
    if compare_cameras:
        np.testing.assert_allclose(card_cams, cpu_cams, rtol=1e-6, atol=1e-9)
    return card, cpu


@pytest.mark.gpu
@pytest.mark.parametrize("dogleg", ["TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"])
def test_dogleg_on_card_matches_cpu(cuda, dogleg):
    """Both dogleg types on the host loop, cameras 0 and 1 held constant
    (the 7-dof gauge fixed): the card's decisions, costs (rtol 1e-8) and
    cameras are the CPU's, with one Gauss-Newton solve a linearization on
    each. Without the gauge fixed, the Gauss-Newton point solves a
    near-singular system (a jitter rung, or a plain factor that rounding
    lets through), whose gauge components the rounding sets, and the
    step's length and so the trajectory follow them: the subspace case
    parted from the CPU in one of six runs on an NVIDIA H100 80GB HBM3."""
    from skeres_tpu_torch.core.types import DoglegType, TrustRegionStrategyType

    def gauge(problem, cams):
        problem.set_parameter_block_constant(cams[0])
        problem.set_parameter_block_constant(cams[1])

    card, cpu = _card_and_cpu(cuda, gauge,
                              trust_region_strategy_type=TrustRegionStrategyType.DOGLEG,
                              dogleg_type=DoglegType[dogleg])
    assert len(card.dogleg_gauss_newton_iterations) == len(cpu.dogleg_gauss_newton_iterations) \
        == card.num_successful_steps + 1


@pytest.mark.gpu
@pytest.mark.parametrize("device_loop", [False, True], ids=["host loop", "device loop"])
def test_inner_iterations_on_card_match_cpu(cuda, device_loop):
    """Inner iterations on both loops (the tolerance-stopped sweeps one
    WHILE node of the device loop's graph): costs to rtol 1e-8."""
    kw = dict(use_inner_iterations=True)
    if device_loop:
        kw.update(use_device_loop=True, device_loop_chunk_iterations=4)
    card, _ = _card_and_cpu(cuda, **kw)
    assert (card.device_loop_capture_time_in_seconds > 0.0) == device_loop


@pytest.mark.gpu
@pytest.mark.parametrize("device_loop", [False, True], ids=["host loop", "device loop"])
def test_declarations_on_card_match_cpu(cuda, device_loop):
    """A SubsetManifold holding f, k1 and k2, camera 0 constant and each
    camera's z translation bounded below at 1e-3 under its value: costs to
    rtol 1e-8 on both loops."""
    from skeres_tpu_torch.models.manifolds import SubsetManifold

    def declare(problem, cams):
        problem.set_manifold(cams, SubsetManifold(9, [6, 7, 8]))
        problem.set_parameter_block_constant(cams[0])
        for i in range(len(cams)):
            problem.set_parameter_lower_bound(cams[i], 5, float(cams.values[i, 5]) - 1e-3)

    kw = dict(use_device_loop=True, device_loop_chunk_iterations=4) if device_loop else {}
    card, _ = _card_and_cpu(cuda, declare, **kw)
    assert card.num_effective_parameters_reduced == 15 * 6 + 500 * 3


# -- the line search, pose graphs and covariance on the card -------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("direction", ["LBFGS", "BFGS", "NONLINEAR_CONJUGATE_GRADIENT"])
def test_line_search_on_card_matches_cpu(cuda, direction):
    """MinimizerType.LINE_SEARCH on synthetic_bal(16, 500, 4), float64, 15
    iterations with Wolfe steps: the same decisions and step-search
    evaluations, costs to rtol 1e-8."""
    from skeres_tpu_torch.core.types import LineSearchDirectionType, MinimizerType

    runs = []
    for device in (cuda, "cpu"):
        problem, _, _ = build_bal_problem(synthetic_bal(16, 500, 4))
        runs.append(stt.solve(stt.SolverOptions(
            minimizer_type=MinimizerType.LINE_SEARCH, max_num_iterations=15,
            line_search_direction_type=LineSearchDirectionType[direction], dtype=torch.float64,
            device=device), problem))
    card, cpu = runs
    assert [(it.step_is_successful, it.line_search_function_evaluations)
            for it in card.iterations] == [(it.step_is_successful,
                                            it.line_search_function_evaluations)
                                           for it in cpu.iterations]
    np.testing.assert_allclose([it.cost for it in card.iterations],
                               [it.cost for it in cpu.iterations], rtol=1e-8)


@pytest.mark.gpu
def test_pose_graph_on_card_matches_cpu(cuda):
    """A 200-pose synthetic sphere, DENSE_NORMAL_CHOLESKY, float64, 10
    steps, with check_gradients: the same decisions, costs to rtol 1e-8."""
    from skeres_tpu_torch.io.g2o import build_pose_graph_problem, synthetic_sphere

    graph = synthetic_sphere(num_poses=200, loops_every=15)
    runs = []
    for device in (cuda, "cpu"):
        problem, _ = build_pose_graph_problem(graph)
        runs.append(stt.solve(stt.SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_NORMAL_CHOLESKY, max_num_iterations=10,
            run_full_iteration_budget=True, check_gradients=True, dtype=torch.float64,
            device=device), problem))
    card, cpu = runs
    assert [it.step_is_successful for it in card.iterations] == [
        it.step_is_successful for it in cpu.iterations]
    np.testing.assert_allclose([it.cost for it in card.iterations],
                               [it.cost for it in cpu.iterations], rtol=1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["DENSE_SVD", "SCHUR_COMPLEMENT"])
def test_covariance_on_card_matches_cpu(cuda, algorithm):
    """tests/test_covariance_gradient.py's scene at one point, float64:
    every block pair type on the card equals the CPU's to rtol 1e-7 (its
    J^T J is 8.4e7-conditioned)."""
    from skeres_tpu_torch.core.covariance import Covariance, CovarianceOptions
    from skeres_tpu_torch.core.types import CovarianceAlgorithmType

    bal = synthetic_bal(num_cameras=5, num_points=30, observations_per_point=4)
    blocks = []
    for device in (cuda, "cpu"):
        problem, cams, pts = build_bal_problem(bal)
        problem.set_parameter_block_constant(cams[0])
        problem.set_parameter_block_constant(cams[1])
        cov = Covariance(CovarianceOptions(
            algorithm_type=CovarianceAlgorithmType[algorithm], device=device))
        assert cov.compute(problem)
        blocks.append([cov.get_covariance_block_in_tangent_space(a, b) for a, b in (
            (cams[2], cams[2]), (cams[3], pts[7]), (pts[3], pts[3]), (pts[3], pts[19]),
            (cams[0], cams[2]))])
    for x, y in zip(*blocks):
        np.testing.assert_allclose(x, y, rtol=1e-7, atol=1e-12)


def _probe_s(bal, device):
    """The equilibrated, damped S of the split ``bal`` (each camera a pose
    and an intrinsics block) by the column probe, float64 on ``device``,
    at the initial point with a unit LM diagonal."""
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.schur import SchurSolver
    from skeres_tpu_torch.io.bal import build_split_bal_problem

    program = build_split_bal_problem(bal)[0].compile()
    ev = Evaluator(program, device=device, dtype=torch.float64)
    schur = SchurSolver(ev)
    assert schur.schur_path.startswith("column-probe")
    _, blocks = ev.blocks(program.initial_state(device, torch.float64))
    d = torch.ones(program.num_tangent, dtype=torch.float64, device=device)
    s = schur._dense_s(schur._assemble(schur.prepare(schur.solver_data(blocks)), 0 * d, d))
    d_eq = torch.sqrt(torch.diagonal(s))
    return s / d_eq[:, None] / d_eq[None, :]


def _split_solves(bal, cuda, steps):
    from skeres_tpu_torch.io.bal import build_split_bal_problem

    runs = []
    for device in (cuda, "cpu"):
        problem = build_split_bal_problem(bal)[0]
        runs.append(stt.solve(stt.SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_SCHUR, max_num_iterations=steps,
            run_full_iteration_budget=True, initial_trust_region_radius=1.0,
            dtype=torch.float64, device=device,
        ), problem))
    return runs


@pytest.mark.gpu
def test_probe_s_into_k1_on_card(cuda):
    """synthetic_bal(16, 500, 4) split: S of 144 rows by the column probe on
    the card equals the CPU's (rtol 1e-10); K1 on it against its plain
    version (1e-10 of max|reference|); a 5-step DENSE_SCHUR solve on the
    card against the CPU (costs to rtol 1e-8), K1 launched once a damped
    solve at least."""
    bal = synthetic_bal(16, 500, 4)
    s = _probe_s(bal, cuda)
    s_cpu = _probe_s(bal, "cpu")
    assert s.shape == (144, 144)
    assert float((s.cpu() - s_cpu).abs().max()) <= 1e-10 * float(s_cpu.abs().max())
    l, linv = k1.cholesky_both(s)
    l_ref, linv_ref = k1.cholesky_both_reference(s)
    for x, ref in ((l, l_ref), (linv, linv_ref)):
        assert float((x - ref).abs().max()) <= 1e-10 * float(ref.abs().max())
    before = k1.cholesky_both.launches
    card, cpu = _split_solves(bal, cuda, 5)
    assert k1.cholesky_both.launches >= before + card.num_linear_solves > before
    assert card.schur_complement_path.startswith("column-probe")
    np.testing.assert_allclose([it.cost for it in card.iterations],
                               [it.cost for it in cpu.iterations], rtol=1e-8)


@pytest.mark.gpu
def test_probe_s_into_k2_on_card(cuda):
    """synthetic_bal(120, 2000, 4) split: S of 1080 rows by the column
    probe, past K1's 1024, so K2 factors it (K1 panels and the trailing
    update): against cuSOLVER's factor (1e-10 of max|reference|); a 3-step
    solve on the card against the CPU (costs to rtol 1e-8), the update
    launched on every damped solve."""
    bal = synthetic_bal(120, 2000, 4)
    s = _probe_s(bal, cuda)
    assert s.shape == (1080, 1080)
    updates = k1.trailing_update_.launches
    fac = k1.blocked_cholesky_factor(s)
    assert k1.trailing_update_.launches > updates
    l_ref = k1.blocked_cholesky_factor_reference(s)
    assert float((fac.l - l_ref).abs().max()) <= 1e-10 * float(l_ref.abs().max())
    updates = k1.trailing_update_.launches
    card, cpu = _split_solves(bal, cuda, 3)
    assert k1.trailing_update_.launches >= updates + card.num_linear_solves > updates
    np.testing.assert_allclose([it.cost for it in card.iterations],
                               [it.cost for it in cpu.iterations], rtol=1e-8)


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card(cuda):
    """The sharded explicit-S LM step (``parallel/dryrun.py``) on 2 gloo
    ranks sharing ``cuda:0`` (NCCL refuses two ranks on one card): the plan
    is sharded with straddling points, K3 runs on each rank's grid and on
    the fixup grid, and both ranks report the same costs."""
    from skeres_tpu_torch.parallel.dryrun import dryrun_multichip

    reports = dryrun_multichip(2, "cuda:0")
    for r in reports:
        assert r["n_straddle"] > 0 and r["path"] == "explicit"
        assert r["k3_launches"] == 2 and r["k3_fixup_launches"] == 1
        assert (r["cost"], r["new_cost"]) == (reports[0]["cost"], reports[0]["new_cost"])
        assert r["new_cost"] < r["cost"]


@pytest.mark.gpu
def test_device_loop_under_a_gloo_mesh_on_the_card_raises(cuda):
    """A CUDA graph captures NCCL collectives only: the device loop under a
    gloo mesh on the card raises ValueError naming the backend (the host
    loop runs such a mesh)."""
    import torch.distributed as dist

    from skeres_tpu_torch.parallel import initialize_distributed, make_obs_mesh

    initialize_distributed(world_size=1, backend="gloo", device_type="cuda")
    try:
        mesh = make_obs_mesh(device_type="cuda")
        problem, _, _ = build_bal_problem(synthetic_bal(6, 60, 4))
        with pytest.raises(ValueError, match="gloo mesh"):
            stt.solve(stt.SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR,
                                        max_num_iterations=2, use_device_loop=True,
                                        dtype=torch.float64, device=cuda, mesh=mesh), problem)
        host = stt.solve(stt.SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR,
                                           max_num_iterations=2, dtype=torch.float64,
                                           device=cuda, mesh=mesh), problem)
        assert host.num_devices == 1 and host.final_cost < host.initial_cost
    finally:
        dist.destroy_process_group()
