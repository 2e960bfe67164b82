"""The port's CUDA kernels on a card: each kernel against its plain
PyTorch version, and a small solve on the card against the same solve on
the CPU. Every case carries the ``gpu`` marker and skips without a CUDA
card. The file imports no jax, so that it also runs on a machine with a
card and no jax:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

(``--noconftest`` because ``tests/conftest.py`` configures jax).
"""

import dataclasses

import numpy as np
import pytest
import torch

import skeres_tpu_torch as stt
from skeres_tpu_torch.core.types import LinearSolverType
from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal
from skeres_tpu_torch.ops import cholesky as k1
from skeres_tpu_torch.ops import pair_product as k3
from skeres_tpu_torch.ops import s_product as sp


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
    # the step's stamps (%globaltimer on the card): the timers, each
    # iteration's times, and the replays of chunks of 4, 4 and 2
    for s in (card, cpu):
        assert s.num_device_loop_replays == 10
        assert min(s.linear_solver_time_in_seconds, s.residual_evaluation_time_in_seconds,
                   s.jacobian_evaluation_time_in_seconds) > 0.0
        assert all(0.0 < it.step_solver_time_in_seconds < it.iteration_time_in_seconds
                   for it in s.iterations[1:])
        cumulative = [it.cumulative_time_in_seconds for it in s.iterations]
        assert all(b > a for a, b in zip(cumulative, cumulative[1:]))
        assert cumulative[-1] <= s.minimizer_time_in_seconds


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


@pytest.mark.gpu
def test_padded_s_product_on_card_matches_generic(cuda):
    """The camera-padded S product on the minimizer's path (unscaled
    placed rows, ``cam_scale`` set) on the card against the generic product
    on the card and the padded one on the CPU, float64, 1e-12; and a
    padded damped solve on the card under a CUDA graph equal to the eager
    one."""
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.graph import CapturedStep
    from skeres_tpu_torch.core.linear_solvers import lm_diagonal
    from skeres_tpu_torch.core.schur import SchurSolver

    program = build_bal_problem(synthetic_bal(8, 90, 3))[0].compile()
    products = {}
    for dev in (cuda, torch.device("cpu")):
        ev = Evaluator(program, dev, torch.float64)
        _, blocks = ev.blocks(program.initial_state(dev, torch.float64))
        g, diag = ev.gradient_and_diag(blocks)
        scale = 1.0 / (1.0 + torch.sqrt(diag))
        for thresh in (1, 10**12):
            schur = SchurSolver(ev, iterative=True, sort_threshold=thresh, pad_waste=100.0)
            data = schur.scale_data(schur.solver_data(blocks), scale)
            if thresh == 1:
                _, _, raw = schur.gradient_and_diag(blocks)
                prep = schur.prepare(data, cam_raw=raw, scale=scale)
            else:
                prep = schur.prepare(data)
            asm = schur._assemble(prep, g * scale, lm_diagonal(diag * scale**2, 1e-4, 1e-6, 1e32))
            v = torch.linspace(-1.0, 1.0, schur.num_f, dtype=torch.float64, device=dev)
            products[(dev.type, thresh)] = schur._s_matvec(asm, v).cpu().numpy()
            if dev.type == "cuda" and thresh == 1:
                gs, ds = g * scale, diag * scale**2
                mu = torch.tensor(1e-4, dtype=torch.float64, device=dev)
                jitter0 = torch.zeros((), dtype=torch.float64, device=dev)
                out = (torch.empty_like(g), torch.zeros((), dtype=torch.int64, device=dev))

                def step():
                    dx, iters, _ = schur.solve_damped(prep, gs, ds, mu, 1e-6, 1e32, jitter0)
                    out[0].copy_(dx)
                    out[1].copy_(iters)

                captured = CapturedStep(step, dev)
                captured.capture()
                assert captured.graph is not None
                for buf in out:
                    buf.zero_()
                captured()
                eager = schur.solve_damped(prep, gs, ds, mu, 1e-6, 1e32, jitter0)
                torch.cuda.synchronize()
                captured.release()
                assert int(out[1]) == int(eager[1]) > 1
                torch.testing.assert_close(out[0], eager[0], rtol=1e-12, atol=1e-12)
    ref = products[("cuda", 10**12)]
    for key in (("cuda", 1), ("cpu", 1), ("cpu", 10**12)):
        np.testing.assert_allclose(products[key], ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


@pytest.mark.gpu
@pytest.mark.parametrize("shuffled", [False, True], ids=["point-sorted", "shuffled"])
def test_plans_built_on_card_equal_cpu_plans(cuda, shuffled):
    """The explicit-S pair plan and the camera-padded layout plan built on
    the card from index tensors on the card equal the CPU build element
    for element, and keep their tensors on the card: 60,000 points seen
    3-6 times each by 300 cameras (about 270k rows, 670k valid pair rows),
    in point order (the grid's gather reads the rows in order) or
    shuffled."""
    from skeres_tpu_torch.core.explicit_schur import ExplicitSchurPlan
    from skeres_tpu_torch.core.schur import padded_plan

    rng = np.random.default_rng(17)
    nc, npts = 300, 60_000
    pt = np.repeat(np.arange(npts), rng.integers(3, 7, size=npts) if shuffled else 5)
    if shuffled:
        pt = rng.permutation(pt)
    cam = rng.integers(0, nc, size=len(pt))
    assert len(pt) >= 200_000
    plans, layouts = {}, {}
    for key, dev in (("cpu", torch.device("cpu")), ("card", cuda)):
        cam_t, pt_t = torch.from_numpy(cam).to(dev), torch.from_numpy(pt).to(dev)
        plans[key] = ExplicitSchurPlan(cam_idx=cam_t, pt_idx=pt_t, num_cameras=nc,
                                       num_points=npts, f_size=9, e_size=3, device=dev)
        layouts[key] = padded_plan(cam_t, pt_t, nc, 1, 0, 100_000, 1.5)
    cpu, card = plans["cpu"], plans["card"]
    if not shuffled:
        assert torch.equal(card.grid_src.cpu(), torch.arange(len(pt)))
    assert (card.kp, card.npairs, card.n_uniq) == (cpu.kp, cpu.npairs, cpu.n_uniq)
    kept = [("swap_mask", card.swap_mask, cpu.swap_mask),
            ("pair_valid", card.pair_valid, cpu.pair_valid),
            ("pos2u_combined", card.pos2u_combined, cpu.pos2u_combined),
            ("diag_pair_idx", card.diag_pair_idx, cpu.diag_pair_idx),
            ("pair_kl", card.pair_kl, cpu.pair_kl),
            ("grid_src", card.grid_src, cpu.grid_src)]
    assert [(lv.n_dest, lv.cap) for lv in card.levels] == [(lv.n_dest, lv.cap) for lv in cpu.levels]
    kept += [(f"level {k} src", lv.src, lc.src)
             for k, (lv, lc) in enumerate(zip(card.levels, cpu.levels))]
    (k_card, (src, pidx)), (k_cpu, (src_c, pidx_c)) = layouts["card"], layouts["cpu"]
    assert k_card == k_cpu is not None
    kept += [("layout src", src, src_c), ("layout pidx_pad", pidx, pidx_c)]
    for name, on_card, on_cpu in kept:
        assert on_card.is_cuda, name
        assert torch.equal(on_card.cpu(), on_cpu), name


def _s_pass_inputs(device, dtype, m, t, e, f_first, shuffled):
    """Random inputs of both S passes on ``device``: 3,000 points seen by
    1-12 rows each, 40 cameras; the rows' values 2 wider than m (t + e), as
    the minimizer's placed rows, and placed camera by camera."""
    g = torch.Generator().manual_seed(t * 10 + e)
    n_pts, nc, w = 3000, 40, m * (t + e)
    pt = torch.repeat_interleave(torch.arange(n_pts), torch.randint(1, 13, (n_pts,), generator=g))
    b = len(pt)
    perm = torch.randperm(b, generator=g) if shuffled else torch.arange(b)
    row_pt = torch.empty_like(pt)
    row_pt[perm] = pt  # row perm[q] belongs to the q-th point-sorted slot
    cam = torch.randint(0, nc, (b,), generator=g)
    wide = torch.randn(b, w + 2, generator=g, dtype=torch.float64).to(dtype)
    counts = torch.bincount(cam, minlength=nc)
    K = int(counts.max())
    order = torch.argsort(cam, stable=True)
    slot = torch.arange(b) - torch.cumsum(counts, 0)[cam[order]] + counts[cam[order]]
    placed = wide.new_zeros((nc * K, w + 2))
    pidx = torch.zeros(nc * K, dtype=torch.int64)
    placed[cam[order] * K + slot] = wide[order]
    pidx[cam[order] * K + slot] = row_pt[order]
    x = dict(rows=wide[:, :w].contiguous().unflatten(1, (m, t + e)), cam=cam,
             seg=torch.searchsorted(pt, torch.arange(n_pts + 1)),
             perm=perm if shuffled else None, pidx=pidx, counts=counts,
             v_cam=torch.randn(nc, t, generator=g, dtype=torch.float64).to(dtype),
             cinv=torch.randn(n_pts, e, e, generator=g, dtype=torch.float64).to(dtype),
             s_e=torch.rand(n_pts, e, generator=g, dtype=torch.float64).to(dtype),
             s_f=torch.rand(nc, t, generator=g, dtype=torch.float64).to(dtype))
    x = {k: None if v is None else v.to(device) for k, v in x.items()}
    x["placed"] = placed.to(device)[:, :w].unflatten(1, (m, t + e))
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["grouped", "shuffled"])
@pytest.mark.parametrize("shape", [(2, 9, 3, True), (2, 9, 3, False), (3, 4, 3, True),
                                   (2, 6, 3, False)],
                         ids=["ba", "ba points first", "stereo", "calibrated"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_s_passes_match_plain_versions_on_card(cuda, dtype, tol, shape, order):
    """Each pass of the S product against its plain version on the same
    card tensors, with and without C^-1, s_e and s_f, within
    ``tol`` of max|reference| (sums of up to 12 rows of 9-term products in
    another order); two calls on the same inputs equal bit for bit; one
    launch a call. (2, 9, 3) with F first takes the instance of its own
    sizes, the rest the one with sizes read at run time."""
    m, t, e, f_first = shape
    x = _s_pass_inputs(cuda, dtype, m, t, e, f_first, order == "shuffled")
    before = (sp.point_sums.launches, sp.camera_sums.launches)
    for cinv, s_e in ((None, None), (x["cinv"], None), (x["cinv"], x["s_e"])):
        args = (x["rows"], f_first, x["cam"], x["v_cam"], x["seg"], x["perm"], cinv, s_e)
        got, again = sp.point_sums(*args), sp.point_sums(*args)
        ref = sp.point_sums_reference(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
    wc = got
    assert wc.stride(0) == (4 if e == 3 else e)
    for s_f in (None, x["s_f"]):
        for table in (wc, wc.contiguous()):
            args = (x["placed"], f_first, x["pidx"], x["counts"], x["v_cam"], table, s_f)
            got, again = sp.camera_sums(*args), sp.camera_sums(*args)
            ref = sp.camera_sums_reference(*args)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
    assert (sp.point_sums.launches, sp.camera_sums.launches) == (before[0] + 6, before[1] + 8)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 9, 3, True), (2, 9, 3, False), (3, 4, 3, True),
                                   (4, 16, 4, True)],
                         ids=["ba", "ba points first", "stereo", "widest"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_camera_blocks_match_plain_version_on_card(cuda, dtype, tol, shape):
    """The camera blocks' kernel against its plain version on the same card
    tensors, ``F^T F`` alone, with an SPD C^-1, and with C^-1 and s_e,
    within ``tol`` of max|reference| (sums of about 500 rows of products in
    another order); each block symmetric; two calls equal bit for bit; one
    launch a call. (2, 9, 3) with F first takes the instance of its own
    sizes, the rest the one with sizes read at run time, (4, 16, 4) its
    largest."""
    m, t, e, f_first = shape
    x = _s_pass_inputs(cuda, dtype, m, t, e, f_first, False)
    cinv = x["cinv"] @ x["cinv"].transpose(1, 2)
    before = sp.camera_blocks.launches
    for c, s_e in ((None, None), (cinv, None), (cinv, x["s_e"])):
        args = (x["placed"], f_first, x["pidx"], x["counts"], t, c, s_e)
        got, again = sp.camera_blocks(*args), sp.camera_blocks(*args)
        ref = sp.camera_blocks_reference(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.equal(got, got.transpose(1, 2))
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max())
    assert sp.camera_blocks.launches == before + 6


def _padded_scene(shuffled):
    bal = synthetic_bal(16, 500, 4)
    if shuffled:
        rows = np.random.default_rng(3).permutation(len(bal.point_index))
        bal = dataclasses.replace(bal, camera_index=bal.camera_index[rows],
                                  point_index=bal.point_index[rows],
                                  observations=bal.observations[rows])
    return bal


@pytest.mark.gpu
@pytest.mark.parametrize("order", ["grouped", "shuffled"])
@pytest.mark.parametrize("cam_raw", [True, False], ids=["cam_raw", "prescaled"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-12)])
def test_padded_s_product_kernels_on_card_match_plain(cuda, dtype, tol, cam_raw, order):
    """``implicit_s_product`` on a padded scene on the card (the kernel
    pair, one launch each a product, bit for bit on a second call) against
    the same product on the CPU (the plain versions), with the
    minimizer's unscaled placed rows and with pre-scaled ones, rows grouped
    by point or shuffled (the permutation plan), within ``tol`` of
    max|S v|: S v is the difference of F^T F v and W C^-1 W^T v, each
    summed in another order on the two devices, so float32 keeps about
    four digits of it."""
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.linear_solvers import lm_diagonal
    from skeres_tpu_torch.core.schur import SchurSolver, implicit_s_product

    program = build_bal_problem(_padded_scene(order == "shuffled"))[0].compile()
    products = {}
    for dev in (cuda, torch.device("cpu")):
        ev = Evaluator(program, dev, dtype)
        _, blocks = ev.blocks(program.initial_state(dev, dtype))
        g, diag = ev.gradient_and_diag(blocks)
        scale = 1.0 / (1.0 + torch.sqrt(diag))
        schur = SchurSolver(ev, iterative=True, sort_threshold=1, pad_waste=100.0)
        assert (schur.sorted_info[0]["pt_perm"] is None) == (order == "grouped")
        data = schur.scale_data(schur.solver_data(blocks), scale)
        if cam_raw:
            _, _, raw = schur.gradient_and_diag(blocks)
            prep = schur.prepare(data, cam_raw=raw, scale=scale)
        else:
            prep = schur.prepare(data)
        asm = schur._assemble(prep, g * scale, lm_diagonal(diag * scale**2, 1e-4, 1e-6, 1e32))
        v = torch.linspace(-1.0, 1.0, schur.num_f, dtype=dtype, device=dev)
        before = (sp.point_sums.launches, sp.camera_sums.launches)
        sv = implicit_s_product(schur, asm, v)
        again = implicit_s_product(schur, asm, v)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert (sp.point_sums.launches, sp.camera_sums.launches) == (before[0] + 2,
                                                                         before[1] + 2)
            assert torch.equal(sv, again)
        products[dev.type] = sv.cpu()
    ref = products["cpu"]
    assert float((products["cuda"] - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("cam_raw", [True, False], ids=["cam_raw", "prescaled"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-12)])
def test_padded_camera_blocks_on_card_match_plain(cuda, dtype, tol, cam_raw):
    """The camera blocks of S on a padded scene on the card (SCHUR_JACOBI's,
    and POWER_SERIES_EXPANSION's without the E correction: the kernel, one
    launch a build, bit for bit on a second build) against the same blocks
    on the CPU (the plain version), with the minimizer's unscaled placed
    rows and with pre-scaled ones, within ``tol`` of max|block|: each block
    is F^T F less its E correction, summed in another order on the two
    devices."""
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.linear_solvers import lm_diagonal
    from skeres_tpu_torch.core.schur import SchurSolver

    program = build_bal_problem(_padded_scene(False))[0].compile()
    blocks = {}
    for dev in (cuda, torch.device("cpu")):
        ev = Evaluator(program, dev, dtype)
        _, rows = ev.blocks(program.initial_state(dev, dtype))
        g, diag = ev.gradient_and_diag(rows)
        scale = 1.0 / (1.0 + torch.sqrt(diag))
        schur = SchurSolver(ev, iterative=True, sort_threshold=1, pad_waste=100.0)
        data = schur.scale_data(schur.solver_data(rows), scale)
        if cam_raw:
            _, _, raw = schur.gradient_and_diag(rows)
            prep = schur.prepare(data, cam_raw=raw, scale=scale)
        else:
            prep = schur.prepare(data)
        asm = schur._assemble(prep, g * scale, lm_diagonal(diag * scale**2, 1e-4, 1e-6, 1e32))
        for e_corr in (True, False):
            before = sp.camera_blocks.launches
            got = schur._schur_jacobi_blocks(asm, include_e_correction=e_corr)[0]
            again = schur._schur_jacobi_blocks(asm, include_e_correction=e_corr)[0]
            if dev.type == "cuda":
                torch.cuda.synchronize()
                assert sp.camera_blocks.launches == before + 2
                assert torch.equal(got, again)
            blocks[dev.type, e_corr] = got.cpu()
    for e_corr in (True, False):
        ref = blocks["cpu", e_corr]
        assert float((blocks["cuda", e_corr] - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.gpu
def test_dense_schur_past_the_kernel_sizes_keeps_off_the_layout_on_card(cuda):
    """DENSE_SCHUR on the card with the layout forced on, for a batch of
    three stacked reprojection residuals a row (m = 6, past the kernels'
    (4, 16, 4)): the layout is refused, the camera blocks come from the row
    loop with no kernel launch, and equal the CPU's within 1e-12 of
    max|block|."""
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.linear_solvers import lm_diagonal
    from skeres_tpu_torch.core.schur import SchurSolver
    from skeres_tpu_torch.models.reprojection import snavely_reprojection_error

    bal = synthetic_bal(8, 90, 3)
    problem = stt.Problem()
    cameras = problem.add_parameter_block_array(bal.cameras, name="cameras")
    points = problem.add_parameter_block_array(bal.points, name="points")
    problem.set_schur_elimination_group(points, 0)
    problem.set_schur_elimination_group(cameras, 1)
    problem.add_residual_blocks(
        lambda p, d: torch.cat([snavely_reprojection_error(p, d) * 0.5**k for k in range(3)]),
        None, [(cameras, bal.camera_index), (points, bal.point_index)],
        data=bal.observations, name="stacked")
    program = problem.compile()
    blocks = {}
    for dev in (cuda, torch.device("cpu")):
        ev = Evaluator(program, dev, torch.float64)
        _, rows = ev.blocks(program.initial_state(dev, torch.float64))
        g, diag = ev.gradient_and_diag(rows)
        scale = 1.0 / (1.0 + torch.sqrt(diag))
        schur = SchurSolver(ev, iterative=False, sort_threshold=1, pad_waste=100.0)
        assert schur.sorted_info == {}
        prep = schur.prepare(schur.scale_data(schur.solver_data(rows), scale))
        asm = schur._assemble(prep, g * scale, lm_diagonal(diag * scale**2, 1e-4, 1e-6, 1e32))
        before = sp.camera_blocks.launches
        blocks[dev.type] = schur._schur_jacobi_blocks(asm)[0].cpu()
        assert sp.camera_blocks.launches == before
    ref = blocks["cpu"]
    assert float((blocks["cuda"] - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.gpu
def test_iterative_schur_kernels_in_solves_on_card(cuda, monkeypatch):
    """A padded ITERATIVE_SCHUR (SCHUR_JACOBI) solve in float64 on the card:
    on the host loop every S product launches each kernel once (the
    counters grow by the number of products) and every damped solve the
    camera blocks' kernel once; on the device loop the captured step records
    them (the counters grow by the captures' products, not the replays'),
    and the solve keeps the host loop's decisions, PCG counts and costs to
    rtol 1e-8, as the device-loop tests hold."""
    from skeres_tpu_torch.core import schur as schur_mod
    from skeres_tpu_torch.core.types import PreconditionerType

    calls = []
    product = schur_mod.implicit_s_product

    def counting(*args):
        calls.append(1)
        return product(*args)

    monkeypatch.setattr(schur_mod, "implicit_s_product", counting)
    runs = []
    for device_loop in (False, True):
        problem, _, _ = build_bal_problem(synthetic_bal(16, 500, 4))
        calls.clear()
        before = (sp.point_sums.launches, sp.camera_sums.launches)
        blocks_before = sp.camera_blocks.launches
        runs.append(stt.solve(stt.SolverOptions(
            linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=PreconditionerType.SCHUR_JACOBI, max_num_iterations=8,
            run_full_iteration_budget=True, initial_trust_region_radius=1.0,
            jacobian_sort_threshold=1, jacobian_pad_waste=100.0,
            use_device_loop=device_loop, device_loop_chunk_iterations=4,
            dtype=torch.float64, device=cuda), problem))
        assert runs[-1].camera_padded_layout.startswith("batch 0: 16 x ")
        grown = (sp.point_sums.launches - before[0], sp.camera_sums.launches - before[1])
        assert grown == (len(calls), len(calls)) and len(calls) > 0
        if not device_loop:
            assert len(calls) >= sum(it.linear_solver_iterations for it in runs[-1].iterations)
            assert sp.camera_blocks.launches - blocks_before == runs[-1].num_linear_solves
    host, device = runs
    assert device.device_loop_capture_time_in_seconds > 0.0
    assert [it.step_is_successful for it in device.iterations] == [
        it.step_is_successful for it in host.iterations]
    counts = [[it.linear_solver_iterations for it in s.iterations] for s in (device, host)]
    assert counts[0] == counts[1] and max(counts[0]) > 1
    np.testing.assert_allclose([it.cost for it in device.iterations],
                               [it.cost for it in host.iterations], rtol=1e-8)


@pytest.mark.gpu
def test_visibility_cluster_apply_on_card(cuda):
    """The CLUSTER_TRIDIAGONAL factor and chain apply on canonical-views
    clusters, float64 on the card, on a 120-camera cut of the benchmark's
    Final-4585 site scene (a chain a site): the apply against its plain
    version on the card (each chain's matrix dense) and against the CPU's
    apply, both to 1e-12 of the solution's norm; the clusters equal the
    CPU's."""
    from benchmark import harness
    from skeres_tpu_torch.core import schur as schur_mod
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.linear_solvers import lm_diagonal
    from skeres_tpu_torch.core.types import PreconditionerType, VisibilityClusteringType

    cell = harness.load_cell("final4585.cluster-tridiagonal")
    config = {**cell["config_data"], "num_cameras": 120, "num_points": 1500,
              "num_observations": 9500, "track_lengths": {"6": 1000, "7": 500}}
    config["assumed"] = {**config["assumed"], "num_sites": 4, "min_site_cameras": 14,
                         "bridge_share": 0.0}
    mod = harness.load_module("scenes", config["generator"])
    scene = mod.generate(config, 2_718_281_828_459, "cpu")
    v = torch.tensor(np.random.default_rng(4).standard_normal(120 * 9))
    out = {}
    for device in ("cpu", cuda):
        ev = Evaluator(mod.build_problem(scene)[0].compile(), device=device)
        _, blocks = ev.blocks(ev.program.initial_state(device, torch.float64))
        g, diag = ev.gradient_and_diag(blocks)
        scale = 1.0 / (1.0 + torch.sqrt(diag))
        solver = schur_mod.SchurSolver(
            ev, iterative=True, preconditioner=PreconditionerType.CLUSTER_TRIDIAGONAL,
            visibility_clustering=VisibilityClusteringType.CANONICAL_VIEWS)
        data = solver.prepare(solver.scale_data(solver.solver_data(blocks), scale))
        asm = solver._assemble(data, g * scale, lm_diagonal(diag * scale**2, 1e-2, 1e-6, 1e32))
        factors = schur_mod.cluster_preconditioner(solver, asm)
        x = v.to(device)
        out[str(device)] = (schur_mod.apply_cluster_preconditioner(solver, factors, x),
                            schur_mod.dense_cluster_solve(solver, asm, x, factors["band_scale"]),
                            solver.visibility.cluster_of.cpu())
    cpu, card = out["cpu"], out[str(cuda)]
    assert torch.equal(cpu[2], card[2])

    def rel(a, b):
        return float(torch.linalg.norm(a.cpu() - b.cpu()) / torch.linalg.norm(b.cpu()))

    assert rel(card[0], card[1]) <= 1e-12 and rel(card[0], cpu[0]) <= 1e-12


def _snavely_rows_on(device, dtype, n=40_000, seed=0):
    """n rows of a scene with 300 cameras and 9,000 points on ``device``:
    rotations of scale 0.3 with one camera in eight under the small-angle
    threshold, cameras 10 from the points along z (|x|, |y| < 1 in the
    image plane, as in BAL), focal ~500, k1 and k2 of scale 0.05 and 0.01,
    observations ~100 pixels."""
    from skeres_tpu_torch.ops.rotation import _SMALL

    g = np.random.default_rng(seed)
    cams = g.standard_normal((300, 9))
    cams[:, 0:3] *= 0.3
    cams[::8, 0:3] *= np.sqrt(0.5 * _SMALL) / np.linalg.norm(cams[::8, 0:3], axis=1)[:, None]
    cams[:, 3:6] *= 0.5
    cams[:, 5] = -10.0
    cams[:, 6] = 500.0 + 100.0 * g.random(300)
    cams[:, 7] *= 0.05
    cams[:, 8] *= 0.01
    t = lambda a, dt=dtype: torch.tensor(a, dtype=dt, device=device)  # noqa: E731
    return (t(cams), t(g.standard_normal((9000, 3))),
            t(g.integers(0, 300, n), torch.int64), t(g.integers(0, 9000, n), torch.int64),
            t(100.0 * g.standard_normal((n, 2))))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-14), (torch.float32, 5e-6)])
@pytest.mark.parametrize("n", [1, 127, 40_000])
def test_snavely_rows_match_plain_version_on_card(cuda, dtype, tol, n):
    """The reprojection kernel against its plain version: J within ``tol``
    of each row's largest |entry|, r of |r| + |observation| (the terms it
    is the difference of), the costs likewise; float64 to 1e-14 (the same
    formulas, contracted into FMAs), float32 to 5e-6 (some 40 float32
    operations in a chain). Two calls agree bit for bit, and each call is
    one launch."""
    from skeres_tpu_torch.ops import reprojection as rp

    args = _snavely_rows_on(cuda, dtype, n)
    obs = args[-1]
    before = (rp.snavely_rows.launches, rp.snavely_costs.launches)
    (r, jac), (r2, jac2) = rp.snavely_rows(*args), rp.snavely_rows(*args)
    cost, cost2 = rp.snavely_costs(*args), rp.snavely_costs(*args)
    r_ref, jac_ref = rp.snavely_rows_reference(*args)
    cost_ref = rp.snavely_costs_reference(*args)
    torch.cuda.synchronize()
    assert (rp.snavely_rows.launches - before[0], rp.snavely_costs.launches - before[1]) == (2, 2)
    assert torch.equal(r, r2) and torch.equal(jac, jac2) and torch.equal(cost, cost2)
    terms = (r_ref.abs() + obs.abs()).amax(1)
    assert float(((r - r_ref).abs().amax(1) / terms).max()) <= tol
    assert float(((jac - jac_ref).abs().amax((1, 2)) / jac_ref.abs().amax((1, 2))).max()) <= tol
    assert float(((cost - cost_ref).abs() / (terms * terms)).max()) <= tol


@pytest.mark.gpu
def test_evaluator_chunks_launch_once_each_on_card(cuda):
    """The evaluator on the card takes the kernel for a Snavely batch: one
    launch a chunk for ``blocks`` and one for ``cost``, the chunked outputs
    equal to the unchunked ones bit for bit; a host-loop solve launches it
    once a chunk of each linearization (``num_evaluation_chunks``)."""
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.ops import reprojection as rp

    program = build_bal_problem(synthetic_bal(16, 500, 4))[0].compile()
    out = {}
    for chunk in (None, 300):
        ev = Evaluator(program, device=cuda, chunk_size=chunk)
        state = program.initial_state(cuda, torch.float64)
        chunks = len(ev._row_slices(0))
        before = (rp.snavely_rows.launches, rp.snavely_costs.launches)
        cost, (b,) = ev.blocks(state)
        cost_only = ev.cost(state)
        torch.cuda.synchronize()
        grown = (rp.snavely_rows.launches - before[0], rp.snavely_costs.launches - before[1])
        assert grown == (chunks, chunks)
        out[chunk] = (b.r, b.jac, cost, cost_only)
    assert len(Evaluator(program, device=cuda, chunk_size=300)._row_slices(0)) == 7
    for whole, chunked in zip(out[None][:2], out[300][:2]):
        assert torch.equal(whole, chunked)
    torch.testing.assert_close(out[300][2], out[None][2], rtol=1e-14, atol=0)
    torch.testing.assert_close(out[300][3], out[None][3], rtol=1e-14, atol=0)
    problem = build_bal_problem(synthetic_bal(16, 500, 4))[0]
    before = rp.snavely_rows.launches
    s = stt.solve(stt.SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_SCHUR, max_num_iterations=4,
        evaluation_chunk_size=300, dtype=torch.float64, device=cuda), problem)
    assert rp.snavely_rows.launches - before == s.num_evaluation_chunks == 7 * (
        s.num_jacobian_evaluations)


@pytest.mark.gpu
def test_captured_evaluation_equals_eager_on_card(cuda):
    """At BAL-49's shape (49 cameras, 7,776 points, 31,104 rows, float64)
    the device loop's evaluation, the linearization and the candidate
    cost, captured as a CUDA graph and replayed, equals the eager one bit
    for bit; the replays launch nothing the counter sees."""
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.graph import CapturedStep
    from skeres_tpu_torch.ops import reprojection as rp

    ev = Evaluator(build_bal_problem(synthetic_bal(49, 7776, 4))[0].compile(), device=cuda)
    state = ev.program.initial_state(cuda, torch.float64)
    r = torch.empty((31_104, 2), dtype=torch.float64, device=cuda)
    jac = torch.empty((31_104, 2, 12), dtype=torch.float64, device=cuda)
    costs = torch.empty(2, dtype=torch.float64, device=cuda)

    def step():
        cost, (b,) = ev.blocks(state)
        r.copy_(b.r)
        jac.copy_(b.jac)
        costs[0] = cost
        costs[1] = ev.cost(state)

    captured = CapturedStep(step, cuda)
    captured.capture()
    assert captured.graph is not None
    for buf in (r, jac, costs):
        buf.zero_()
    before = (rp.snavely_rows.launches, rp.snavely_costs.launches)
    captured()
    captured()
    torch.cuda.synchronize()
    assert (rp.snavely_rows.launches, rp.snavely_costs.launches) == before
    cost, (b,) = ev.blocks(state)
    eager_cost = ev.cost(state)
    torch.cuda.synchronize()
    captured.release()
    assert torch.equal(r, b.r) and torch.equal(jac, b.jac)
    assert float(costs[0]) == float(cost) and float(costs[1]) == float(eager_cost)
