"""The port's device loop (``core/device_loop.py``) against the JAX
package's device loop and against the port's own host loop; the sync-free
PCG and the ``cond`` form of the damped solve (``core/graph.py``). float64
on the CPU, where ``cond`` reads its predicate and the captured step runs
eagerly: iteration rows to rtol 1e-10, final parameters to rtol 1e-10
(the two packages sum in other orders; the trajectories agree to ~1e-12)."""

import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core.linear_solvers import (
    preconditioned_conjugate_gradients as jax_pcg,
)
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.core.types import LinearSolverType as JLinearSolverType
from skeres_tpu.core.types import PreconditionerType as JPreconditionerType
from skeres_tpu.io import bal as jbal
from skeres_tpu_torch.core import schur as schur_mod
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.graph import cond, while_loop
from skeres_tpu_torch.core.linear_solvers import preconditioned_conjugate_gradients
from skeres_tpu_torch.core.schur import SchurSolver
from skeres_tpu_torch.core.types import LinearSolverType, PreconditionerType
from skeres_tpu_torch.io import bal as tbal
from skeres_tpu_torch.models.reprojection import snavely_reprojection_error


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers run side by side on a few cores: one thread each for
    the small problems here, or the workers' thread pools fight over the
    cores (a DENSE_QR case took minutes that way)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

RTOL = 1e-10


def _solve_jax(bal, solver="DENSE_SCHUR", precond="JACOBI", **kw):
    problem, cams, pts = jbal.build_bal_problem(bal)
    s = st.solve(JOptions(linear_solver_type=JLinearSolverType[solver],
                          preconditioner_type=JPreconditionerType[precond], **kw), problem)
    return s, cams.values.copy(), pts.values.copy()


def _solve_port(bal, solver="DENSE_SCHUR", precond="JACOBI", **kw):
    problem, cams, pts = tbal.build_bal_problem(bal)
    s = stt.solve(stt.SolverOptions(linear_solver_type=LinearSolverType[solver],
                                    preconditioner_type=PreconditionerType[precond],
                                    device="cpu", **kw), problem)
    return s, cams.values.copy(), pts.values.copy()


def _assert_rows_equal(ts, js):
    assert len(ts.iterations) == len(js.iterations)
    for a, b in zip(ts.iterations, js.iterations):
        assert a.iteration == b.iteration
        assert a.step_is_successful == b.step_is_successful
        assert a.step_is_valid == b.step_is_valid
        assert a.linear_solver_iterations == b.linear_solver_iterations
        np.testing.assert_allclose(a.cost, b.cost, rtol=RTOL)
        np.testing.assert_allclose(a.trust_region_radius, b.trust_region_radius, rtol=RTOL)
        np.testing.assert_allclose(a.step_norm, b.step_norm, rtol=1e-8, atol=1e-14)


@pytest.mark.parametrize("scene", [(5, 40, 3), (16, 500, 4)])
def test_device_loop_matches_jax_device_loop(scene):
    """Chunks of 8, at most 25 iterations; both converge inside the budget."""
    bal = jbal.synthetic_bal(*scene)
    kw = dict(max_num_iterations=25, use_device_loop=True, device_loop_chunk_iterations=8)
    js, jc, jp = _solve_jax(bal, **kw)
    ts, tc, tp = _solve_port(bal, **kw)
    assert ts.termination_type.value == js.termination_type.value == "CONVERGENCE"
    assert ts.message == js.message
    _assert_rows_equal(ts, js)
    assert (ts.num_successful_steps, ts.num_unsuccessful_steps) == (
        js.num_successful_steps, js.num_unsuccessful_steps)
    np.testing.assert_allclose(ts.final_cost, js.final_cost, rtol=RTOL)
    np.testing.assert_allclose(tc, jc, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=1e-12)


def test_device_loop_matches_host_loop():
    """The same accept/reject decisions and final parameters as the port's
    host loop (tests/test_device_loop.py:30 for the JAX package)."""
    bal = jbal.synthetic_bal(16, 500, 4)
    kw = dict(max_num_iterations=25, device_loop_chunk_iterations=8)
    host, hc, hp = _solve_port(bal, **kw)
    dev, dc, dp = _solve_port(bal, use_device_loop=True, **kw)
    assert dev.termination_type == host.termination_type
    assert [it.step_is_successful for it in dev.iterations] == [
        it.step_is_successful for it in host.iterations]
    np.testing.assert_allclose(dev.initial_cost, host.initial_cost, rtol=1e-14)
    np.testing.assert_allclose(dev.final_cost, host.final_cost, rtol=1e-10)
    np.testing.assert_allclose(dc, hc, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(dp, hp, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("chunk", [30, 8])
def test_full_iteration_budget_runs_exactly_n_steps(chunk):
    """run_full_iteration_budget: exactly 30 steps, also when 30 is not a
    multiple of the chunk (8, 8, 8, 6); the converged cost is reached."""
    bal = jbal.synthetic_bal(5, 40, 3)
    s, _, _ = _solve_port(bal, max_num_iterations=30, use_device_loop=True,
                          device_loop_chunk_iterations=chunk, run_full_iteration_budget=True)
    assert s.num_successful_steps + s.num_unsuccessful_steps == 30
    assert s.num_linear_solves == 30 and len(s.iterations) == 31
    assert s.termination_type.value == "NO_CONVERGENCE"
    assert s.final_cost < 1e-3 * s.initial_cost


def test_zeroed_ptol_does_not_trigger_on_zero_step():
    """parameter_tolerance == 0 disables the test (tests/test_device_loop.py:82)."""
    bal = jbal.synthetic_bal(5, 40, 3)
    s, _, _ = _solve_port(bal, max_num_iterations=40, use_device_loop=True,
                          device_loop_chunk_iterations=40, function_tolerance=0.0,
                          gradient_tolerance=0.0, parameter_tolerance=0.0)
    assert "Parameter tolerance" not in s.message


def test_explicit_path_device_loop_matches_jax(monkeypatch):
    """synthetic_bal(120, 2000, 4), 6 steps in chunks of 3 at initial radius
    1: the port with its dense-W gate at 0 takes the explicit S and K2's
    plain panels at 1080 rows; the JAX package's device loop takes dense W."""
    monkeypatch.setattr(schur_mod, "DENSE_W_LIMIT_BYTES", 0)
    bal = jbal.synthetic_bal(120, 2000, 4)
    kw = dict(max_num_iterations=6, use_device_loop=True, device_loop_chunk_iterations=3,
              run_full_iteration_budget=True, initial_trust_region_radius=1.0)
    js, jc, jp = _solve_jax(bal, **kw)
    ts, tc, tp = _solve_port(bal, **kw)
    assert ts.schur_complement_path == "explicit"
    assert ts.num_successful_steps > 0
    assert ts.message == js.message
    _assert_rows_equal(ts, js)
    np.testing.assert_allclose(tc, jc, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(tp, jp, rtol=1e-8, atol=1e-12)


# -- the other linear solvers under the device loop --------------------------------


@pytest.mark.parametrize(
    "solver,precond,kw,rtol",
    [
        ("ITERATIVE_SCHUR", "SCHUR_JACOBI", {}, 1e-8),
        ("ITERATIVE_SCHUR", "POWER_SERIES_EXPANSION", {}, 1e-8),
        ("ITERATIVE_SCHUR", "CLUSTER_TRIDIAGONAL", dict(cluster_jacobi_size=4), 1e-8),
        ("ITERATIVE_SCHUR", "SCHUR_JACOBI", dict(use_explicit_schur_complement=True), 1e-8),
        # CGNR iterates on the normal equations of the whole problem, whose
        # condition number amplifies each of its tens of PCG steps' rounding
        ("CGNR", "JACOBI", {}, 1e-5),
        ("DENSE_NORMAL_CHOLESKY", "JACOBI", {}, 1e-8),
        ("DENSE_QR", "JACOBI", {}, 1e-8),
        # the seminormal step on the unscaled Jacobian (columns 1e4 apart)
        ("DENSE_QR", "JACOBI", dict(jacobi_scaling=False), 1e-8),
    ],
)
def test_device_loop_of_each_solver_matches_jax_device_loop(solver, precond, kw, rtol):
    """9 steps in chunks of 3 at initial radius 1 (every accept/reject
    decision is made on a cost change far above rounding), the full budget:
    the rows of the port's device loop against the JAX device loop's
    (tests/test_device_loop.py:42 runs CGNR there), PCG counts included,
    and against the port's host loop. Costs at ``rtol``, parameters at
    100 ``rtol``: the iterative solvers' PCG iterates carry each step's
    rounding. CGNR is held to the JAX device loop up to the step where its
    residual test stops one PCG step apart (``_held_steps``), at least its
    first 6, and to the port's host loop at every step;
    ``test_cgnr_device_loop_on_autodiff_matches_jax_device_loop`` holds
    every step on the JAX package's arithmetic."""
    _assert_device_loop_matches(solver, precond, kw, rtol, knife_edge=solver == "CGNR")


def test_cgnr_device_loop_on_autodiff_matches_jax_device_loop(monkeypatch):
    """The CGNR case of the test above with the Snavely batch on the port's
    vmapped autodiff (its batched form taken away), the JAX package's
    arithmetic: every step held to the JAX device loop."""
    monkeypatch.delattr(snavely_reprojection_error, "analytic")
    _assert_device_loop_matches("CGNR", "JACOBI", {}, 1e-5)


def _held_steps(ts, js, knife_edge: bool) -> int:
    """The rows held to the JAX package's: every row, or on CGNR's
    ``knife_edge`` those before the first step whose PCG count differs (the
    residual test's last-bit edge under the closed-form Jacobian, as in
    tests/test_torch_solve.py:_held_steps)."""
    n = len(ts.iterations)
    if not knife_edge:
        return n
    return next((k for k, (a, b) in enumerate(zip(ts.iterations, js.iterations))
                 if a.linear_solver_iterations != b.linear_solver_iterations), n)


def _assert_device_loop_matches(solver, precond, kw, rtol, knife_edge=False):
    # the dense solvers factor the whole problem's Jacobian: a smaller scene
    dense = solver in ("DENSE_QR", "DENSE_NORMAL_CHOLESKY")
    bal = jbal.synthetic_bal(6, 60, 4) if dense else jbal.synthetic_bal(16, 500, 4)
    kw = dict(max_num_iterations=9, device_loop_chunk_iterations=3,
              run_full_iteration_budget=True, initial_trust_region_radius=1.0, **kw)
    js, jc, jp = _solve_jax(bal, solver, precond, use_device_loop=True, **kw)
    ts, tc, tp = _solve_port(bal, solver, precond, use_device_loop=True, **kw)
    hs, hc, hp = _solve_port(bal, solver, precond, **kw)
    assert ts.linear_solver_type_used.value == js.linear_solver_type_used.value == solver
    assert ts.schur_complement_path == js.schur_complement_path
    assert len(ts.iterations) == len(js.iterations) == len(hs.iterations) == 10
    assert ts.num_successful_steps > 0
    held = _held_steps(ts, js, knife_edge)
    assert held >= 7
    for k, (a, b, h) in enumerate(zip(ts.iterations, js.iterations, hs.iterations)):
        assert a.step_is_successful == b.step_is_successful == h.step_is_successful
        assert a.linear_solver_iterations == h.linear_solver_iterations
        np.testing.assert_allclose(a.cost, h.cost, rtol=rtol)
        if k < held:
            assert a.linear_solver_iterations == b.linear_solver_iterations
            np.testing.assert_allclose(a.cost, b.cost, rtol=rtol)
            np.testing.assert_allclose(a.trust_region_radius, b.trust_region_radius, rtol=rtol)
    np.testing.assert_allclose(tc, hc, rtol=100 * rtol, atol=1e-9)
    if held < len(ts.iterations):  # the residual test's edge: one PCG step apart
        a, b = ts.iterations[held], js.iterations[held]
        assert abs(a.linear_solver_iterations - b.linear_solver_iterations) == 1
        return
    np.testing.assert_allclose(tc, jc, rtol=100 * rtol, atol=1e-9)
    np.testing.assert_allclose(tp, jp, rtol=100 * rtol, atol=1e-9)


@pytest.mark.parametrize("mu", [1e-8, 1e-3, 1.0, 1e3])
@pytest.mark.parametrize("scaled", [True, False])
def test_seminormal_dense_qr_step_matches_qr(mu, scaled):
    """The device loop's DENSE_QR step (the corrected seminormal equations,
    which a CUDA graph captures) against ``solve_dense_qr`` (Householder QR
    by ``torch.linalg.qr``) on the same damped system: 1e-10 relative in
    the step, from nearly undamped to heavily damped, on the Jacobi-scaled
    and on the raw Jacobian."""
    from skeres_tpu_torch.core.linear_solvers import solve_dense_qr, solve_dense_qr_seminormal

    program = tbal.build_bal_problem(tbal.synthetic_bal(6, 60, 4))[0].compile()
    ev = Evaluator(program, "cpu", torch.float64)
    _, blocks = ev.blocks(program.initial_state("cpu", torch.float64))
    _, diag = ev.gradient_and_diag(blocks)
    jd, rd = ev.jacobian_dense(blocks)
    if scaled:
        scale = 1.0 / (1.0 + torch.sqrt(diag))
        jd, diag = jd * scale, diag * scale * scale
    ref, _ = solve_dense_qr(jd, rd, diag, mu, 1e-6, 1e32)
    step, iters = solve_dense_qr_seminormal(jd, rd, diag, mu, 1e-6, 1e32)
    assert int(iters) == 1
    np.testing.assert_allclose(step.numpy(), ref.numpy(), rtol=0,
                               atol=1e-10 * float(torch.linalg.norm(ref)))


# -- while_loop, the cond form of the damped solve and the sync-free PCG ---------------------


def _early_stopping_pcg(matvec, b, precond, max_iterations, rtol, min_iterations=0):
    """The host form: a Python loop that reads its stopping test."""
    tol2 = rtol * rtol * float(b @ b)
    x, r = torch.zeros_like(b), b.clone()
    z = precond(r)
    p, rz, i = z, float(r @ z), 0
    while i < max_iterations:
        rnorm2 = float(r @ r)
        if not ((rnorm2 > tol2 or i < min_iterations) and rnorm2 > 0.0):
            break
        ap = matvec(p)
        pap = float(p @ ap)
        alpha = rz / pap if pap > 0.0 else 0.0
        x, r = x + alpha * p, r - alpha * ap
        z = precond(r)
        rz_new = float(r @ z)
        p = z + (rz_new / (rz if rz > 0.0 else 1.0)) * p
        rz, i = rz_new, i + 1
    return x, i


@pytest.mark.parametrize("rtol,max_it,min_it", [(1e-6, 32, 0), (1e-30, 12, 0), (0.5, 32, 5)])
def test_sync_free_pcg_gives_the_early_stopping_iterate(rtol, max_it, min_it):
    """Stopping early on the residual test, running out of iterations, and
    held to min_iterations: the same iterate and count as the host form
    and as the JAX package's while_loop."""
    rng = np.random.default_rng(4)
    m = rng.standard_normal((60, 60)) / 8.0
    a = m @ m.T + 0.5 * np.eye(60)  # condition number ~8: 18 steps to 1e-6
    b = rng.standard_normal(60)
    d = np.diag(a).copy()
    at, bt, dt = (torch.tensor(v) for v in (a, b, d))
    x, it = preconditioned_conjugate_gradients(lambda v: at @ v, bt, lambda v: v / dt,
                                               max_it, rtol, min_it)
    x_host, it_host = _early_stopping_pcg(lambda v: at @ v, bt, lambda v: v / dt,
                                          max_it, rtol, min_it)
    x_jax, it_jax = jax_pcg(lambda v: a @ v, b, lambda v: v / d, max_it, rtol, min_it)
    assert it.dtype == torch.int64 and int(it) == it_host == int(it_jax)
    assert 0 < it_host <= max_it
    np.testing.assert_array_equal(x.numpy(), x_host.numpy())
    np.testing.assert_allclose(x.numpy(), np.asarray(x_jax), rtol=1e-10, atol=1e-12)


def test_while_loop_runs_as_the_python_loop_it_replaces():
    """Eagerly: the body runs for as long as the device bool holds, the
    carry updated in place; a false start runs nothing."""
    k = torch.zeros((), dtype=torch.int64)
    acc = torch.zeros(3, dtype=torch.float64)

    def body():
        acc.add_(k.to(acc.dtype) + 1.0)
        k.add_(1)

    assert while_loop(lambda: (k < 5) & (acc.sum() < 100.0), body) is None
    ref, j = np.zeros(3), 0
    while j < 5 and ref.sum() < 100.0:
        ref += j + 1.0
        j += 1
    assert int(k) == j == 5
    np.testing.assert_array_equal(acc.numpy(), ref)
    while_loop(lambda: acc.sum() < 0.0, lambda: acc.fill_(-1.0))
    np.testing.assert_array_equal(acc.numpy(), ref)
    # the data, not a bound, ends it
    while_loop(lambda: acc.sum() < 100.0, body)
    assert int(k) == 8


def test_cond_runs_the_branch_its_predicate_picks():
    out = torch.zeros(2)
    for flag in (True, False):
        # eagerly it returns what it read
        assert cond(torch.tensor(flag), lambda: out[0].add_(1.0), lambda: out[1].add_(1.0)) is flag
    assert cond(torch.tensor(False), lambda: out.fill_(9.0)) is False
    assert out.tolist() == [1.0, 1.0]


def _scaled_setup():
    bal = tbal.synthetic_bal(6, 60, 4)
    ev = Evaluator(tbal.build_bal_problem(bal)[0].compile(), device="cpu")
    _, blocks = ev.blocks(ev.program.initial_state("cpu", torch.float64))
    g, diag = ev.gradient_and_diag(blocks)
    schur = SchurSolver(ev)
    scale = 1.0 / (1.0 + torch.sqrt(diag))
    data = schur.prepare(schur.scale_data(schur.solver_data(blocks), scale))
    return schur, data, g * scale, diag * scale * scale


@pytest.mark.parametrize(
    "threshold,jitter0,want_iters,want_jitter",
    [
        (5e-4, 0.0, 2, 1e-3),  # the plain factor fails, the first rung holds
        (5e-2, 0.0, 3, 0.1),  # the second rung holds
        (0.5, 0.0, 32, 0.1),  # every rung fails: the PCG fallback
        (5e-4, 1e-3, 1, 1e-3),  # the ratchet starts at the rung that held
    ],
)
def test_cond_ladder_with_device_scalars_walks_the_host_rungs(threshold, jitter0, want_iters,
                                                              want_jitter):
    """A forced factor failure (NaN below a jitter threshold): the damped
    solve called as the device loop calls it (mu and jitter0 device
    scalars) walks the rungs the host loop's call (Python floats) walks,
    and the all-rungs failure gives the same PCG iterate."""
    schur, data, g, diag = _scaled_setup()
    orig = schur._factor_solve

    def failing(s, rhs, delta):
        x, solve = orig(s, rhs, delta)
        bad = torch.min(torch.diagonal(s) + delta) - 1.0 < threshold
        return torch.where(bad, torch.nan, x), solve

    schur._factor_solve = failing
    host = schur.solve_damped(data, g, diag, 1e-4, 1e-6, 1e32, jitter0=jitter0)
    dev = schur.solve_damped(data, g, diag, torch.tensor(1e-4, dtype=torch.float64), 1e-6,
                             1e32, jitter0=torch.tensor(jitter0, dtype=torch.float64))
    for dx, iters, jitter in (host, dev):
        assert iters.dtype == torch.int64 and int(iters) == want_iters
        np.testing.assert_allclose(float(jitter), want_jitter, rtol=1e-12)
        assert torch.isfinite(dx).all()
    np.testing.assert_allclose(dev[0].numpy(), host[0].numpy(), rtol=1e-12, atol=1e-15)
