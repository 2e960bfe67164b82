"""The port's plain linear solvers (``core/linear_solvers.py``) and the
evaluator's dense products against the JAX package's, on the same numpy
inputs: PCG with the Q test, DENSE_NORMAL_CHOLESKY with refinement,
DENSE_QR, CGNR with JACOBI and SUBSET, and one damped solve of each through
both minimizers' ``_solve_damped`` on a scene without an elimination
group. float64 on the CPU; steps at rtol 1e-9 (they pass through a
factorization or a PCG run of equal length), products at rtol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core import linear_solvers as jls
from skeres_tpu.core.evaluator import Evaluator as JEvaluator
from skeres_tpu.core.minimizer import TrustRegionMinimizer as JMinimizer
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.core.summary import Summary as JSummary
from skeres_tpu.core.types import LinearSolverType as JL
from skeres_tpu.core.types import PreconditionerType as JP
from skeres_tpu.io import bal as jbal
from skeres_tpu_torch.core import linear_solvers as tls
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.minimizer import TrustRegionMinimizer
from skeres_tpu_torch.core.summary import Summary
from skeres_tpu_torch.core.types import LinearSolverType as L
from skeres_tpu_torch.core.types import PreconditionerType as P
from skeres_tpu_torch.io import bal as tbal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers run side by side on a few cores: one thread each for
    the small problems here, or the workers' thread pools fight over the
    cores (a DENSE_QR case took minutes that way)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spd(n=60, seed=4):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)) / 8.0
    a = m @ m.T + 0.5 * np.eye(n)  # condition number ~8
    return a, rng.standard_normal(n), np.diag(a).copy()


def _pcg_both(q_tolerance, max_it, rtol=0.0, min_it=0):
    a, b, d = _spd()
    at, bt, dt = (torch.tensor(v) for v in (a, b, d))
    x, it = tls.preconditioned_conjugate_gradients(
        lambda v: at @ v, bt, lambda v: v / dt, max_it, rtol, min_it, q_tolerance=q_tolerance)
    xj, itj = jls.preconditioned_conjugate_gradients(
        lambda v: a @ v, jnp.asarray(b), lambda v: v / d, max_it, rtol, min_it,
        q_tolerance=None if q_tolerance is None else jnp.asarray(q_tolerance))
    return (x.numpy(), int(it)), (np.asarray(xj), int(itj))


@pytest.mark.parametrize("q_tolerance", [0.5, 0.1, 1e-3, 1e-8])
def test_pcg_q_test_stops_where_the_jax_loop_stops(q_tolerance):
    """The Nash-Sofer test on a fixed SPD system: the same count, short of
    the step limit and growing as the tolerance falls, and the same
    iterate."""
    (x, it), (xj, itj) = _pcg_both(q_tolerance, 200)
    assert it == itj and 0 < it < 60
    np.testing.assert_allclose(x, xj, rtol=1e-10, atol=1e-13)
    if q_tolerance < 0.5:
        assert it > _pcg_both(0.5, 200)[0][1]


def test_pcg_zero_q_tolerance_runs_to_max_iterations():
    """``q_tolerance = 0`` disables the Q test: with ``rtol = 0`` the loop
    runs every step it was given, 80 here, well past convergence (~45
    steps), where Q is no longer monotonic in floating point and a
    negative zeta would stop an unguarded test."""
    (x, it), (xj, itj) = _pcg_both(0.0, 80)
    assert it == itj == 80
    np.testing.assert_allclose(x, xj, rtol=1e-9, atol=1e-12)
    a, b, _ = _spd()
    np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-9, atol=1e-12)


def test_pcg_residual_test_still_stops_with_the_q_test_on():
    """With both tests on, the first to fire stops the loop: a loose rtol
    beats a tight Q tolerance, and ``min_iterations`` holds the residual
    test back."""
    (x, it), (xj, itj) = _pcg_both(1e-12, 200, rtol=1e-2)
    assert it == itj < _pcg_both(1e-12, 200, rtol=1e-8)[0][1]
    (_, it5), (_, itj5) = _pcg_both(None, 200, rtol=0.9, min_it=5)
    assert it5 == itj5 == 5


def test_pcg_zero_right_hand_side_takes_no_step():
    z = torch.zeros(5, dtype=torch.float64)
    x, it = tls.preconditioned_conjugate_gradients(lambda v: v, z, lambda v: v, 10, 0.0,
                                                   q_tolerance=0.1)
    assert int(it) == 0 and not x.any()


def _normal_system(n=40, m=90, seed=11):
    rng = np.random.default_rng(seed)
    j = rng.standard_normal((m, n))
    r = rng.standard_normal(m)
    return j, r, j.T @ j, j.T @ r, np.sum(j * j, axis=0)


@pytest.mark.parametrize("refine", [0, 2])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dense_normal_cholesky_matches_jax(refine, dtype):
    """float32: the factor in float32 and the residuals in float64; the two
    packages' float32 factors differ in their last bits, so 1e-5."""
    j, r, jtj, g, diag = _normal_system()
    tdt, rtol = (torch.float64, 1e-9) if dtype == "float64" else (torch.float32, 1e-5)
    step, it = tls.solve_dense_normal_cholesky(
        torch.tensor(jtj, dtype=tdt), torch.tensor(g, dtype=tdt), torch.tensor(diag, dtype=tdt),
        1e-2, 1e-6, 1e32, refinement_iterations=refine)
    jstep, jit_ = jls.solve_dense_normal_cholesky(
        jnp.asarray(jtj, dtype), jnp.asarray(g, dtype), jnp.asarray(diag, dtype), 1e-2, 1e-6,
        1e32, refinement_iterations=refine)
    assert int(it) == int(jit_) == 1 and step.dtype == tdt
    np.testing.assert_allclose(step.double().numpy(), np.asarray(jstep, np.float64), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(jstep)).max())
    if dtype == "float32" and refine:
        exact = np.linalg.solve(jtj + np.diag(np.clip(diag, 1e-6, 1e32) * 1e-2), -g)
        plain, _ = tls.solve_dense_normal_cholesky(
            torch.tensor(jtj, dtype=tdt), torch.tensor(g, dtype=tdt),
            torch.tensor(diag, dtype=tdt), 1e-2, 1e-6, 1e32)
        assert (np.abs(step.double().numpy() - exact).max()
                < np.abs(plain.double().numpy() - exact).max())


def test_failed_cholesky_gives_a_non_finite_step():
    """``cholesky_ex`` returns garbage and an info; the step must be NaN, as
    the JAX package's NaN-filled factor makes it."""
    jtj = -np.eye(4)
    g, diag = np.ones(4), np.ones(4)
    step, _ = tls.solve_dense_normal_cholesky(*(torch.tensor(v) for v in (jtj, g, diag)),
                                              1e-6, 1e-6, 1e32)
    jstep, _ = jls.solve_dense_normal_cholesky(jnp.asarray(jtj), jnp.asarray(g),
                                               jnp.asarray(diag), 1e-6, 1e-6, 1e32)
    assert not torch.isfinite(step).any() and not np.isfinite(np.asarray(jstep)).any()
    batch = torch.stack([torch.eye(3, dtype=torch.float64), -torch.eye(3, dtype=torch.float64)])
    l = tls.cholesky_nan(batch)
    assert torch.equal(l[0], torch.eye(3, dtype=torch.float64)) and torch.isnan(l[1]).all()


def test_dense_qr_matches_jax_and_the_normal_equations():
    j, r, jtj, g, diag = _normal_system()
    step, it = tls.solve_dense_qr(torch.tensor(j), torch.tensor(r), torch.tensor(diag), 1e-2,
                                  1e-6, 1e32)
    jstep, _ = jls.solve_dense_qr(jnp.asarray(j), jnp.asarray(r), jnp.asarray(diag), 1e-2, 1e-6,
                                  1e32)
    assert int(it) == 1
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), rtol=1e-9, atol=1e-12)
    exact = np.linalg.solve(jtj + np.diag(diag * 1e-2), -g)
    np.testing.assert_allclose(step.numpy(), exact, rtol=1e-9, atol=1e-12)


def test_solve_cgnr_matches_jax():
    j, r, jtj, g, diag = _normal_system()
    jt = torch.tensor(j)
    x, it = tls.solve_cgnr(lambda v: jt.T @ (jt @ v), torch.tensor(g), torch.tensor(diag), 1e-2,
                           1e-6, 1e32, 100, 1e-6)
    xj, itj = jls.solve_cgnr(lambda v: j.T @ (j @ v), jnp.asarray(g), jnp.asarray(diag), 1e-2,
                             1e-6, 1e32, 100, 1e-6)
    assert int(it) == int(itj) and 1 < int(it) < 100
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-12)


# -- the evaluator's dense products and the minimizers' damped solves -----------


class _NoSchurScene:
    """synthetic_bal(6, 60, 4) without a declared elimination group,
    linearized in both packages."""

    def __init__(self):
        bal = jbal.synthetic_bal(6, 60, 4)
        self.jprob = jbal.build_bal_problem(bal, use_schur_ordering=False)[0]
        self.tprob = tbal.build_bal_problem(bal, use_schur_ordering=False)[0]
        self.jev = JEvaluator(self.jprob.compile())
        _, self.jblocks = jax.jit(self.jev.blocks)(self.jev.program.initial_state(self.jev.dtype))
        self.jg, self.jdiag = jax.jit(self.jev.gradient_and_diag)(self.jblocks)
        self.tev = Evaluator(self.tprob.compile(), device="cpu")
        _, self.tblocks = self.tev.blocks(self.tev.program.initial_state("cpu", torch.float64))
        self.tg, self.tdiag = self.tev.gradient_and_diag(self.tblocks)


@pytest.fixture(scope="module")
def noschur():
    return _NoSchurScene()


def test_evaluator_dense_products_match_jax(noschur):
    sc = noschur
    jtj = sc.tev.jtj_dense(sc.tblocks)
    np.testing.assert_allclose(jtj.numpy(), np.asarray(sc.jev.jtj_dense(sc.jblocks)), rtol=1e-12,
                               atol=1e-14 * float(jtj.abs().max()))
    jd, rd = sc.tev.jacobian_dense(sc.tblocks)
    jjd, jrd = sc.jev.jacobian_dense(sc.jblocks)
    n_rows = rd.numel()  # the JAX batches may carry zero pad rows at their ends
    np.testing.assert_allclose(jd.numpy(), np.asarray(jjd)[:n_rows], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(rd.numpy(), np.asarray(jrd)[:n_rows], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose((jd.T @ jd).numpy(), jtj.numpy(), rtol=1e-10,
                               atol=1e-12 * float(jtj.abs().max()))
    v = np.random.default_rng(2).standard_normal(sc.tev.num_tangent)
    mv = sc.tev.jtj_matvec(sc.tblocks, torch.tensor(v)).numpy()
    np.testing.assert_allclose(mv, np.asarray(sc.jev.jtj_matvec(sc.jblocks, jnp.asarray(v))),
                               rtol=1e-10, atol=1e-12 * np.abs(mv).max())
    np.testing.assert_allclose(mv, (jtj @ torch.tensor(v)).numpy(), rtol=1e-10,
                               atol=1e-12 * np.abs(mv).max())


def _minimizers(sc, solver, **kw):
    jm = JMinimizer(sc.jev, JOptions(linear_solver_type=JL[solver], **kw), JSummary(), JL[solver])
    tm = TrustRegionMinimizer(sc.tev, stt.SolverOptions(linear_solver_type=L[solver], device="cpu",
                                                        **kw), Summary(), L[solver])
    return jm, tm


@pytest.mark.parametrize(
    "solver,kw,radius",
    [
        ("DENSE_NORMAL_CHOLESKY", {}, 1e4),
        ("DENSE_NORMAL_CHOLESKY", dict(use_mixed_precision_solves=True,
                                       max_num_refinement_iterations=2), 1e4),
        ("DENSE_QR", {}, 1e4),
        ("CGNR", {}, 1e4),
        ("CGNR", dict(eta=1e-3, min_linear_solver_iterations=3), 1.0),
    ],
)
def test_one_damped_solve_of_each_plain_solver_matches_jax(noschur, solver, kw, radius):
    """Both minimizers' ``_solver_data``, ``_scale_data``, ``_solve_damped``
    and ``_model_quadratic`` from the same linearization. The long PCG run
    (eta = 1e-3) is made at radius 1, where the damped normal equations are
    well enough conditioned that its iterates, which carry every step's
    rounding, agree to 1e-9; at radius 1e4 they drift to 1e-6."""
    sc = noschur
    jm, tm = _minimizers(sc, solver, **kw)
    jscale = 1.0 / (1.0 + jnp.sqrt(sc.jdiag))
    tscale = 1.0 / (1.0 + torch.sqrt(sc.tdiag))
    jdata, tdata = jm._solver_data(sc.jblocks), tm._solver_data(sc.tblocks)
    jy, jit_, _ = jm._solve_damped(jm._scale_data(jdata, jscale), sc.jg * jscale,
                                   sc.jdiag * jscale**2, radius)
    jitter = torch.zeros((), dtype=torch.float64)
    ty, tit, tj = tm._solve_damped(tm._scale_data(tdata, tscale), sc.tg * tscale,
                                   sc.tdiag * tscale**2, radius, jitter)
    assert int(tit) == int(jit_) and tj is jitter
    if solver == "CGNR":
        assert int(tit) > 1
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(jy)).max())
    dx, jdx = ty * tscale, jy * jscale
    np.testing.assert_allclose(float(tm._model_quadratic(tdata, dx, tscale)),
                               float(jm._model_quadratic(jdata, jdx, jscale)), rtol=1e-9)
    u = np.random.default_rng(6).standard_normal(sc.tev.num_tangent)
    np.testing.assert_allclose(tm._jtj_scaled(tdata, torch.tensor(u), tscale).numpy(),
                               np.asarray(jm._jtj_scaled(jdata, jnp.asarray(u), jscale)),
                               rtol=1e-9, atol=1e-12)


# -- CGNR's SUBSET preconditioner ------------------------------------------------


def _chain(pkg, n=24, seed=0):
    """The anchored odometry chain of tests/test_subset_preconditioner.py
    in either package: the prior and the chain are tagged for the subset,
    three long-range closures are not."""
    rng = np.random.default_rng(seed)
    truth = np.cumsum(rng.normal(size=(n, 2)), axis=0)
    problem = pkg.Problem()
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
        problem.add_residual_block(odo, None, [blocks[i], blocks[j]], data=truth[j] - truth[i])
    return problem, blocks, ids


def _solve_chain(precond, n=24, **kw):
    out = []
    for pkg, opts, lt, pt in ((st, JOptions, JL, JP), (stt, stt.SolverOptions, L, P)):
        problem, blocks, ids = _chain(pkg, n)
        extra = dict(device="cpu") if pkg is stt else {}
        s = pkg.solve(opts(
            linear_solver_type=lt.CGNR, preconditioner_type=pt[precond],
            residual_blocks_for_subset_preconditioner=ids if precond == "SUBSET" else None,
            max_num_iterations=50, **extra, **kw), problem)
        out.append((s, np.stack([np.asarray(b.value) for b in blocks])))
    return out


def test_per_block_problem_compiles_like_jax():
    jprog = _chain(st)[0].compile()
    tprog = _chain(stt)[0].compile()
    assert len(tprog.batches) == len(jprog.batches) == 2
    for tb, jb in zip(tprog.batches, jprog.batches):
        assert tb.row_ids == jb.row_ids and tb.slot_groups == jb.slot_groups
        np.testing.assert_array_equal(tb.tangent_index, jb.tangent_index)
        np.testing.assert_array_equal(tb.data, jb.data)
    assert tprog.batches[1].row_ids == tuple(range(1, 27))


@pytest.mark.parametrize("precond", ["JACOBI", "SUBSET"])
def test_cgnr_trajectory_on_the_chain_matches_jax(precond):
    """The whole solve: per-iteration PCG counts equal, costs at rtol 1e-8,
    the same convergence; SUBSET spends under half of JACOBI's PCG steps
    (tests/test_subset_preconditioner.py:71)."""
    (js, jx), (ts, tx) = _solve_chain(precond)
    assert ts.termination_type.value == js.termination_type.value == "CONVERGENCE"
    assert ts.preconditioner_type_used.value == js.preconditioner_type_used.value == precond
    assert [it.linear_solver_iterations for it in ts.iterations] == [
        it.linear_solver_iterations for it in js.iterations]
    np.testing.assert_allclose([it.cost for it in ts.iterations],
                               [it.cost for it in js.iterations], rtol=1e-8, atol=1e-18)
    np.testing.assert_allclose(tx, jx, rtol=1e-8, atol=1e-10)
    if precond == "SUBSET":
        total = sum(it.linear_solver_iterations for it in ts.iterations)
        jac = sum(it.linear_solver_iterations for it in _solve_chain("JACOBI")[1][0].iterations)
        assert total < 0.5 * jac


def test_subset_downgrades_like_jax(caplog):
    """Too many parameters for the dense factor, or no tagged row that
    resolves: JACOBI, logged and in the Summary; SUBSET without tagged
    blocks is invalid."""
    (js, _), (ts, _) = _solve_chain("SUBSET", n=8, subset_preconditioner_max_parameters=3)
    assert ts.preconditioner_type_used.value == js.preconditioner_type_used.value == "JACOBI"
    assert ts.termination_type.value == "CONVERGENCE"
    assert any("downgraded to JACOBI" in r.message for r in caplog.records
               if r.name == "skeres_tpu_torch")
    problem, _, _ = _chain(stt, 8)
    foreign = [stt.core.problem.ResidualBlockId(10_000)]
    s = stt.solve(stt.SolverOptions(linear_solver_type=L.CGNR, preconditioner_type=P.SUBSET,
                                    residual_blocks_for_subset_preconditioner=foreign,
                                    device="cpu"), problem)
    assert s.preconditioner_type_used == P.JACOBI
    s = stt.solve(stt.SolverOptions(linear_solver_type=L.CGNR, preconditioner_type=P.SUBSET,
                                    device="cpu"), _chain(stt, 8)[0])
    assert s.termination_type.value == "FAILURE"
    assert "residual_blocks_for_subset_preconditioner" in s.message
