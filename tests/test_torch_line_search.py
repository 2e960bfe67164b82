"""The port's line-search minimizer and GradientProblem against the JAX
package's, float64 on the CPU: the step searches on the same scalar
functions, every direction type with both step searches on curve
fitting, Powell and a small BAL (the same iterations, evaluations and
decisions, costs to rtol 1e-8), the restart path, ``use_device_loop``
ignored as in the JAX package, and ``GradientProblem`` on Rosenbrock and
on the sphere manifold."""

import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core import line_search as jls
from skeres_tpu.core.gradient_problem import GradientProblem as JGradientProblem
from skeres_tpu.core.gradient_problem import solve_gradient_problem as jsolve_gp
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.io import bal as jbal
from skeres_tpu_torch.core import line_search as tls
from skeres_tpu_torch.core.gradient_problem import GradientProblem, solve_gradient_problem
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.types import MinimizerType
from skeres_tpu_torch.io import bal as tbal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _by_name(options_cls, kw):
    """``kw`` with each enum given by its name as ``options_cls``'s own."""
    defaults = options_cls()
    return {k: type(getattr(defaults, k))[v] if isinstance(getattr(defaults, k), enum.Enum)
            else v for k, v in kw.items()}


# -- the step searches on scalar functions -----------------------------------------


@pytest.mark.parametrize("args", [
    (0.0, 1.0, -2.0, 1.0, 0.5),
    (0.0, 1.0, -2.0, 1.0, 3.0),
    (0.2, 0.3, -0.1, 1.5, 0.25),
    (1.0, 2.0, 0.5, 0.0, 4.0),
    (0.0, 1.0, -1.0, 0.0, 1.0),
    (0.0, 1.0, -1.0, 2.0, -1.0),
])
def test_interpolate_step_matches_jax(args):
    assert tls._interpolate_step(*args) == jls._interpolate_step(*args)


# phi(s) along a descent direction, with its derivative: a quartic, a
# steep exponential (many backtracks), and a function whose minimum lies
# far out (the bracketing phase expands)
_PHIS = {
    "quartic": (lambda s: (s - 0.7) ** 4 + 0.3 * (s - 0.7) ** 2,
                lambda s: 4.0 * (s - 0.7) ** 3 + 0.6 * (s - 0.7)),
    "steep": (lambda s: np.exp(4.0 * s) - 8.0 * s, lambda s: 4.0 * np.exp(4.0 * s) - 8.0),
    "far": (lambda s: (s - 40.0) ** 2 / 100.0, lambda s: (s - 40.0) / 50.0),
}


@pytest.mark.parametrize("name", sorted(_PHIS))
@pytest.mark.parametrize("initial_step", [1.0, 0.05, 3.0])
def test_step_searches_match_jax(name, initial_step):
    phi, dphi = _PHIS[name]
    f0, g0 = phi(0.0), dphi(0.0)
    for mod in (jls, tls):
        calls = []

        def counted(s, calls=calls):
            calls.append(s)
            return float(phi(s)), float(dphi(s))

        mod.calls = calls
        mod.armijo_out = mod.armijo_line_search(
            lambda s: counted(s)[0], f0, g0, initial_step, 1e-4, 20, 1e-9)
        mod.wolfe_out = mod.wolfe_line_search(counted, f0, g0, initial_step, 1e-4, 0.9, 20, 1e-9)
    assert tls.armijo_out == jls.armijo_out
    assert tls.wolfe_out == jls.wolfe_out
    assert tls.calls == jls.calls
    assert tls.wolfe_out[0] is not None


# -- the minimizer through solve() -----------------------------------------------------


def _curve(pkg):
    xp = jnp if pkg == "jax" else torch
    rng = np.random.default_rng(1234)
    x = np.linspace(0.0, 5.0, 67)
    y = np.exp(0.3 * x + 0.1) + rng.normal(0.0, 0.2, size=x.shape)
    problem = (st if pkg == "jax" else stt).Problem()
    mc = problem.add_parameter_block([0.0, 0.0])
    problem.add_residual_blocks(
        lambda p, d: d[1:2] - xp.exp(p[0][0] * d[0] + p[0][1]), None,
        [(mc.array, np.zeros(len(x), dtype=np.int32))], data=np.stack([x, y], axis=1))
    return problem


def _powell(pkg):
    problem = (st if pkg == "jax" else stt).Problem()
    x = [problem.add_parameter_block([v]) for v in (3.0, -1.0, 0.0, 1.0)]
    sqrt5, sqrt10 = np.sqrt(5.0), np.sqrt(10.0)
    problem.add_residual_block(lambda p, d: p[0] + 10.0 * p[1], None, [x[0], x[1]])
    problem.add_residual_block(lambda p, d: sqrt5 * (p[0] - p[1]), None, [x[2], x[3]])
    problem.add_residual_block(lambda p, d: (p[0] - 2.0 * p[1]) ** 2, None, [x[1], x[2]])
    problem.add_residual_block(lambda p, d: sqrt10 * (p[0] - p[1]) ** 2, None, [x[0], x[3]])
    return problem


_BAL = jbal.synthetic_bal(4, 24, 3)


def _bal(pkg):
    return (jbal if pkg == "jax" else tbal).build_bal_problem(_BAL)[0]


# (problem maker, iterations): Powell's costs fall towards the rounding of its
# residuals, so its run stops well above it
_SCENES = {"curve": (_curve, 100), "powell": (_powell, 30), "bal": (_bal, 30)}


def _solve_both(scene, **kw):
    build, iters = _SCENES[scene]
    kw = {**dict(minimizer_type="LINE_SEARCH", max_num_iterations=iters), **kw}
    js = st.solve(JOptions(**_by_name(JOptions, kw)), build("jax"))
    ts = stt.solve(SolverOptions(device="cpu", **_by_name(SolverOptions, kw)), build("torch"))
    return js, ts


def _assert_same_run(js, ts, rtol=1e-8, atol=0.0):
    assert ts.termination_type.value == js.termination_type.value, ts.message
    assert ts.message == js.message
    assert len(ts.iterations) == len(js.iterations)
    for a, b in zip(ts.iterations, js.iterations):
        assert a.step_is_successful == b.step_is_successful
        assert a.line_search_function_evaluations == b.line_search_function_evaluations
        np.testing.assert_allclose(a.cost, b.cost, rtol=rtol, atol=atol)
    assert ts.num_jacobian_evaluations == js.num_jacobian_evaluations
    np.testing.assert_allclose(ts.final_cost, js.final_cost, rtol=rtol, atol=atol)


@pytest.mark.parametrize("line_search", ["WOLFE", "ARMIJO"])
@pytest.mark.parametrize("direction", ["STEEPEST_DESCENT", "NONLINEAR_CONJUGATE_GRADIENT",
                                       "LBFGS", "BFGS"])
@pytest.mark.parametrize("scene", sorted(_SCENES))
def test_solve_matches_jax(scene, direction, line_search):
    js, ts = _solve_both(scene, line_search_direction_type=direction,
                         line_search_type=line_search)
    _assert_same_run(js, ts)
    assert ts.final_cost < ts.initial_cost
    assert ts.minimizer_type.value == "LINE_SEARCH"


@pytest.mark.parametrize("restarts", [0, 5])
def test_direction_restarts_match_jax(restarts):
    """Nonlinear CG with Armijo steps (no curvature condition) turns up
    ascent directions on the small BAL: each restarts from steepest
    descent, and past ``max_num_line_search_direction_restarts`` the solve
    fails, at the same iteration in both packages."""
    js, ts = _solve_both("bal", line_search_direction_type="NONLINEAR_CONJUGATE_GRADIENT",
                         line_search_type="ARMIJO",
                         max_num_line_search_direction_restarts=restarts)
    _assert_same_run(js, ts)
    assert ts.termination_type.value == "FAILURE"
    assert "max_num_line_search_direction_restarts" in ts.message


def test_device_loop_option_is_ignored_as_in_jax():
    """The line-search minimizer is routed before the device-loop branch,
    so ``use_device_loop`` changes nothing (JAX package: the same)."""
    js, ts = _solve_both("curve", use_device_loop=True)
    _, plain = _solve_both("curve")
    _assert_same_run(js, ts)
    assert [it.cost for it in ts.iterations] == [it.cost for it in plain.iterations]


def test_callbacks_and_solution_write_back():
    seen = []
    problem = _curve("torch")
    s = stt.solve(SolverOptions(device="cpu", minimizer_type=MinimizerType.LINE_SEARCH,
                                max_num_iterations=100,
                                callbacks=[lambda it: seen.append(it.iteration)]), problem)
    assert seen == list(range(1, len(s.iterations)))
    m, c = problem._groups[0].values[0]
    assert abs(m - 0.3) < 0.1 and abs(c - 0.1) < 0.2


# -- GradientProblem ----------------------------------------------------------------


def _gp_both(f_jax, f_torch, n, x0, manifold=None, rtol=1e-8, atol=0.0, **kw):
    jm = tm = None
    if manifold is not None:
        jm, tm = getattr(st, manifold)(n), getattr(stt, manifold)(n)
    jx, js = jsolve_gp(JOptions(**_by_name(JOptions, kw)), JGradientProblem(f_jax, n, jm), x0)
    tx, ts = solve_gradient_problem(SolverOptions(device="cpu", **_by_name(SolverOptions, kw)),
                                    GradientProblem(f_torch, n, tm), x0)
    _assert_same_run(js, ts, rtol, atol)
    np.testing.assert_allclose(tx, jx, rtol=rtol, atol=1e-12)
    return tx, ts


@pytest.mark.parametrize("direction", ["LBFGS", "BFGS"])
def test_gradient_problem_rosenbrock_matches_jax(direction):
    """Reference: examples/rosenbrock.cc; the LBFGS case of
    tests/test_covariance_gradient.py reaches (1, 1). The same decisions
    and step-search evaluations at every iteration; the costs to rtol 1e-6
    (absolute 1e-12 once they near zero): the two autodiffs' gradients
    differ in the last bits, and the curved valley magnifies that through
    the quasi-Newton updates to ~1e-7 by the thirtieth iteration."""

    def rosenbrock(x):
        return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2

    x, s = _gp_both(rosenbrock, rosenbrock, 2, np.array([-1.2, 1.0]),
                    line_search_direction_type=direction, max_num_iterations=300,
                    rtol=1e-6, atol=1e-12)
    assert s.termination_type.value == "CONVERGENCE", s.message
    np.testing.assert_allclose(x, [1.0, 1.0], atol=1e-5)
    assert stt.GradientProblemSolver.solve is not None


def test_gradient_problem_on_the_sphere_matches_jax():
    """A linear function on the unit sphere: the optimum is the negative
    coefficient direction (tests/test_covariance_gradient.py); the search
    runs in the tangent space through SphereManifold.plus."""
    c = np.array([1.0, 2.0, 2.0]) / 3.0
    x, s = _gp_both(lambda x: -jnp.dot(jnp.asarray(c), x),
                    lambda x: -torch.dot(torch.as_tensor(c, dtype=x.dtype), x), 3,
                    np.array([1.0, 0.0, 0.0]), manifold="SphereManifold", max_num_iterations=200)
    np.testing.assert_allclose(np.linalg.norm(x), 1.0, atol=1e-8)
    np.testing.assert_allclose(x, c / np.linalg.norm(c), atol=1e-5)


def test_gradient_problem_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_gradient_problem(SolverOptions(), GradientProblem(lambda x: x @ x, 2), [1.0, 2.0])
