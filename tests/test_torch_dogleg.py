"""The port's dogleg strategies (traditional and subspace, host loop)
against the JAX package's on the same problems, float64 on the CPU: the
Powell and Rosenbrock cases of ``tests/test_solver_e2e.py`` with
per-iteration costs to rtol 1e-10, a small BAL on the dense-W and the
explicit S path to rtol 1e-8, and the device loop refusing dogleg in
both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.core.types import DoglegType as JDoglegType
from skeres_tpu.core.types import LinearSolverType as JLinearSolverType
from skeres_tpu.core.types import TrustRegionStrategyType as JStrategy
from skeres_tpu.io import bal as jbal
from skeres_tpu_torch.core import schur as schur_mod
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.types import DoglegType, LinearSolverType, TrustRegionStrategyType
from skeres_tpu_torch.io import bal as tbal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _options(pkg, dogleg, **kw):
    """SolverOptions of package ``pkg`` ("jax" or "torch") with the dogleg
    strategy of type ``dogleg`` and ``kw`` (enum values by name)."""
    if pkg == "jax":
        cls, solver, strat, dtype = JOptions, JLinearSolverType, JStrategy, JDoglegType
        extra = {}
    else:
        cls, solver, strat, dtype = SolverOptions, LinearSolverType, TrustRegionStrategyType, \
            DoglegType
        extra = dict(device="cpu")
    if "linear_solver_type" in kw:
        kw["linear_solver_type"] = solver[kw["linear_solver_type"]]
    return cls(trust_region_strategy_type=strat.DOGLEG, dogleg_type=dtype[dogleg], **kw, **extra)


def _powell(pkg):
    problem = (st if pkg == "jax" else stt).Problem()
    x = [problem.add_parameter_block([v]) for v in (3.0, -1.0, 0.0, 1.0)]
    sqrt5, sqrt10 = np.sqrt(5.0), np.sqrt(10.0)
    problem.add_residual_block(lambda p, d: p[0] + 10.0 * p[1], None, [x[0], x[1]])
    problem.add_residual_block(lambda p, d: sqrt5 * (p[0] - p[1]), None, [x[2], x[3]])
    problem.add_residual_block(lambda p, d: (p[0] - 2.0 * p[1]) ** 2, None, [x[1], x[2]])
    problem.add_residual_block(lambda p, d: sqrt10 * (p[0] - p[1]) ** 2, None, [x[0], x[3]])
    return problem, dict(linear_solver_type="DENSE_NORMAL_CHOLESKY", max_num_iterations=100)


def _rosenbrock(pkg):
    xp = jnp if pkg == "jax" else torch
    problem = (st if pkg == "jax" else stt).Problem()
    xy = problem.add_parameter_block([-1.2, 1.0])
    problem.add_residual_block(
        lambda p, d: xp.stack([10.0 * (p[0][1] - p[0][0] ** 2), 1.0 - p[0][0]]), None, [xy])
    return problem, dict(max_num_iterations=200)


@pytest.mark.parametrize("scene", ["powell", "rosenbrock"])
@pytest.mark.parametrize("dogleg", ["TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"])
def test_small_problems_match_jax(scene, dogleg):
    """The e2e dogleg cases converge in both packages through the same
    iterations: costs to rtol 1e-10 (with an absolute floor of 1e-24 for
    Powell's last costs, which sit at the rounding of its residuals)."""
    build = {"powell": _powell, "rosenbrock": _rosenbrock}[scene]
    runs = {}
    for pkg in ("jax", "torch"):
        problem, kw = build(pkg)
        runs[pkg] = ((st if pkg == "jax" else stt).solve(_options(pkg, dogleg, **kw), problem),
                     problem)
    (js, _), (ts, tprob) = runs["jax"], runs["torch"]
    assert ts.termination_type.value == js.termination_type.value == "CONVERGENCE", ts.message
    assert len(ts.iterations) == len(js.iterations)
    for a, b in zip(ts.iterations, js.iterations):
        assert (a.step_is_valid, a.step_is_successful) == (b.step_is_valid, b.step_is_successful)
        assert a.linear_solver_iterations == b.linear_solver_iterations == (1 if a.iteration else 0)
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-10, atol=1e-24)
        np.testing.assert_allclose(a.trust_region_radius, b.trust_region_radius, rtol=1e-10)
    assert ts.final_cost < 1e-10
    if scene == "rosenbrock":
        np.testing.assert_allclose(tprob._groups[0].values[0], [1.0, 1.0], atol=1e-6)
    assert len(ts.dogleg_gauss_newton_iterations) == ts.num_successful_steps + 1


@pytest.fixture(scope="module")
def bal16():
    return jbal.synthetic_bal(16, 500, 4)


@pytest.mark.parametrize("path", ["dense-W", "explicit"])
@pytest.mark.parametrize("dogleg", ["TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"])
def test_bal_matches_jax(bal16, monkeypatch, path, dogleg):
    """synthetic_bal(16, 500, 4), DENSE_SCHUR, 8 dogleg steps at initial
    radius 1, the full budget: the same decisions, costs and radii to rtol
    1e-8. The port takes the explicit S with its dense-W gate at 0; the JAX
    package takes dense W (the same S). The Gauss-Newton solve of a gauge-free
    BA problem fails its plain factor and takes a jitter rung: two
    iterations a linearization."""
    if path == "explicit":
        monkeypatch.setattr(schur_mod, "DENSE_W_LIMIT_BYTES", 0)
    kw = dict(linear_solver_type="DENSE_SCHUR", max_num_iterations=8,
              run_full_iteration_budget=True, initial_trust_region_radius=1.0)
    jprob, jc, jp = jbal.build_bal_problem(bal16)
    js = st.solve(_options("jax", dogleg, **dict(kw)), jprob)
    tprob, tc, tp = tbal.build_bal_problem(bal16)
    ts = stt.solve(_options("torch", dogleg, **dict(kw)), tprob)
    assert ts.schur_complement_path == path
    assert len(ts.iterations) == len(js.iterations) == 9
    assert ts.num_successful_steps > 0
    for a, b in zip(ts.iterations, js.iterations):
        assert (a.step_is_valid, a.step_is_successful) == (b.step_is_valid, b.step_is_successful)
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-8)
        np.testing.assert_allclose(a.trust_region_radius, b.trust_region_radius, rtol=1e-8)
    np.testing.assert_allclose(tc.values, jc.values, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tp.values, jp.values, rtol=1e-6, atol=1e-9)
    assert ts.trust_region_strategy_type == TrustRegionStrategyType.DOGLEG
    assert len(ts.dogleg_gauss_newton_iterations) == ts.num_successful_steps + 1
    assert 0 <= ts.num_dogleg_cauchy_steps <= 8


@pytest.mark.parametrize("dogleg", ["TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"])
def test_device_loop_refuses_dogleg_like_jax(dogleg):
    kw = dict(linear_solver_type="DENSE_SCHUR", use_device_loop=True, max_num_iterations=2)
    bal = jbal.synthetic_bal(4, 24, 3)
    with pytest.raises(NotImplementedError, match="LEVENBERG_MARQUARDT only"):
        st.solve(_options("jax", dogleg, **dict(kw)), jbal.build_bal_problem(bal)[0])
    with pytest.raises(NotImplementedError, match="LEVENBERG_MARQUARDT only"):
        stt.solve(_options("torch", dogleg, **dict(kw)), tbal.build_bal_problem(bal)[0])
