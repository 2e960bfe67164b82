"""The port's inner iterations against the JAX package's, float64 on the
CPU: one ``refine()`` on the same state to rtol 1e-12 (a fixed number of
sweeps, and the tolerance-stopped loop), solves with
``use_inner_iterations`` on the host loop and the device loop to rtol
1e-8, and the message of a solve with no independent group."""

import jax
import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core import minimizer as jminimizer
from skeres_tpu.core.evaluator import Evaluator as JEvaluator
from skeres_tpu.core.inner_iterations import InnerIterationRefiner as JRefiner
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.core.types import LinearSolverType as JLinearSolverType
from skeres_tpu.io import bal as jbal
from skeres_tpu.ops.loss import CauchyLoss as JCauchy
from skeres_tpu_torch.core import minimizer as tminimizer
from skeres_tpu_torch.core.evaluator import Evaluator
from skeres_tpu_torch.core.inner_iterations import InnerIterationRefiner
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.problem import state_from_numpy
from skeres_tpu_torch.core.types import LinearSolverType
from skeres_tpu_torch.io import bal as tbal
from skeres_tpu_torch.ops.loss import CauchyLoss


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def bal16():
    return jbal.synthetic_bal(16, 500, 4)


@pytest.mark.parametrize("sweeps,tol", [(1, 0.0), (3, 0.0), (5, 1e-3), (5, 1e-9)])
@pytest.mark.parametrize("constant", [False, True])
def test_refine_matches_jax(bal16, sweeps, tol, constant):
    """synthetic_bal(16, 500, 4) with a Cauchy loss, 0.3 added to every
    point: the refined points to rtol 1e-12. ``constant`` holds the first
    ten points constant (the refiner's free mask)."""
    jprob, _, jpts = jbal.build_bal_problem(bal16, loss=JCauchy(1.0))
    tprob, _, tpts = tbal.build_bal_problem(bal16, loss=CauchyLoss(1.0))
    if constant:
        for prob, pts in ((jprob, jpts), (tprob, tpts)):
            for i in range(10):
                prob.set_parameter_block_constant(pts[i])
    jprog, tprog = jprob.compile(), tprob.compile()
    jev = JEvaluator(jprog)
    state = [g.values + (0.3 if g.schur_group == 0 else 0.0) for g in jprog.groups]
    jout = jax.jit(JRefiner(jev, num_sweeps=sweeps, tolerance=tol).refine)(
        tuple(jax.numpy.asarray(v) for v in state))
    ev = Evaluator(tprog, device="cpu")
    tout = InnerIterationRefiner(ev, num_sweeps=sweeps, tolerance=tol).refine(
        state_from_numpy(tprog, state, "cpu", torch.float64))
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    pts = tprog.groups.index(next(g for g in tprog.groups if g.schur_group == 0))
    assert not np.allclose(tout[pts].numpy(), state[pts])
    if constant:
        np.testing.assert_array_equal(tout[pts].numpy()[:10], state[pts][:10])


def _solve_both(bal, device_loop, **kw):
    base = dict(max_num_iterations=6, run_full_iteration_budget=True,
                initial_trust_region_radius=1.0, use_inner_iterations=True, **kw)
    if device_loop:
        # chunks of 3: the JAX device loop runs whole chunks (6 = 2 x 3)
        base.update(use_device_loop=True, device_loop_chunk_iterations=3)
    jprob, jc, jp = jbal.build_bal_problem(bal)
    js = st.solve(JOptions(linear_solver_type=JLinearSolverType.DENSE_SCHUR, **base), jprob)
    tprob, tc, tp = tbal.build_bal_problem(bal)
    ts = stt.solve(SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR, device="cpu",
                                 **base), tprob)
    return (js, jc.values, jp.values), (ts, tc.values, tp.values)


@pytest.mark.parametrize("device_loop", [False, True], ids=["host loop", "device loop"])
def test_solve_with_inner_iterations_matches_jax(bal16, device_loop):
    """6 steps at initial radius 1, the full budget: the same decisions,
    costs to rtol 1e-8, the same final parameters to rtol 1e-6; inner
    iterations lower the first step's cost below the plain LM step's."""
    (js, jc, jp), (ts, tc, tp) = _solve_both(bal16, device_loop)
    assert len(ts.iterations) == len(js.iterations) == 7
    for a, b in zip(ts.iterations, js.iterations):
        assert a.step_is_successful == b.step_is_successful
        np.testing.assert_allclose(a.cost, b.cost, rtol=1e-8)
    np.testing.assert_allclose(ts.final_cost, js.final_cost, rtol=1e-8)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=1e-9)
    assert ts.num_inner_iteration_steps == js.num_inner_iteration_steps
    plain, _, _ = tbal.build_bal_problem(bal16)
    p = stt.solve(SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR, device="cpu",
                                max_num_iterations=1, initial_trust_region_radius=1.0), plain)
    assert ts.iterations[1].cost < p.iterations[1].cost


def test_no_independent_group_message_matches_jax(monkeypatch):
    """DENSE_NORMAL_CHOLESKY on a problem with no declared elimination
    group: both packages set the same message and run no refiner (the
    minimizer is stubbed out, so that its own termination message does not
    overwrite it)."""
    bal = jbal.synthetic_bal(4, 24, 3)
    kw = dict(use_inner_iterations=True, max_num_iterations=3)
    seen = {}

    def stub(pkg):
        def minimize(self, state):
            seen[pkg] = self.inner_refiner
            return state
        return minimize

    monkeypatch.setattr(jminimizer.TrustRegionMinimizer, "minimize", stub("jax"))
    monkeypatch.setattr(tminimizer.TrustRegionMinimizer, "minimize", stub("torch"))
    js = st.solve(JOptions(linear_solver_type=JLinearSolverType.DENSE_NORMAL_CHOLESKY, **kw),
                  jbal.build_bal_problem(bal, use_schur_ordering=False)[0])
    ts = stt.solve(SolverOptions(linear_solver_type=LinearSolverType.DENSE_NORMAL_CHOLESKY,
                                 device="cpu", **kw),
                   tbal.build_bal_problem(bal, use_schur_ordering=False)[0])
    assert ts.message == js.message
    assert "use_inner_iterations ignored: no independent group" in ts.message
    assert seen == {"jax": None, "torch": None}
