"""The port's More-Garbow-Hillstrom registry against the JAX package's,
float64 on the CPU: every residual and its Jacobian at the standard start,
and every case solved by both packages with the options of
``tests/test_mgh.py`` (DENSE_QR, nonmonotonic steps, tolerances 1e-16):
the port certifies exactly where the JAX package does, and the final
costs agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.core.types import LinearSolverType as JLinearSolverType
from skeres_tpu.models.mgh import PROBLEMS as JPROBLEMS
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.core.types import LinearSolverType
from skeres_tpu_torch.models.mgh import PROBLEMS

NUMS = sorted(PROBLEMS)
IDS = [PROBLEMS[n].name for n in NUMS]

# cases that end on max_num_iterations in both packages, short of the
# minimum: their final costs are where the last of the same number of
# steps left each, and agree to the registry's certification tolerance
# (brown_dennis: 85822.30 and 85822.52 after 400 steps, F* = 85822.2)
UNCONVERGED = {16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_registry_matches_jax():
    assert sorted(JPROBLEMS) == NUMS
    for n in NUMS:
        t, j = PROBLEMS[n], JPROBLEMS[n]
        assert (t.name, t.m, tuple(t.fstars), t.zero_atol, t.rtol, t.atol, t.max_iterations,
                t.x_atol) == (j.name, j.m, tuple(j.fstars), j.zero_atol, j.rtol, j.atol,
                              j.max_iterations, j.x_atol)
        np.testing.assert_array_equal(t.x0, np.asarray(j.x0))


@pytest.mark.parametrize("num", NUMS, ids=IDS)
def test_residual_at_start_matches_jax(num):
    """The residual at the standard start to 1e-12 of itself (entries
    that are zero up to rounding, as Chebyquad's odd moments, to 1e-12 of
    the vector's largest), and its Jacobian to rtol 1e-10 (the tables are
    made by numpy here and by XLA there)."""
    x0 = np.asarray(PROBLEMS[num].x0, dtype=np.float64)
    tr = PROBLEMS[num].residual(torch.as_tensor(x0))
    jr = JPROBLEMS[num].residual(jnp.asarray(x0))
    assert tr.shape == (PROBLEMS[num].m,) and tr.dtype == torch.float64
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(jr)).max())
    tj = torch.func.jacfwd(PROBLEMS[num].residual)(torch.as_tensor(x0)).numpy()
    jj = np.asarray(jax.jacfwd(JPROBLEMS[num].residual)(jnp.asarray(x0)))
    np.testing.assert_allclose(tj, jj, rtol=1e-10, atol=1e-12 * max(1.0, np.abs(jj).max()))


def _solve(pkg, prob):
    problem = (st if pkg == "jax" else stt).Problem()
    x = problem.add_parameter_block(np.asarray(prob.x0, dtype=np.float64))
    problem.add_residual_block(lambda params, data: prob.residual(params[0]), None, [x])
    kw = dict(max_num_iterations=prob.max_iterations, use_nonmonotonic_steps=True,
              function_tolerance=1e-16, gradient_tolerance=1e-16, parameter_tolerance=1e-16)
    if pkg == "jax":
        s = st.solve(JOptions(linear_solver_type=JLinearSolverType.DENSE_QR, **kw), problem)
    else:
        s = stt.solve(SolverOptions(linear_solver_type=LinearSolverType.DENSE_QR, device="cpu",
                                    **kw), problem)
    return 2.0 * s.final_cost, np.asarray(x.value)


@pytest.mark.parametrize("num", NUMS, ids=IDS)
def test_certifies_as_jax(num):
    """Both packages reach a certified minimum from the standard start, or
    neither; where both do, the same one: F to rtol 1e-6 (NIST's own
    tolerance), or both below the zero minimum's threshold; and x at the
    registry's tolerance where it names the minimizer."""
    prob = PROBLEMS[num]
    jf, jx = _solve("jax", JPROBLEMS[num])
    tf, tx = _solve("torch", prob)
    assert prob.certified(tf) == JPROBLEMS[num].certified(jf), (tf, jf)
    if not prob.certified(tf):
        return
    if 0.0 in prob.fstars and jf <= prob.zero_atol:
        assert tf <= prob.zero_atol, (tf, jf)
    elif num in UNCONVERGED:
        np.testing.assert_allclose(tf, jf, rtol=prob.rtol)
    else:
        np.testing.assert_allclose(tf, jf, rtol=1e-6)
    if prob.expected_x is not None and (0.0 not in prob.fstars or tf <= prob.zero_atol):
        np.testing.assert_allclose(tx, prob.expected_x, atol=prob.x_atol)
