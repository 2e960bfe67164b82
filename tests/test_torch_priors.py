"""The port's prior and conditioning residuals against the JAX package's,
float64 on the CPU: ``normal_prior`` (a fixed A and mu, and per-block A and
mu through ``data``) and ``conditioned_residual``, as values and in a
solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skeres_tpu as st
import skeres_tpu_torch as stt
from skeres_tpu.core.options import SolverOptions as JOptions
from skeres_tpu.models import priors as jpriors
from skeres_tpu_torch.core.options import SolverOptions
from skeres_tpu_torch.models import priors as tpriors


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_RNG = np.random.default_rng(4)
_A = _RNG.normal(size=(4, 3))
_MU = _RNG.normal(size=3)
_X = _RNG.normal(size=3)


def test_normal_prior_matches_jax():
    t = tpriors.normal_prior(_A, _MU)((torch.as_tensor(_X),), None)
    j = jpriors.normal_prior(_A, _MU)((jnp.asarray(_X),), None)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-14)
    data = {"a": _A, "mu": _MU}
    t = tpriors.normal_prior(np.eye(3), np.zeros(3))(
        (torch.as_tensor(_X),), {k: torch.as_tensor(v) for k, v in data.items()})
    np.testing.assert_allclose(t.numpy(), _A @ (_X - _MU), rtol=1e-14)
    assert tpriors.normal_prior(_A, _MU).__name__ == "normal_prior"


def test_conditioned_residual_matches_jax():
    conds = [lambda r: 2.0 * r, lambda r: r ** 3, lambda r: r - 1.0, lambda r: 0.5 * r]
    t = tpriors.conditioned_residual(tpriors.normal_prior(_A, _MU), conds)(
        (torch.as_tensor(_X),), None)
    j = jpriors.conditioned_residual(jpriors.normal_prior(_A, _MU), conds)(
        (jnp.asarray(_X),), None)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-14)


def test_batched_priors_solve_as_in_jax():
    """Three blocks pulled by per-block priors (A, mu through ``data``) and
    coupled by a conditioned difference: the same costs and solution."""
    rng = np.random.default_rng(8)
    a = rng.normal(size=(3, 3, 3)) + 3.0 * np.eye(3)
    mu = rng.normal(size=(3, 3))
    out = []
    for mod, pr, Options, kw in ((st, jpriors, JOptions, {}),
                                 (stt, tpriors, SolverOptions, dict(device="cpu"))):
        problem = mod.Problem()
        arr = problem.add_parameter_block_array(np.zeros((3, 3)))
        problem.add_residual_blocks(pr.normal_prior(np.eye(3), np.zeros(3)), None, [arr],
                                    data={"a": a, "mu": mu})
        diff = pr.conditioned_residual(lambda p, d: p[0] - p[1],
                                       [lambda r: r, lambda r: 2.0 * r, lambda r: r ** 3])
        problem.add_residual_blocks(diff, None, [(arr, np.array([0, 1])), (arr, np.array([1, 2]))])
        s = mod.solve(Options(max_num_iterations=20, **kw), problem)
        out.append(([it.cost for it in s.iterations], np.asarray(arr.values)))
    (jc, jv), (tc, tv) = out
    assert len(tc) == len(jc)
    np.testing.assert_allclose(tc, jc, rtol=1e-8)
    np.testing.assert_allclose(tv, jv, rtol=1e-8, atol=1e-12)
